"""Modulation mapping and max-log soft demapping, 36.211 7.1.

Capability parity with lib/src/phy/modem/ (lte_tables.c constellations,
mod.c modulator, demod_soft.c linearized max-log LLRs). Every LTE
constellation's I/Q is a (bi)linear function of its bits, so modulation
is elementwise arithmetic; the demapper uses the reference's piecewise-
linear max-log approximations. LLR convention: positive LLR <=> bit 0.
"""

from __future__ import annotations

import enum
import functools

import numpy as np
import torch


class Mod(enum.Enum):
    BPSK = 1
    QPSK = 2
    QAM16 = 4
    QAM64 = 6

    @property
    def bits_per_symbol(self) -> int:
        return self.value


@functools.lru_cache(maxsize=8)
def constellation(mod: Mod) -> np.ndarray:
    """Symbol table indexed by the bit group read MSB-first (36.211 7.1),
    complex64."""
    if mod is Mod.BPSK:
        # 36.211 Table 7.1.1-1: b=0 -> (1+j)/sqrt(2), b=1 -> -(1+j)/sqrt(2)
        a = 1 / np.sqrt(2)
        return np.array([a + 1j * a, -a - 1j * a], dtype=np.complex64)
    if mod is Mod.QPSK:
        a = 1 / np.sqrt(2)
        out = np.empty(4, dtype=np.complex64)
        for b in range(4):
            b0, b1 = (b >> 1) & 1, b & 1
            out[b] = a * (1 - 2 * b0) + 1j * a * (1 - 2 * b1)
        return out
    if mod is Mod.QAM16:
        # 36.211 Table 7.1.3-1: I from (b0, b2): 00->1, 01->3 (sign b0)
        s = 1 / np.sqrt(10)
        out = np.empty(16, dtype=np.complex64)
        for b in range(16):
            b0, b1, b2, b3 = (b >> 3) & 1, (b >> 2) & 1, (b >> 1) & 1, b & 1
            out[b] = s * ((1 - 2 * b0) * (1 + 2 * b2)
                          + 1j * (1 - 2 * b1) * (1 + 2 * b3))
        return out
    if mod is Mod.QAM64:
        # 36.211 Table 7.1.4-1: |I| from (b2, b4): 00->3, 01->1, 10->5, 11->7
        s = 1 / np.sqrt(42)
        amp = {(0, 0): 3, (0, 1): 1, (1, 0): 5, (1, 1): 7}
        out = np.empty(64, dtype=np.complex64)
        for b in range(64):
            bits = [(b >> (5 - i)) & 1 for i in range(6)]
            out[b] = s * ((1 - 2 * bits[0]) * amp[(bits[2], bits[4])]
                          + 1j * (1 - 2 * bits[1]) * amp[(bits[3], bits[5])])
        return out
    raise ValueError(mod)


def modulate(bits: torch.Tensor, mod: Mod) -> torch.Tensor:
    """bits [..., n*bps] 0/1 -> symbols [..., n] complex64
    (srslte_mod_modulate_bytes, mod.c:157)."""
    bps = mod.bits_per_symbol
    *lead, n = bits.shape
    assert n % bps == 0
    grp = bits.reshape(*lead, n // bps, bps).to(torch.float32)
    b = [grp[..., i] for i in range(bps)]
    sgn = lambda x: 1.0 - 2.0 * x
    if mod is Mod.BPSK:
        s = float(np.float32(1 / np.sqrt(2)))
        return torch.complex(sgn(b[0]) * s, sgn(b[0]) * s)
    if mod is Mod.QPSK:
        s = float(np.float32(1 / np.sqrt(2)))
        return torch.complex(sgn(b[0]) * s, sgn(b[1]) * s)
    if mod is Mod.QAM16:
        s = float(np.float32(1 / np.sqrt(10)))
        return torch.complex(sgn(b[0]) * (1.0 + 2.0 * b[2]) * s,
                             sgn(b[1]) * (1.0 + 2.0 * b[3]) * s)
    if mod is Mod.QAM64:
        # |amp|(b_h, b_l): 00->3, 01->1, 10->5, 11->7
        s = float(np.float32(1 / np.sqrt(42)))
        amp = lambda bh, bl: 3.0 + 2.0 * bh - 2.0 * bl + 4.0 * bh * bl
        return torch.complex(sgn(b[0]) * amp(b[2], b[4]) * s,
                             sgn(b[1]) * amp(b[3], b[5]) * s)
    raise ValueError(mod)


#: 8-bit LLR quantization gains per modulation: the reference's byte
#: demodulators (demod_soft.c:44-46 SCALE_BYTE_CONV_QPSK/QAM16/QAM64)
DEMOD_INT8_SCALE = {Mod.BPSK: 20.0, Mod.QPSK: 20.0,
                    Mod.QAM16: 30.0, Mod.QAM64: 40.0}


def quantize_llr_int8(llrs: torch.Tensor, mod: Mod) -> torch.Tensor:
    """float32 LLRs -> int8 with the reference's per-modulation byte scale
    and symmetric saturation at +-127 (demod_soft.c byte lane, rm_turbo.c
    8-bit combining). ``torch.round`` rounds half to even, as does
    ``jnp.round``: 0.05 * 30 = 1.5 -> 2."""
    s = float(np.float32(DEMOD_INT8_SCALE[mod]))
    return torch.clamp(torch.round(llrs * s), -127, 127).to(torch.int8)


def demod_planes(re, im, mod: Mod):
    """Max-log LLR bit-planes: list of ``bps`` tensors shaped like ``re``."""
    if mod is Mod.BPSK:
        return [(re + im) * float(np.float32(1 / np.sqrt(2)))]
    if mod is Mod.QPSK:
        return [re, im]
    if mod is Mod.QAM16:
        c = float(np.float32(2 / np.sqrt(10)))
        return [re, im, c - re.abs(), c - im.abs()]
    if mod is Mod.QAM64:
        c4 = float(np.float32(4 / np.sqrt(42)))
        c2 = float(np.float32(2 / np.sqrt(42)))
        return [re, im, c4 - re.abs(), c4 - im.abs(),
                c2 - (re.abs() - c4).abs(), c2 - (im.abs() - c4).abs()]
    raise ValueError(mod)


def demod_soft(symbols: torch.Tensor, mod: Mod) -> torch.Tensor:
    """Max-log soft demapping: [..., n] complex -> LLRs [..., n*bps]
    float32 (demod_soft.c). Positive LLR <=> bit 0."""
    planes = demod_planes(symbols.real, symbols.imag, mod)
    out = torch.stack(planes, dim=-1)
    return out.reshape(*symbols.shape[:-1],
                       symbols.shape[-1] * mod.bits_per_symbol)


def demod_hard(symbols: torch.Tensor, mod: Mod) -> torch.Tensor:
    """Hard decisions [..., n*bps] int8 from the signs of the max-log
    LLRs (hard_demod_lte.c)."""
    return (demod_soft(symbols, mod) < 0).to(torch.int8)
