"""Modulation mapping and max-log soft demapping, 36.211 7.1.

Capability parity with lib/src/phy/modem/ (lte_tables.c constellations,
mod.c modulator, demod_soft.c linearized max-log LLRs). Every LTE
constellation's I/Q is a (bi)linear function of its bits, so modulation
is elementwise arithmetic; the demapper uses the reference's piecewise-
linear max-log approximations. LLR convention: positive LLR <=> bit 0.
"""

from __future__ import annotations

import enum

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


