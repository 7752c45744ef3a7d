"""PCFICH: control format indicator channel (36.211 6.7, 36.212 5.3.4).

Capability parity with lib/src/phy/phch/pcfich.c: the 3 fixed 32-bit CFI
codewords, scrambling, QPSK, single-port, 2-port SFBC or 4-port
SFBC-FSTD transmit diversity, mapping to 4 quarter-spaced REGs of symbol
0; decoding by correlating the received soft bits against the codewords.

On the card ``pcfich_decode`` is one launch of ``csrc/pdcch_rx.cu``'s
first kernel (``models/pdcch.py ctrl_llr_cuda``), which
``ue_dl_tm4_batch`` runs together with the PDCCH's LLRs
(``pdcch.control_rx``); on the CPU it is the plain twin
``_pcfich_decode_plain``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.equalizer import (eq_sfbc, eq_sfbc_fstd, precode_sfbc,
                             precode_sfbc_fstd)
from ..ops.modem import Mod, demod_soft, modulate
from ..ops.scrambling import descramble_llrs, scramble_bits
from ..utils.cell import Cell
from ..utils.device import device_table
from ..utils.sequence import cinit_pcfich, gold_sequence
from .regs import pcfich_regs, symbol_regs

#: CFI codewords (36.212 Table 5.3.4-1): periodic 011/101/110 patterns.
CFI_CODEWORDS = np.array(
    [np.tile([0, 1, 1], 11)[:32], np.tile([1, 0, 1], 11)[:32],
     np.tile([1, 1, 0], 11)[:32]], dtype=np.int8)


@functools.lru_cache(maxsize=64)
def _re_indices(cell: Cell) -> np.ndarray:
    regs0 = symbol_regs(cell, 0)
    idx = []
    for r in pcfich_regs(cell):
        idx.extend(regs0[r])       # symbol 0 -> flat index = subcarrier
    return np.asarray(idx, np.int64)


def pcfich_put(grid, cfi: int, cell: Cell, sf_idx: int):
    """Insert the CFI codeword into grid [..., P, nsymb, nre] — single
    port, 2-port SFBC or 4-port SFBC-FSTD (srslte_pcfich_encode). Returns
    a new grid."""
    dev = grid.device
    bits = device_table(("cfi_codeword", cfi), dev,
                        lambda: CFI_CODEWORDS[cfi - 1])
    syms = modulate(scramble_bits(bits, cinit_pcfich(2 * sf_idx, cell.id)),
                    Mod.QPSK)
    if cell.nof_ports == 1:
        port_syms = syms[None]
    elif cell.nof_ports == 2:
        port_syms = precode_sfbc(torch.stack([syms[0::2], syms[1::2]]))
    else:
        port_syms = precode_sfbc_fstd(torch.stack([syms[i::4]
                                                   for i in range(4)]))
    idx = device_table(("pcfich_re", cell), dev, lambda: _re_indices(cell))
    out = grid.clone()
    flat = out.view(*grid.shape[:-2], -1)
    flat[..., :port_syms.shape[0], idx] = port_syms.to(grid.dtype)
    return out


def kernel_signs(cell: Cell, sf_idx: int) -> np.ndarray:
    """The signs ``csrc/pdcch_rx.cu`` reads for the PCFICH of
    (cell, sf_idx), float32 [128]: the 32 descrambling signs
    1 - 2 c(n) (``descramble_llrs``), then the 3 codewords' 1 - 2 b."""
    seq = gold_sequence(cinit_pcfich(2 * sf_idx, cell.id), 32)
    return np.concatenate([1.0 - 2.0 * seq,
                           (1.0 - 2.0 * CFI_CODEWORDS).reshape(-1)]
                          ).astype(np.float32)


def pcfich_decode(grid, h, cell: Cell, sf_idx: int, noise_est=0.0):
    """Decode CFI -> (cfi [...], corr [...]).

    grid [..., nsymb, nre]; h [..., nsymb, nre] (single port) or
    [..., P, nsymb, nre]: MRC / SFBC / SFBC-FSTD combining, then
    correlation against the 3 codewords (srslte_pcfich_decode). On the
    card one kernel launch (``pdcch.ctrl_llr_cuda``), on the CPU the
    plain twin."""
    if grid.is_cuda:
        from .pdcch import ctrl_llr_cuda

        cfi, corr, _ = ctrl_llr_cuda(grid, h, cell, sf_idx, noise_est)
        return cfi, corr
    return _pcfich_decode_plain(grid, h, cell, sf_idx, noise_est)


def _pcfich_decode_plain(grid, h, cell: Cell, sf_idx: int, noise_est=0.0):
    """``pcfich_decode`` in plain PyTorch (the kernel's twin)."""
    idx = device_table(("pcfich_re", cell), grid.device,
                       lambda: _re_indices(cell))
    y = grid[..., 0, :][..., idx]
    has_ports = h.dim() == grid.dim() + 1
    if not has_ports or h.shape[-3] == 1:
        hh = (h[..., 0, 0, :] if has_ports else h[..., 0, :])[..., idx]
        x = y * torch.conj(hh) / torch.clamp(hh.abs() ** 2 + noise_est,
                                             min=1e-12)
    else:
        hp = [h[..., p, 0, :][..., idx][..., None, :]
              for p in range(h.shape[-3])]
        eq = eq_sfbc if len(hp) == 2 else eq_sfbc_fstd
        x, _csi = eq(y[..., None, :], *hp)
    llr = descramble_llrs(demod_soft(x, Mod.QPSK),
                          cinit_pcfich(2 * sf_idx, cell.id))
    signs = device_table("cfi_signs", grid.device, lambda: (
        1.0 - 2.0 * CFI_CODEWORDS.astype(np.float32)))
    corr = torch.einsum("...k,ck->...c", llr, signs)
    cfi = torch.argmax(corr, dim=-1) + 1
    return cfi, corr.max(-1).values / llr.abs().sum(-1)
