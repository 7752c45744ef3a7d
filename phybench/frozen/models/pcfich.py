"""PCFICH: control format indicator channel (36.211 6.7, 36.212 5.3.4).

Capability parity with lib/src/phy/phch/pcfich.c: the 3 fixed 32-bit CFI
codewords, scrambling, QPSK, single-port, 2-port SFBC or 4-port
SFBC-FSTD transmit diversity, mapping to 4 quarter-spaced REGs of symbol
0; decoding by correlating the received soft bits against the codewords.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.equalizer import precode_sfbc, precode_sfbc_fstd
from ..ops.modem import Mod, modulate
from ..ops.scrambling import scramble_bits
from ..utils.cell import Cell
from ..utils.device import device_table
from ..utils.sequence import cinit_pcfich
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
    bits = torch.as_tensor(CFI_CODEWORDS[cfi - 1], device=dev)
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


