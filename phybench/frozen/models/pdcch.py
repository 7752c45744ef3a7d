"""PDCCH: downlink control channel with blind decoding (36.211 6.8,
36.212 5.3.3, 36.213 9.1.1).

Capability parity with lib/src/phy/phch/pdcch.c: DCI CRC16-RNTI masking,
tail-biting convolutional coding, rate matching to the CCE aggregation,
control-region scrambling, REG mapping (models/regs.py), LLR extraction
of the whole region once (srslte_pdcch_extract_llr_multi) and the blind
search over candidate locations and formats (pdcch.c:341) — every
candidate of every aggregation level decodes in one Viterbi batch per
DCI size.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.equalizer import precode_sfbc
from ..ops.fec.convcoder import conv_encode
from ..ops.fec.rm_conv import rm_conv_tx
from ..ops.modem import Mod, modulate
from ..utils.bits import uint_to_bits
from ..utils.cell import Cell
from ..utils.crc import CRC16
from ..utils.device import device_table
from ..utils.sequence import cinit_pdcch, gold_sequence
from .regs import RE_PER_CCE, pdcch_reg_map

#: Bits per CCE (36 QPSK REs).
BITS_PER_CCE = 2 * RE_PER_CCE


@functools.lru_cache(maxsize=64)
def _region_re_indices(cell: Cell, cfi: int, ng: float = 1.0) -> np.ndarray:
    """Flat RE indices of the PDCCH region, quadruplet order, [n_regs*4]."""
    return pdcch_reg_map(cell, cfi, ng).reshape(-1).astype(np.int64)


def _region_idx(cell: Cell, cfi: int, ng: float, device):
    return device_table(("pdcch_re", cell, cfi, ng), device,
                        lambda: _region_re_indices(cell, cfi, ng))


def pdcch_encode(dci_bits, rnti: int, cce: int, l: int, cell: Cell,
                 cfi: int, sf_idx: int, ng: float = 1.0):
    """One DCI -> grid contribution [..., P, nsymb, nre]. The region
    scrambling sequence offset follows the CCE position so independent
    PDCCHs compose additively. A cell of 2 or more ports gets 2-port SFBC
    on ports 0 and 1 with ports 2 and 3 left empty, as the reference
    package transmits it (36.211 6.8.4 would use SFBC-FSTD on 4 ports)."""
    dev = dci_bits.device
    e = l * BITS_PER_CCE
    crc = CRC16.compute(dci_bits).to(torch.int8)
    mask = torch.as_tensor(uint_to_bits(rnti & 0xFFFF, 16), device=dev)
    payload = torch.cat([dci_bits.to(torch.int8),
                         torch.bitwise_xor(crc, mask)], dim=-1)
    coded = rm_conv_tx(conv_encode(payload), e)
    seq = gold_sequence(cinit_pdcch(2 * sf_idx, cell.id),
                        (cce + l) * BITS_PER_CCE)[cce * BITS_PER_CCE:]
    coded = torch.bitwise_xor(coded, torch.as_tensor(seq, device=dev))
    syms = modulate(coded, Mod.QPSK)

    idx = _region_idx(cell, cfi, ng, dev)[cce * RE_PER_CCE:(cce + l) * RE_PER_CCE]
    lead = syms.shape[:-1]
    if cell.nof_ports >= 2:
        ports = precode_sfbc(torch.stack([syms[..., 0::2], syms[..., 1::2]],
                                         dim=-2))
    else:
        ports = syms[..., None, :]
    grid = torch.zeros((*lead, cell.nof_ports, cell.nsymb_sf * cell.nof_re),
                       dtype=torch.complex64, device=dev)
    grid[..., :ports.shape[-2], idx] = ports
    return grid.reshape(*lead, cell.nof_ports, cell.nsymb_sf, cell.nof_re)


