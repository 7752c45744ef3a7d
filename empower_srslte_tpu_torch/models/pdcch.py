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
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.equalizer import eq_sfbc, precode_sfbc
from ..ops.fec.convcoder import conv_encode, viterbi_decode
from ..ops.fec.rm_conv import rm_conv_rx, rm_conv_tx
from ..ops.modem import Mod, demod_soft, modulate
from ..ops.scrambling import descramble_llrs
from ..utils.bits import uint_to_bits
from ..utils.cell import Cell
from ..utils.crc import CRC16
from ..utils.device import device_table
from ..utils.sequence import cinit_pdcch, gold_sequence
from .regs import RE_PER_CCE, pdcch_nof_cces, pdcch_reg_map

#: Bits per CCE (36 QPSK REs).
BITS_PER_CCE = 2 * RE_PER_CCE


@functools.lru_cache(maxsize=64)
def _region_re_indices(cell: Cell, cfi: int, ng: float = 1.0) -> np.ndarray:
    """Flat RE indices of the PDCCH region, quadruplet order, [n_regs*4]."""
    return pdcch_reg_map(cell, cfi, ng).reshape(-1).astype(np.int64)


def _region_idx(cell: Cell, cfi: int, ng: float, device):
    return device_table(("pdcch_re", cell, cfi, ng), device,
                        lambda: _region_re_indices(cell, cfi, ng))


def ue_search_candidates(rnti: int, sf_idx: int, n_cce: int):
    """(L, cce) candidates: common + UE-specific (36.213 9.1.1)."""
    out = []
    for l, m_max in ((4, 4), (8, 2)):
        for m in range(m_max):
            cce = m * l
            if cce + l <= n_cce:
                out.append((l, cce))
    y = rnti
    for _ in range(sf_idx + 1):
        y = (39827 * y) % 65537
    for l, m_max in ((1, 6), (2, 6), (4, 2), (8, 2)):
        if n_cce // l == 0:
            continue
        for m in range(m_max):
            cce = l * ((y + m) % (n_cce // l))
            if cce + l <= n_cce:
                out.append((l, cce))
    seen, uniq = set(), []
    for c in out:
        if c not in seen:
            seen.add(c)
            uniq.append(c)
    return uniq


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


def pdcch_extract_llr(grid, h, cell: Cell, cfi: int, sf_idx: int,
                      noise_est=0.0, ng: float = 1.0):
    """Equalize + demap + descramble the whole region once
    (srslte_pdcch_extract_llr_multi): -> llr [..., n_cce*72].

    ``h``: [..., nsymb, nre] single-port or [..., P, nsymb, nre]; a
    cell of 2 or more ports takes the SFBC branch on ports 0 and 1."""
    idx = _region_idx(cell, cfi, ng, grid.device)
    y = grid.reshape(*grid.shape[:-2], -1)[..., idx]
    if h.dim() == grid.dim() + 1 and h.shape[-3] >= 2:
        hf = h.reshape(*h.shape[:-2], -1)
        h0 = hf[..., 0, :][..., idx]
        h1 = hf[..., 1, :][..., idx]
        x, csi = eq_sfbc(y[..., None, :], h0[..., None, :], h1[..., None, :])
        llr = demod_soft(x, Mod.QPSK) * torch.repeat_interleave(csi, 2, -1)
    else:
        if h.dim() == grid.dim() + 1:
            h = h[..., 0, :, :]
        hh = h.reshape(*h.shape[:-2], -1)[..., idx]
        x = y * torch.conj(hh) / torch.clamp(hh.abs() ** 2 + noise_est,
                                             min=1e-12)
        llr = demod_soft(x, Mod.QPSK) \
            * torch.repeat_interleave(hh.abs() ** 2, 2, -1)
    return descramble_llrs(llr, cinit_pdcch(2 * sf_idx, cell.id))


def pdcch_blind_bits(llr, cands, size: int):
    """Decode EVERY (L, cce) candidate for one DCI size as ONE Viterbi
    batch: de-rate-matching maps each candidate's e = L*72 segment to the
    common [3, k] trellis shape (k = size + 16), so candidates of every
    aggregation level stack along one batch axis.

    llr [..., n_cce*72] -> bits [..., n_cand, k], in ``cands`` order.
    """
    k = size + 16
    by_l: dict[int, list[int]] = {}
    for l, cce in cands:
        by_l.setdefault(l, []).append(cce)
    parts, order = [], []
    for l, cces in by_l.items():
        e = l * BITS_PER_CCE
        seg = torch.stack(
            [llr[..., c * BITS_PER_CCE:c * BITS_PER_CCE + e] for c in cces],
            dim=-2)                                   # [..., nc_l, e]
        parts.append(rm_conv_rx(seg, k))              # [..., nc_l, 3, k]
        order.extend((l, c) for c in cces)
    bits = viterbi_decode(torch.cat(parts, dim=-3))   # [..., n_cand, k]
    perm = [order.index(c) for c in cands]
    if perm != list(range(len(cands))):
        bits = bits[..., torch.as_tensor(perm, device=bits.device), :]
    return bits


def dci_crc_ok(bits, size: int, rnti: int):
    """bits [..., size + 16] from pdcch_blind_bits -> bool [...]: CRC16
    with the RNTI mask removed checks."""
    mask = device_table(("rnti_mask", rnti), bits.device,
                        lambda: uint_to_bits(rnti & 0xFFFF, 16))
    unmasked = torch.cat([bits[..., :size],
                          torch.bitwise_xor(bits[..., size:], mask)], dim=-1)
    return CRC16.check(unmasked)


@dataclass
class DciHit:
    payload: np.ndarray
    l: int
    cce: int
    rnti: int


def pdcch_blind_decode(grid, h, cell: Cell, cfi: int, sf_idx: int,
                       rnti: int, dci_sizes: tuple[int, ...],
                       noise_est=0.0, ng: float = 1.0) -> list[DciHit]:
    """Blind search for one RNTI over its search space.

    grid [nsymb, nre], h [nsymb, nre] or [P, nsymb, nre] (one subframe,
    one rx antenna). Returns every CRC-passing candidate, payloads
    deduplicated across nested aggregations."""
    n_cce = pdcch_nof_cces(cell, cfi, ng)
    llr = pdcch_extract_llr(grid, h, cell, cfi, sf_idx, noise_est, ng)
    cands = ue_search_candidates(rnti, sf_idx, n_cce)
    hits: list[DciHit] = []
    for size in dci_sizes:
        bits = pdcch_blind_bits(llr, cands, size)
        ok = dci_crc_ok(bits, size, rnti).cpu().numpy()
        bits_np = bits.cpu().numpy()
        for row, (l, cce) in enumerate(cands):
            if ok[row]:
                hits.append(DciHit(bits_np[row, :size].astype(np.int8), l,
                                   cce, rnti))
    seen, uniq = set(), []
    for hit in hits:
        key = hit.payload.tobytes()
        if key not in seen:
            seen.add(key)
            uniq.append(hit)
    return uniq
