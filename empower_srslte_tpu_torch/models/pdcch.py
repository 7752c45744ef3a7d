"""PDCCH: downlink control channel with blind decoding (36.211 6.8,
36.212 5.3.3, 36.213 9.1.1).

Capability parity with lib/src/phy/phch/pdcch.c: DCI CRC16-RNTI masking,
tail-biting convolutional coding, rate matching to the CCE aggregation,
control-region scrambling, REG mapping (models/regs.py), LLR extraction
of the whole region once (srslte_pdcch_extract_llr_multi) and the blind
search over candidate locations and formats (pdcch.c:341) — every
candidate of every aggregation level decodes in one Viterbi batch per
DCI size.

On the card the encoder is one launch of ``csrc/pdcch_tx.cu`` for every
DCI of a call (``pdcch_encode_many``, which ``pdcch_encode`` goes
through), with no read back to the host, and the control stages are two
launches of ``csrc/pdcch_rx.cu``:
``ctrl_llr_cuda`` (the PCFICH decode and the region's LLRs, which
``pcfich_decode`` and ``pdcch_extract_llr`` go through) and
``pdcch_blind_cuda`` (the rate de-matching, Viterbi decode and CRC16 of
every candidate and DCI size, which ``pdcch_blind_bits`` and
``pdcch_blind_decode`` go through); ``control_rx`` is the batched
receiver's entry to both. On the CPU each function runs its plain twin
(``_pdcch_encode_plain``, ``_pdcch_extract_llr_plain``,
``_pdcch_blind_bits_plain``). The tables the kernels read (candidates,
the sizes' de-rate-matching and CRC tables, the rate matching's circle,
RE indices and scrambling signs) are built once per plan; a transmit
call's RNTIs, CCEs and levels go to the card in one copy, and the
kernel reads them there.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.equalizer import combine_diversity, precode_diversity
from ..ops.fec.convcoder import TRAIN_LEN, conv_encode, viterbi_decode
from ..ops.fec.rm_conv import _circle, rm_conv_rx, rm_conv_tx
from ..ops.modem import Mod, demod_soft, modulate
from ..ops.scrambling import descramble_llrs
from ..runtime import trace
from ..runtime.graphs import EAGER
from ..utils.bits import uint_to_bits
from ..utils.cell import Cell
from ..utils.crc import CRC16
from ..utils.cuda_build import Kernel
from ..utils.device import MAX_SMEM, device_table, host_ints
from ..utils.sequence import cinit_pdcch, gold_sequence
from . import pcfich
from .regs import RE_PER_CCE, pdcch_nof_cces, pdcch_reg_map

#: Bits per CCE (36 QPSK REs).
BITS_PER_CCE = 2 * RE_PER_CCE
_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: kernel A's launcher: grid, its stride, h, its subframe and port
#: strides, ports, noise, its step, a noise value, the PCFICH's REs and
#: signs, cfi, corr, the region's REs and signs, their count, llr,
#: subframes. A launch's shape in the launch registry is (subframes,
#: ports, region REs)
CTRL_LLR = Kernel("pdcch_rx", "ctrl_llr_launch",
                  [_P, _I64, _P, _I64, _I64, _I32, _P, _I32, ctypes.c_float,
                   _P, _P, _P, _P, _P, _P, _I32, _P, _I32])
#: kernel B's launcher: llr, its stride, subframes, candidates, their
#: count, the sizes' table, K per size, sizes, the training length, bits,
#: ok, hits, warps, smem. A launch's shape in the launch registry is (DCI
#: sizes, candidates, subframes)
PDCCH_BLIND = Kernel("pdcch_rx", "pdcch_blind_launch",
                     [_P, _I64, _I32, _P, _I32, _P, _P, _I32, _I32, _P, _P,
                      _P, _I32, _I32])
#: the transmit kernel's launcher: grid, its row and port strides, ports,
#: rows, the region's REs and scrambling signs, their count, DCIs, then
#: per DCI (host arrays) its bits' pointer, their row stride, its size and
#: its circle table's pointer, and the card's [DCIs, 3] (rnti, cce, L). A
#: launch's shape in the launch registry is (DCIs, ports, the largest K)
PDCCH_TX = Kernel("pdcch_tx", "pdcch_tx_launch",
                  [_P, _I64, _I64, _I32, _I32, _P, _P, _I32, _I32, _P, _P,
                   _P, _P, _P])
#: the blind kernel's limits (csrc/pdcch_rx.cu): warps a block, DCI sizes
#: a launch, K = size + 16 (the transmit kernel's too)
MAX_BLIND_WARPS, MAX_SIZES, MAX_K = 32, 4, 128
#: DCIs a transmit launch takes (csrc/pdcch_tx.cu MAX_DCIS)
MAX_TX_DCIS = 8
#: ints of a size's header in the size table: K, halo, the offset of its
#: inverse circle (its syndromes follow), the RNTI mask's syndrome
SIZE_HDR = 4


@functools.lru_cache(maxsize=64)
def _region_re_indices(cell: Cell, cfi: int, ng: float = 1.0) -> np.ndarray:
    """Flat RE indices of the PDCCH region, quadruplet order, [n_regs*4]."""
    return pdcch_reg_map(cell, cfi, ng).reshape(-1).astype(np.int64)


def _region_idx(cell: Cell, cfi: int, ng: float, device):
    return device_table(("pdcch_re", cell, cfi, ng), device,
                        lambda: _region_re_indices(cell, cfi, ng))


@functools.lru_cache(maxsize=1024)
def ue_search_candidates(rnti: int, sf_idx: int, n_cce: int) -> tuple:
    """(L, cce) candidates: common + UE-specific (36.213 9.1.1), cached
    per (rnti, sf_idx, n_cce)."""
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
    return tuple(dict.fromkeys(out))


def pdcch_encode(dci_bits, rnti: int, cce: int, l: int, cell: Cell,
                 cfi: int, sf_idx: int, ng: float = 1.0):
    """One DCI -> grid contribution [..., P, nsymb, nre]. The region
    scrambling sequence offset follows the CCE position so independent
    PDCCHs compose additively. Transmit diversity as 36.211 6.8.4 asks:
    SFBC on a 2-port cell, SFBC-FSTD on a 4-port one (6.3.3.3, 6.3.4.3;
    a CCE is 9 quadruplets, so each quadruplet is one SFBC-FSTD group).
    On the card ``pdcch_encode_many`` onto a fresh zero grid (one launch),
    on the CPU the plain twin."""
    if not _on_card(dci_bits):
        return _pdcch_encode_plain(dci_bits, rnti, cce, l, cell, cfi, sf_idx,
                                   ng)
    grid = torch.zeros((*dci_bits.shape[:-1], cell.nof_ports, cell.nsymb_sf,
                        cell.nof_re), dtype=torch.complex64,
                       device=dci_bits.device)
    pdcch_encode_many(grid, [(dci_bits, rnti, cce, l)], cell, cfi, sf_idx,
                      ng)
    return grid


def _pdcch_encode_plain(dci_bits, rnti: int, cce: int, l: int, cell: Cell,
                        cfi: int, sf_idx: int, ng: float = 1.0):
    """``pdcch_encode`` in plain PyTorch (the transmit kernel's twin)."""
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
    ports = precode_diversity(syms, cell.nof_ports)
    grid = torch.zeros((*lead, cell.nof_ports, cell.nsymb_sf * cell.nof_re),
                       dtype=torch.complex64, device=dev)
    grid[..., idx] = ports
    return grid.reshape(*lead, cell.nof_ports, cell.nsymb_sf, cell.nof_re)


def pdcch_encode_many(grid, dcis, cell: Cell, cfi: int, sf_idx: int,
                      ng: float = 1.0) -> None:
    """Add every DCI of ``dcis``, each (bits, rnti, cce, L), onto grid
    [..., P, nsymb, nre] complex64 in place, as ``pdcch_encode``'s
    contributions would add: bits [size] 0/1 (the same DCI in every row of
    the grid) or [..., size] (the grid's leading dims), on the grid's
    device, their CCEs disjoint (``tx_dcis``), then ``pdcch_encode_at``.
    Raises ``ValueError`` on a grid or DCI the kernel does not take."""
    _check_tx_grid(grid, cell)
    dcis = tx_dcis(dcis, cell, cfi, tuple(grid.shape[:-3]), grid.device, ng)
    places = host_ints([at for _, *at in dcis], grid.device)
    pdcch_encode_at(grid, [b for b, *_ in dcis],
                    places.to(grid.device, non_blocking=True), cell, cfi,
                    sf_idx, ng)


def pdcch_encode_at(grid, bits, places, cell: Cell, cfi: int, sf_idx: int,
                    ng: float = 1.0) -> None:
    """``pdcch_encode_many`` of DCIs ``tx_dcis`` checked: bits[i] at
    places[i] = (rnti, cce, L), places int32 [len(bits), 3] on the grid's
    device, read there. On the card (a contiguous grid) one launch of
    ``csrc/pdcch_tx.cu`` a MAX_TX_DCIS DCIs, with no read back to the
    host, whatever the places hold (a CUDA graph replays it with others);
    on the CPU the plain twin, DCI by DCI."""
    if not _on_card(grid):
        for b, (rnti, cce, l) in zip(bits, places.tolist()):
            grid += _pdcch_encode_plain(b, rnti, cce, l, cell, cfi, sf_idx,
                                        ng)
        return
    if not grid.is_contiguous():
        raise ValueError("grid must be contiguous on the card")
    for i in range(0, len(bits), MAX_TX_DCIS):
        _pdcch_tx_launch(grid, bits[i:i + MAX_TX_DCIS],
                         places[i:i + MAX_TX_DCIS], cell, cfi, sf_idx, ng)


def _check_tx_grid(grid, cell: Cell) -> None:
    if grid.dtype != torch.complex64:
        raise ValueError(f"grid must be complex64, not {grid.dtype}")
    plane = (cell.nof_ports, cell.nsymb_sf, cell.nof_re)
    if grid.dim() < 3 or tuple(grid.shape[-3:]) != plane:
        raise ValueError(f"grid shape {tuple(grid.shape)}, want "
                         f"[..., {', '.join(map(str, plane))}]")


def tx_dcis(dcis, cell: Cell, cfi: int, lead: tuple, device,
            ng: float = 1.0) -> list:
    """``dcis`` as [(bits, rnti & 0xFFFF, cce, L)] after the checks of
    ``pdcch_encode_many``: each DCI's bits an integer or bool tensor on
    ``device``, [size] or [*lead, size], K = size + 16 at most MAX_K; L 1,
    2, 4 or 8 inside the region's CCEs and clear of the other DCIs'."""
    n_cce = pdcch_nof_cces(cell, cfi, ng)
    out, used = [], set()
    for bits, rnti, cce, l in dcis:
        if not isinstance(bits, torch.Tensor) or bits.device != device:
            raise ValueError("DCI bits must be a tensor on the grid's "
                             "device")
        if bits.dtype.is_floating_point or bits.dtype.is_complex:
            raise ValueError(f"DCI bits must be integers, not {bits.dtype}")
        if bits.dim() < 1 or tuple(bits.shape[:-1]) not in ((), lead):
            raise ValueError(f"DCI bits shape {tuple(bits.shape)} for a "
                             f"grid of leading dims {lead}")
        if not 1 <= bits.shape[-1] <= MAX_K - 16:
            raise ValueError(f"a DCI of {bits.shape[-1]} bits: its size + 16 "
                             f"must lie in 17-{MAX_K}")
        cce, l = int(cce), int(l)
        if l not in (1, 2, 4, 8) or cce < 0 or cce + l > n_cce:
            raise ValueError(f"L {l} at CCE {cce} does not fit the region's "
                             f"{n_cce} CCEs")
        taken = used.intersection(range(cce, cce + l))
        if taken:
            raise ValueError(f"DCIs overlap at CCEs {sorted(taken)}")
        used.update(range(cce, cce + l))
        out.append((bits, int(rnti) & 0xFFFF, cce, l))
    return out

def pdcch_extract_llr(grid, h, cell: Cell, cfi: int, sf_idx: int,
                      noise_est=0.0, ng: float = 1.0):
    """Equalize + demap + descramble the whole region once
    (srslte_pdcch_extract_llr_multi): -> llr [..., n_regs*8].

    ``h``: [..., nsymb, nre] single-port or [..., P, nsymb, nre],
    combined by ``combine_diversity`` (SFBC on 2 ports, SFBC-FSTD on 4,
    36.211 6.8.4). On
    the card one kernel launch (``ctrl_llr_cuda``), on the CPU the plain
    twin."""
    if _on_card(grid):
        return ctrl_llr_cuda(grid, h, cell, sf_idx, noise_est,
                             region=(cfi, ng))[2]
    return _pdcch_extract_llr_plain(grid, h, cell, cfi, sf_idx, noise_est,
                                    ng)


def _pdcch_extract_llr_plain(grid, h, cell: Cell, cfi: int, sf_idx: int,
                             noise_est=0.0, ng: float = 1.0):
    """``pdcch_extract_llr`` in plain PyTorch (the kernel's twin)."""
    idx = _region_idx(cell, cfi, ng, grid.device)
    y = grid.reshape(*grid.shape[:-2], -1)[..., idx]
    hh = h.reshape(*h.shape[:-2], -1)[..., idx]
    x, csi = combine_diversity(y, hh, noise_est)
    llr = demod_soft(x, Mod.QPSK) * torch.repeat_interleave(csi, 2, -1)
    return descramble_llrs(llr, cinit_pdcch(2 * sf_idx, cell.id))


def pdcch_blind_bits(llr, cands, size: int):
    """Decode EVERY (L, cce) candidate for one DCI size as ONE Viterbi
    batch: de-rate-matching maps each candidate's e = L*72 segment to the
    common [3, k] trellis shape (k = size + 16), so candidates of every
    aggregation level stack along one batch axis.

    llr [..., n_cce*72] -> bits [..., n_cand, k], in ``cands`` order. On
    the card one kernel launch (``pdcch_blind_cuda``), on the CPU the
    plain twin.
    """
    if _on_card(llr):
        return pdcch_blind_cuda(llr, tuple(cands), (size,), 0)[0][0]
    return _pdcch_blind_bits_plain(llr, cands, size)


def _pdcch_blind_bits_plain(llr, cands, size: int):
    """``pdcch_blind_bits`` in plain PyTorch (the kernel's twin)."""
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
    if _on_card(llr):
        bits, ok, _ = pdcch_blind_cuda(llr, cands, tuple(dci_sizes), rnti)
        oks = ok.cpu().numpy()
        bits_np = [b.cpu().numpy() for b in bits]
    else:
        bits_np, oks = [], []
        for size in dci_sizes:
            b = _pdcch_blind_bits_plain(llr, cands, size)
            oks.append(dci_crc_ok(b, size, rnti).numpy())
            bits_np.append(b.numpy())
    hits: list[DciHit] = []
    for size, bits_s, ok in zip(dci_sizes, bits_np, oks):
        for row, (l, cce) in enumerate(cands):
            if ok[row]:
                hits.append(DciHit(bits_s[row, :size].astype(np.int8), l,
                                   cce, rnti))
    seen, uniq = set(), []
    for hit in hits:
        key = hit.payload.tobytes()
        if key not in seen:
            seen.add(key)
            uniq.append(hit)
    return uniq


def control_rx(grid0, h0, cell: Cell, cfi: int, sf_idx: int, rnti: int,
               sizes: tuple, noise_est, stages=EAGER):
    """The batched receiver's control stages: grid0 [..., nsymb, nre] (one
    rx antenna), h0 [..., P, nsymb, nre], noise_est [...] (or a float) ->
    (cfi_hat [...] from the PCFICH, n_det [...] int64: the candidates
    whose CRC16 with ``rnti``'s mask passes, over every DCI size of
    ``sizes`` and the search space of ``rnti`` in the region of ``cfi``).

    The PCFICH and the region's LLRs run in the range ``ue_dl.pdcch_llr``,
    the blind search in ``ue_dl.pdcch_blind_search``: on the card one
    launch each (``ctrl_llr_cuda``, ``pdcch_blind_cuda``), two stages of
    ``stages`` (``runtime.graphs``), and no host sync; on the CPU the
    plain twins."""
    cands = ue_search_candidates(rnti, sf_idx, pdcch_nof_cces(cell, cfi))
    if _on_card(grid0):
        cfi_hat, _, llr = stages("ue_dl.pdcch_llr", ctrl_llr_cuda, grid0, h0,
                                 cell, sf_idx, noise_est, region=(cfi, 1.0))
        n_det = stages("ue_dl.pdcch_blind_search", pdcch_blind_cuda, llr,
                       cands, tuple(sizes), rnti)[2]
        return cfi_hat, n_det
    noise = (noise_est[..., None] if isinstance(noise_est, torch.Tensor)
             else noise_est)
    with trace.span("ue_dl.pdcch_llr"):
        cfi_hat, _ = pcfich._pcfich_decode_plain(grid0, h0, cell, sf_idx,
                                                 noise)
        llr = _pdcch_extract_llr_plain(grid0, h0, cell, cfi, sf_idx, noise)
    with trace.span("ue_dl.pdcch_blind_search"):
        n_det = torch.zeros(llr.shape[:-1], dtype=torch.int64,
                            device=llr.device)
        for size in sizes:
            bits = _pdcch_blind_bits_plain(llr, cands, size)
            n_det = n_det + dci_crc_ok(bits, size, rnti).sum(-1)
    return cfi_hat, n_det


# --- the kernels (csrc/pdcch_rx.cu) ----------------------------------------


def region_signs(cell: Cell, cfi: int, ng: float, sf_idx: int):
    """(RE indices int32 [n_re] of the region, quadruplet order; the
    descrambling signs 1 - 2 c(n) float32 [2 n_re], ``descramble_llrs``'s
    table) for ``ctrl_llr_cuda``."""
    idx = _region_re_indices(cell, cfi, ng)
    c_init = cinit_pdcch(2 * sf_idx, cell.id)
    return (idx.astype(np.int32),
            (1.0 - 2.0 * gold_sequence(c_init, 2 * len(idx))
             ).astype(np.float32))


def _region_tables(cell: Cell, cfi: int, ng: float, sf_idx: int, device):
    """``region_signs`` on ``device``, uploaded once: (RE indices int32,
    scrambling signs float32), which both control kernels read."""
    key = (cell, cfi, ng, sf_idx)
    return tuple(device_table((name,) + key, device,
                              lambda i=i: region_signs(*key)[i])
                 for i, name in enumerate(("pdcch_k_re", "pdcch_k_signs")))


def candidate_table(cands: tuple) -> np.ndarray:
    """int32 [n_cand, 2]: each candidate's first LLR (cce * 72) and E
    (L * 72), in ``cands`` order."""
    return np.array([(cce * BITS_PER_CCE, l * BITS_PER_CCE)
                     for l, cce in cands], np.int32).reshape(-1, 2)


def crc16_syndromes(k: int) -> np.ndarray:
    """int32 [k]: row t of CRC16's parity matrix of length k packed as a
    16-bit word (bit j = column j): a bit vector's CRC16 is the XOR of
    its set bits' rows."""
    h = CRC16.parity_matrix(k).astype(np.int64)
    return (h << np.arange(16)).sum(-1).astype(np.int32)


def derm_inverse(k: int) -> np.ndarray:
    """int32 [3k]: for each position of the [3, k] trellis input, its
    place in one circle of the circular buffer (``rm_conv_rx`` adds the
    E LLRs at place, place + 3k, place + 6k, ... there)."""
    circle = _circle(k)
    inv = np.empty(3 * k, np.int32)
    inv[circle] = np.arange(len(circle), dtype=np.int32)
    return inv


def size_table(sizes: tuple, rnti: int):
    """The blind kernel's per-size table, int32: SIZE_HDR ints a size (K,
    halo min(TRAIN_LEN, K), the offset of its inverse circle, the syndrome of
    ``rnti``'s mask over the CRC's 16 bits), then per size its
    ``derm_inverse`` [3K] and ``crc16_syndromes`` [K]."""
    head, body = [], []
    off = SIZE_HDR * len(sizes)
    mask = uint_to_bits(rnti & 0xFFFF, 16).astype(bool)
    for size in sizes:
        k = size + 16
        syn = crc16_syndromes(k)
        target = int(np.bitwise_xor.reduce(syn[size:][mask], initial=0))
        head += [k, min(TRAIN_LEN, k), off, target]
        body += [derm_inverse(k), syn]
        off += 4 * k
    return np.concatenate([np.asarray(head, np.int32), *body])


def blind_warp_bytes(k: int, halo: int) -> int:
    """Shared bytes a warp of the blind kernel takes at K: the metrics,
    the 8 combinations a column, two decision words a middle and flush
    step, the winner's packed words; rounded up to 16."""
    return (2 * 64 * 4 + 32 * k + 8 * (k + halo) + 16 + 15) // 16 * 16


def blind_plan(ks: tuple, n_cand: int):
    """(warps a block, dynamic shared bytes) of a blind launch: one warp a
    (candidate, size) job, jobs spread evenly when there are more than
    MAX_BLIND_WARPS. Raises ``ValueError`` out of range."""
    if not 1 <= len(ks) <= MAX_SIZES or n_cand < 1 \
            or not all(1 <= k <= MAX_K for k in ks):
        raise ValueError(f"K {ks} x {n_cand} candidates out of range "
                         f"(1-{MAX_SIZES} sizes, K <= {MAX_K})")
    jobs = len(ks) * n_cand
    warps = -(-jobs // -(-jobs // MAX_BLIND_WARPS))
    smem = warps * max(blind_warp_bytes(k, min(TRAIN_LEN, k)) for k in ks)
    if smem > MAX_SMEM:
        raise ValueError(f"{smem} shared bytes a block exceed {MAX_SMEM}")
    return warps, smem


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the kernels (a CUDA tensor) or the twins."""
    return t.is_cuda


def _ptr(t):
    return None if t is None else t.data_ptr()


def ctrl_llr_cuda(grid, h, cell: Cell, sf_idx: int, noise_est=0.0,
                  region: tuple | None = None):
    """One launch of ``csrc/pdcch_rx.cu``'s ``ctrl_llr_kernel`` over the
    subframes of grid [..., nsymb, nre] complex64 on the card (its last
    two dims contiguous; leading dims may be strided) with h [..., nsymb,
    nre] or [..., P, nsymb, nre] complex64 likewise, noise_est a float or
    a float32 tensor of one value or one a subframe: -> the PCFICH's (cfi
    [...] int64, corr [...] float32) as ``pcfich_decode`` gives them, and
    the LLRs [..., 2 n_re] float32 of the PDCCH region of ``region`` =
    (cfi, ng), as ``pdcch_extract_llr`` gives them (None without a
    region)."""
    for name, t in (("grid", grid), ("h", h)):
        if not _on_card(t):
            raise ValueError(f"ctrl_llr_cuda takes CUDA tensors ({name})")
        if t.dtype != torch.complex64:
            raise ValueError(f"{name} must be complex64")
    nsymb, nre = cell.nsymb_sf, cell.nof_re
    if grid.dim() < 2 or tuple(grid.shape[-2:]) != (nsymb, nre):
        raise ValueError(f"grid shape {tuple(grid.shape)}, want "
                         f"[..., {nsymb}, {nre}]")
    lead = grid.shape[:-2]
    has_ports = h.dim() == grid.dim() + 1
    ports = h.shape[-3] if has_ports else 1
    if tuple(h.shape) != (*lead, *((ports,) if has_ports else ()), nsymb,
                          nre):
        raise ValueError(f"h shape {tuple(h.shape)} does not match grid "
                         f"{tuple(grid.shape)}")
    if ports not in (1, 2, 4):
        raise ValueError(f"the PCFICH takes 1, 2 or 4 ports, not {ports}")
    n = int(np.prod(lead)) if lead else 1
    g3 = grid.reshape(n, nsymb, nre)
    h4 = h.reshape(n, ports, nsymb, nre)
    if g3.stride()[1:] != (nre, 1) or h4.stride()[2:] != (nre, 1):
        raise ValueError("grid and h need contiguous [nsymb, nre] planes")
    dev = grid.device
    noise, step, value = None, 0, 0.0
    if isinstance(noise_est, torch.Tensor):
        noise = noise_est.reshape(-1)
        if noise.dtype != torch.float32 or noise.device != dev:
            raise ValueError("noise_est must be float32 on grid's device")
        if noise.numel() not in (1, n):
            raise ValueError(f"{noise.numel()} noise values for {n} "
                             f"subframes")
        step = 0 if noise.numel() == 1 else noise.stride(0)
    else:
        value = float(noise_est)
    pcf_re = device_table(("pcfich_re32", cell), dev, lambda: (
        pcfich._re_indices(cell).astype(np.int32)))
    pcf_sgn = device_table(("pcfich_k_signs", cell, sf_idx), dev,
                           lambda: pcfich.kernel_signs(cell, sf_idx))
    cfi = torch.empty(n, dtype=torch.int64, device=dev)
    corr = torch.empty(n, dtype=torch.float32, device=dev)
    llr = pd_re = pd_sgn = None
    n_re = 0
    if region is not None:
        pd_re, pd_sgn = _region_tables(cell, *region, sf_idx, dev)
        n_re = pd_re.shape[0]
        llr = torch.empty((n, 2 * n_re), dtype=torch.float32, device=dev)
    if n:
        CTRL_LLR.launch(dev, (n, ports, n_re), g3.data_ptr(), g3.stride(0),
                        h4.data_ptr(), h4.stride(0), h4.stride(1), ports,
                        _ptr(noise), step, value, pcf_re.data_ptr(),
                        pcf_sgn.data_ptr(), cfi.data_ptr(), corr.data_ptr(),
                        _ptr(pd_re), _ptr(pd_sgn), n_re, _ptr(llr), n)
    return (cfi.reshape(lead), corr.reshape(lead),
            None if llr is None else llr.reshape(*lead, 2 * n_re))


def pdcch_blind_cuda(llr, cands: tuple, sizes: tuple, rnti: int):
    """One launch of ``csrc/pdcch_rx.cu``'s ``pdcch_blind_kernel``: every
    (L, cce) candidate of ``cands`` decoded for every DCI size of
    ``sizes`` from llr [..., n_llr] float32 on the card (the last dim
    contiguous), the CRC16 checked with ``rnti``'s mask. -> (per size
    bits [..., n_cand, size + 16] int8, as ``pdcch_blind_bits``; ok
    [n_sizes, ..., n_cand] bool, as ``dci_crc_ok`` on them; hits [...]
    int64, the passes summed over sizes and candidates)."""
    if not _on_card(llr):
        raise ValueError("pdcch_blind_cuda takes a CUDA tensor")
    if llr.dtype != torch.float32 or llr.dim() < 1 or llr.stride(-1) != 1:
        raise ValueError("llr must be float32 with a contiguous last dim")
    lead, n_llr = llr.shape[:-1], llr.shape[-1]
    n = int(np.prod(lead)) if lead else 1
    cands = tuple((int(l), int(cce)) for l, cce in cands)
    sizes = tuple(int(s) for s in sizes)
    ks = tuple(s + 16 for s in sizes)
    warps, smem = blind_plan(ks, len(cands))
    if any((cce + l) * BITS_PER_CCE > n_llr for l, cce in cands):
        raise ValueError(f"a candidate of {cands} reaches past {n_llr} LLRs")
    l2 = llr.reshape(n, n_llr)
    dev = llr.device
    cand_t = device_table(("pdcch_k_cands", cands), dev,
                          lambda: candidate_table(cands))
    tab = device_table(("pdcch_k_sizes", sizes, rnti), dev,
                       lambda: size_table(sizes, rnti))
    nc = len(cands)
    buf = torch.empty(n * nc * sum(ks), dtype=torch.int8, device=dev)
    ok = torch.empty((len(sizes), n, nc), dtype=torch.bool, device=dev)
    hits = torch.empty(n, dtype=torch.int64, device=dev)
    if n:
        host_ks = (ctypes.c_int * len(ks))(*ks)
        PDCCH_BLIND.launch(dev, (sizes, cands, n), l2.data_ptr(),
                           l2.stride(0), n, cand_t.data_ptr(), nc,
                           tab.data_ptr(), host_ks, len(ks), TRAIN_LEN,
                           buf.data_ptr(), ok.data_ptr(), hits.data_ptr(),
                           warps, smem)
    offs = [int(o) * n * nc for o in np.cumsum((0,) + ks)]
    bits = [buf[offs[i]:offs[i + 1]].view(*lead, nc, k)
            for i, k in enumerate(ks)]
    return bits, ok.reshape(len(sizes), *lead, nc), hits.reshape(lead)


def _pdcch_tx_launch(grid, bits, places, cell: Cell, cfi: int, sf_idx: int,
                     ng: float) -> None:
    """One launch of ``csrc/pdcch_tx.cu``'s ``pdcch_tx_kernel``: the 1 to
    MAX_TX_DCIS DCIs ``bits`` at ``places`` (``pdcch_encode_at``) added
    onto the contiguous CUDA grid [..., P, nsymb, nre] in place. Bits of
    another integer type are cast to int8 on the card first; nothing is
    read back to the host."""
    ports, plane = cell.nof_ports, cell.nsymb_sf * cell.nof_re
    dev = grid.device
    pd_re, pd_sgn = _region_tables(cell, cfi, ng, sf_idx, dev)
    bits = [b.to(torch.int8).contiguous() for b in bits]
    places = places.to(torch.int32).contiguous()
    ks = [b.shape[-1] + 16 for b in bits]
    circles = [device_table(("rmc_circle", k), dev, lambda k=k: _circle(k))
               for k in ks]
    n, rows = len(bits), grid.numel() // (ports * plane)
    if rows:
        PDCCH_TX.launch(
            dev, (n, ports, max(ks)),
            grid.data_ptr(), ports * plane, plane, ports, rows,
            pd_re.data_ptr(), pd_sgn.data_ptr(), pd_re.shape[0], n,
            (ctypes.c_void_p * n)(*(b.data_ptr() for b in bits)),
            (ctypes.c_longlong * n)(*(0 if b.dim() == 1 else b.shape[-1]
                                      for b in bits)),
            (ctypes.c_int * n)(*(k - 16 for k in ks)),
            (ctypes.c_void_p * n)(*(c.data_ptr() for c in circles)),
            places.data_ptr())
