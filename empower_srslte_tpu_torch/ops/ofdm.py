"""Batched OFDM modulation/demodulation with cyclic prefix, the MBSFN
subframe's mixed-CP timeline, and the uplink's SC-FDMA signal.

Capability parity with lib/src/phy/dft/ofdm.c (srslte_ofdm_rx_sf /
srslte_ofdm_tx_sf and the mbsfn plans): per-symbol FFTs with the unequal
first-symbol CP and DC-subcarrier skipping (ofdm.c:121,409-415). The
whole subframe across the batch is one ``torch.fft`` call over
[..., nsymb_sf, fft]. The FFTs are unnormalized; the JAX package's
``normalize`` keyword is not ported.

The uplink (``sc_fdma_tx_sf`` / ``sc_fdma_rx_sf``) follows TS 36.211 5.6:
grid subcarrier k sits at frequency k - 6 N_RB + 1/2, with no DC gap, and
the half-subcarrier phase starts from 0 at each symbol's useful part. (The
JAX package's uplink keeps the downlink's DC gap and shifts by one phase
ramp over the whole subframe.)
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.cell import CP, Cell, cp_lengths, symbol_sz
from ..utils.device import device_table


@functools.lru_cache(maxsize=64)
def _symbol_starts(nof_prb: int, cp: CP, reduced: bool = False) -> np.ndarray:
    """Sample index of each symbol's data region (after its CP) in a sf."""
    fft = symbol_sz(nof_prb, reduced)
    cps = cp_lengths(nof_prb, cp, reduced)
    starts = []
    pos = 0
    for _slot in range(2):
        for cp_len in cps:
            pos += cp_len
            starts.append(pos)
            pos += fft
    return np.asarray(starts, dtype=np.int64)


@functools.lru_cache(maxsize=16)
def _symbol_starts_mbsfn(nof_prb: int, non_mbsfn_region: int,
                         reduced: bool = False) -> np.ndarray:
    """Symbol data-region starts for an MBSFN subframe: the first
    ``non_mbsfn_region`` symbols keep normal-CP lengths, a guard gap
    re-aligns the timeline, the rest are extended CP
    (srslte_ofdm_rx_slot_mbsfn, ofdm.c:427-440;
    SRSLTE_NON_MBSFN_REGION_GUARD_LENGTH, phy_common.h:140)."""
    fft = symbol_sz(nof_prb, reduced)
    cp_norm, cp_ext, guard = _mbsfn_cps(fft, non_mbsfn_region)
    starts = []
    pos = 0
    for i in range(6):                  # slot 0: mixed-CP MBSFN slot
        if i == non_mbsfn_region:
            pos += guard
        pos += cp_norm(i) if i < non_mbsfn_region else cp_ext
        starts.append(pos)
        pos += fft
    for _i in range(6):                 # slot 1: plain extended CP
        pos += cp_ext
        starts.append(pos)
        pos += fft
    return np.asarray(starts, dtype=np.int64)


def _mbsfn_cps(fft: int, non_mbsfn_region: int):
    """(normal CP length of symbol i, extended CP length, guard) of an
    MBSFN subframe at FFT size ``fft``."""
    cp_norm = lambda i: (160 if i == 0 else 144) * fft // 2048
    cp_ext = 512 * fft // 2048
    guard = (non_mbsfn_region * cp_ext
             - sum(cp_norm(i) for i in range(non_mbsfn_region)))
    return cp_norm, cp_ext, guard


@functools.lru_cache(maxsize=64)
def _grid_to_bins(nof_prb: int, reduced: bool = False) -> np.ndarray:
    """Grid subcarrier g in [0, nre) -> FFT bin (DC at bin 0, skipped):
    negative half first (ofdm.c:414)."""
    fft = symbol_sz(nof_prb, reduced)
    nre = nof_prb * 12
    g = np.arange(nre, dtype=np.int64)
    return np.where(g < nre // 2, fft - nre // 2 + g, g - nre // 2 + 1)


def _rx(samples: torch.Tensor, cell: Cell, starts) -> torch.Tensor:
    """Symbols at ``starts`` -> one FFT -> grid [..., nsymb, nre]."""
    fft = cell.fft_size
    sym = torch.stack([samples[..., int(s):int(s) + fft] for s in starts],
                      dim=-2)                              # [..., nsymb, fft]
    spec = torch.fft.fft(sym, dim=-1)
    half = cell.nof_re // 2
    return torch.cat([spec[..., fft - half:], spec[..., 1:1 + half]], dim=-1)


def ofdm_rx_sf(samples: torch.Tensor, cell: Cell) -> torch.Tensor:
    """Subframe demodulation: [..., sf_sample_len] -> grid [..., nsymb, nre]
    (srslte_ofdm_rx_sf, ofdm.c:456)."""
    return _rx(samples, cell, _symbol_starts(cell.nof_prb, cell.cp,
                                             cell.reduced_rates))


def ofdm_rx_sf_mbsfn(samples: torch.Tensor, cell: Cell,
                     non_mbsfn_region: int = 2) -> torch.Tensor:
    """MBSFN subframe demodulation: [..., sf_sample_len] ->
    grid [..., 12, nre] (srslte_ofdm_rx_sf with the mbsfn plan)."""
    return _rx(samples, cell, _symbol_starts_mbsfn(
        cell.nof_prb, non_mbsfn_region, cell.reduced_rates))


def _tx_symbols(grid: torch.Tensor, cell: Cell) -> torch.Tensor:
    """grid [..., nsymb, nre] -> subcarriers around DC -> IFFT ->
    [..., nsymb, fft]."""
    fft = cell.fft_size
    bins = device_table(("ofdm_bins", cell.nof_prb, cell.reduced_rates),
                        grid.device,
                        lambda: _grid_to_bins(cell.nof_prb,
                                              cell.reduced_rates))
    spec = grid.new_zeros((*grid.shape[:-1], fft))
    spec[..., bins] = grid
    return torch.fft.ifft(spec, dim=-1)


def _add_cps(sym: torch.Tensor, cps) -> torch.Tensor:
    """[..., nsymb, fft] with per-symbol CP lengths ``cps`` -> samples."""
    fft = sym.shape[-1]
    pieces = []
    for i, cp_len in enumerate(cps):
        s = sym[..., i, :]
        pieces.append(s[..., fft - cp_len:])
        pieces.append(s)
    return torch.cat(pieces, dim=-1)


def ofdm_tx_sf(grid: torch.Tensor, cell: Cell) -> torch.Tensor:
    """Subframe modulation: grid [..., nsymb, nre] -> [..., sf_sample_len]
    (srslte_ofdm_tx_sf, ofdm.c:583): subcarriers around DC, IFFT, CP."""
    cps = cell.cp_len_slot
    return _add_cps(_tx_symbols(grid, cell),
                    [cps[i % cell.nsymb_slot] for i in range(cell.nsymb_sf)])


def ofdm_tx_sf_mbsfn(grid: torch.Tensor, cell: Cell,
                     non_mbsfn_region: int = 2) -> torch.Tensor:
    """MBSFN subframe modulation: grid [..., 12, nre] -> samples.

    Inverse of ``ofdm_rx_sf_mbsfn`` (srslte_ofdm_tx_slot_mbsfn): the first
    ``non_mbsfn_region`` symbols keep normal-CP lengths, the guard gap
    extends the first extended-CP symbol's cyclic prefix (filled
    cyclically from the symbol), the remaining symbols use extended CP.
    Total length = 12*(fft+cp_ext) = sf_sample_len.
    """
    cp_norm, cp_ext, guard = _mbsfn_cps(cell.fft_size, non_mbsfn_region)
    cps = [cp_norm(i) if i < non_mbsfn_region
           else cp_ext + guard if i == non_mbsfn_region else cp_ext
           for i in range(12)]
    return _add_cps(_tx_symbols(grid, cell), cps)


def _half_ramp(fft: int, device, sign: int) -> torch.Tensor:
    """exp(sign j pi n / fft) over one symbol's useful part: the half
    subcarrier's phase, from 0 at the part's first sample."""
    return device_table(
        ("sc_fdma_half", fft, sign), device,
        lambda: np.exp(sign * 1j * np.pi * np.arange(fft) / fft)
        .astype(np.complex64))


def sc_fdma_tx_sf(grid: torch.Tensor, cell: Cell) -> torch.Tensor:
    """Uplink subframe modulation (TS 36.211 5.6): grid [..., nsymb, nre]
    -> [..., sf_sample_len]. Subcarrier k goes to FFT bin
    (k - nre / 2) mod fft, the IFFT's output is turned by the half
    subcarrier's phase, and each cyclic prefix continues its symbol
    backwards: the half subcarrier turns the prefix's sign over the
    ``fft`` samples it reaches back."""
    fft, half = cell.fft_size, cell.nof_re // 2
    gap = grid.new_zeros((*grid.shape[:-1], fft - cell.nof_re))
    spec = torch.cat([grid[..., half:], gap, grid[..., :half]], dim=-1)
    sym = torch.fft.ifft(spec, dim=-1) * _half_ramp(fft, grid.device, 1)
    cps = cell.cp_len_slot
    pieces = []
    for i in range(cell.nsymb_sf):
        cp_len = cps[i % cell.nsymb_slot]
        pieces.append(-sym[..., i, fft - cp_len:])
        pieces.append(sym[..., i, :])
    return torch.cat(pieces, dim=-1)


def sc_fdma_rx_sf(samples: torch.Tensor, cell: Cell) -> torch.Tensor:
    """Uplink subframe demodulation (TS 36.211 5.6): [..., sf_sample_len]
    -> grid [..., nsymb, nre]. Each symbol's useful part is turned back by
    the half subcarrier's phase and FFTed; grid subcarrier k is bin
    (k - nre / 2) mod fft."""
    fft, half = cell.fft_size, cell.nof_re // 2
    starts = _symbol_starts(cell.nof_prb, cell.cp, cell.reduced_rates)
    sym = torch.stack([samples[..., int(s):int(s) + fft] for s in starts],
                      dim=-2)                              # [..., nsymb, fft]
    spec = torch.fft.fft(sym * _half_ramp(fft, samples.device, -1), dim=-1)
    return torch.cat([spec[..., fft - half:], spec[..., :half]], dim=-1)
