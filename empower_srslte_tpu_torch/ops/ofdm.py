"""Batched OFDM modulation/demodulation with cyclic prefix, and the
uplink half-subcarrier shift.

Capability parity with lib/src/phy/dft/ofdm.c (srslte_ofdm_rx_sf /
srslte_ofdm_tx_sf): per-symbol FFTs with the unequal first-symbol CP and
DC-subcarrier skipping (ofdm.c:121,409-415). The whole subframe across
the batch is one ``torch.fft`` call over [..., nsymb_sf, fft].
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


@functools.lru_cache(maxsize=64)
def _grid_to_bins(nof_prb: int, reduced: bool = False) -> np.ndarray:
    """Grid subcarrier g in [0, nre) -> FFT bin (DC at bin 0, skipped):
    negative half first (ofdm.c:414)."""
    fft = symbol_sz(nof_prb, reduced)
    nre = nof_prb * 12
    g = np.arange(nre, dtype=np.int64)
    return np.where(g < nre // 2, fft - nre // 2 + g, g - nre // 2 + 1)


def ofdm_rx_sf(samples: torch.Tensor, cell: Cell) -> torch.Tensor:
    """Subframe demodulation: [..., sf_sample_len] -> grid [..., nsymb, nre]
    (srslte_ofdm_rx_sf, ofdm.c:456)."""
    fft = cell.fft_size
    starts = _symbol_starts(cell.nof_prb, cell.cp, cell.reduced_rates)
    sym = torch.stack([samples[..., int(s):int(s) + fft] for s in starts],
                      dim=-2)                              # [..., nsymb, fft]
    spec = torch.fft.fft(sym, dim=-1)
    half = cell.nof_re // 2
    return torch.cat([spec[..., fft - half:], spec[..., 1:1 + half]], dim=-1)


def ofdm_tx_sf(grid: torch.Tensor, cell: Cell) -> torch.Tensor:
    """Subframe modulation: grid [..., nsymb, nre] -> [..., sf_sample_len]
    (srslte_ofdm_tx_sf, ofdm.c:583): subcarriers around DC, IFFT, CP."""
    fft = cell.fft_size
    bins = device_table(("ofdm_bins", cell.nof_prb, cell.reduced_rates),
                        grid.device,
                        lambda: _grid_to_bins(cell.nof_prb,
                                              cell.reduced_rates))
    spec = grid.new_zeros((*grid.shape[:-1], fft))
    spec[..., bins] = grid
    sym = torch.fft.ifft(spec, dim=-1)                     # [..., nsymb, fft]
    cps = cell.cp_len_slot
    pieces = []
    for i in range(cell.nsymb_sf):
        cp_len = cps[i % cell.nsymb_slot]
        s = sym[..., i, :]
        pieces.append(s[..., fft - cp_len:])
        pieces.append(s)
    return torch.cat(pieces, dim=-1)


def freq_shift_half_subcarrier(samples: torch.Tensor, cell: Cell,
                               direction: int = 1) -> torch.Tensor:
    """Multiply by exp(j*2*pi*0.5*n/fft): the UL half-subcarrier shift
    (ofdm.c:363-381). direction=+1 TX, -1 RX."""
    n = samples.shape[-1]
    ph = device_table(
        ("half_sc", cell.fft_size, n, direction), samples.device,
        lambda: np.exp(direction * 2j * np.pi * 0.5 * np.arange(n)
                       / cell.fft_size).astype(np.complex64))
    return samples * ph
