"""Batched OFDM modulation/demodulation with cyclic prefix, the MBSFN
subframe's mixed-CP timeline, and the uplink half-subcarrier shift.

Capability parity with lib/src/phy/dft/ofdm.c (srslte_ofdm_rx_sf /
srslte_ofdm_tx_sf and the mbsfn plans): per-symbol FFTs with the unequal
first-symbol CP and DC-subcarrier skipping (ofdm.c:121,409-415). The
whole subframe across the batch is one ``torch.fft`` call over
[..., nsymb_sf, fft]. The FFTs are unnormalized; the JAX package's
``normalize`` keyword is not ported.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.cell import Cell, symbol_sz
from ..utils.device import device_table


@functools.lru_cache(maxsize=64)
def _grid_to_bins(nof_prb: int, reduced: bool = False) -> np.ndarray:
    """Grid subcarrier g in [0, nre) -> FFT bin (DC at bin 0, skipped):
    negative half first (ofdm.c:414)."""
    fft = symbol_sz(nof_prb, reduced)
    nre = nof_prb * 12
    g = np.arange(nre, dtype=np.int64)
    return np.where(g < nre // 2, fft - nre // 2 + g, g - nre // 2 + 1)


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


