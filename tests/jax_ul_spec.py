"""The JAX package's uplink brought to TS 36.211 for the tests that hold the
port to it.

The port's PUSCH DMRS adds n_PN(ns) to its cyclic shift (5.5.2.1.1), and
its SC-FDMA signal puts grid subcarrier k at frequency k - 6 N_RB + 1/2,
with no DC gap, the half subcarrier's phase starting from 0 at each
symbol's useful part (5.6). The JAX package's uplink does neither: its
DMRS takes alpha = 2 pi n_DMRS / 12, and it modulates with the downlink's
DC gap and one phase ramp over the whole subframe. ``spec_uplink()``
replaces those three JAX stages, while it is open, by the specification's,
written here on top of the JAX package's own pieces:

* ``pusch_dmrs``: JAX's, called per slot with n_cs = (n_DMRS + n_PN(ns))
  mod 12 (in ``models.refsignal_ul`` and ``models.pusch``);
* ``ue_ul_generate``: JAX's, with its ``ofdm_tx_sf`` the SC-FDMA
  modulator below and its ``freq_shift_half_subcarrier`` left out;
* ``enb_ul_receive_grid``: the SC-FDMA demodulator below.

Every other JAX stage stays as it is, so the port stays held to it as
tightly as before. The JAX caches that could hold a program traced with
the stages of the other side are cleared on entry and on exit.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from empower_srslte_tpu.models import pusch as jpusch
from empower_srslte_tpu.models import refsignal_ul as jrs
from empower_srslte_tpu.models import ue_ul as jue
from empower_srslte_tpu.ops.ofdm import _symbol_starts
from empower_srslte_tpu.utils.sequence import gold_sequence

_JAX_PUSCH_DMRS = jrs.pusch_dmrs


def n_pn(cell, ns: int, delta_ss: int = 0) -> int:
    """n_PN(ns) = sum_i c(8 N_symb ns + i) 2^i, c_init = floor(N_ID / 30)
    2^5 + (N_ID + delta_ss) mod 30 (36.211 5.5.2.1.1)."""
    c_init = ((cell.id // 30) << 5) + ((cell.id % 30) + delta_ss) % 30
    per_slot = 8 * cell.nsymb_slot
    c = gold_sequence(c_init, per_slot * 20)
    return sum(int(c[per_slot * ns + i]) << i for i in range(8))


def pusch_dmrs(cell, n_prb: int, cyclic_shift: int = 0, delta_ss: int = 0,
               sf_idx: int = 0, group_hopping: bool = False,
               sequence_hopping: bool = False) -> np.ndarray:
    """JAX's ``pusch_dmrs`` with n_PN(ns) in each slot's cyclic shift."""
    return np.stack([_JAX_PUSCH_DMRS(
        cell, n_prb,
        (cyclic_shift + n_pn(cell, 2 * sf_idx + slot, delta_ss)) % 12,
        delta_ss, sf_idx, group_hopping, sequence_hopping)[slot]
        for slot in range(2)])


def _ramp(fft: int, sign: int):
    return jnp.asarray(np.exp(sign * 1j * np.pi * np.arange(fft) / fft)
                       .astype(np.complex64))


def sc_fdma_tx(grid, cell):
    """grid [..., nsymb, nre] -> samples (36.211 5.6), in jnp."""
    fft, half = cell.fft_size, cell.nof_re // 2
    grid = jnp.asarray(grid, jnp.complex64)
    gap = jnp.zeros((*grid.shape[:-1], fft - cell.nof_re), jnp.complex64)
    sym = jnp.fft.ifft(jnp.concatenate([grid[..., half:], gap,
                                        grid[..., :half]], axis=-1),
                       axis=-1) * _ramp(fft, 1)
    cps = cell.cp_len_slot
    pieces = []
    for i in range(cell.nsymb_sf):
        cp_len = cps[i % cell.nsymb_slot]
        # the prefix reaches back fft samples: the half subcarrier turns
        # its sign there
        pieces += [-sym[..., i, fft - cp_len:], sym[..., i, :]]
    return jnp.concatenate(pieces, axis=-1)


def sc_fdma_rx(samples, cell):
    """samples [..., sf_len] -> grid [..., nsymb, nre] (36.211 5.6)."""
    fft, half = cell.fft_size, cell.nof_re // 2
    samples = jnp.asarray(samples)
    starts = _symbol_starts(cell.nof_prb, cell.cp, cell.reduced_rates)
    sym = jnp.stack([samples[..., int(s):int(s) + fft] for s in starts],
                    axis=-2) * _ramp(fft, -1)
    spec = jnp.fft.fft(sym, axis=-1)
    return jnp.concatenate([spec[..., fft - half:], spec[..., :half]],
                           axis=-1)


def _clear() -> None:
    jue.ue_ul_pusch_jit.cache_clear()
    jpusch.pusch_decode_jit.cache_clear()
    jpusch.pusch_decode_uci_jit.cache_clear()
    jax.clear_caches()


@contextlib.contextmanager
def spec_uplink():
    """The JAX package's PUSCH DMRS and SC-FDMA pair replaced by the
    specification's while the block runs."""
    _clear()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jrs, "pusch_dmrs", pusch_dmrs)
            mp.setattr(jpusch, "pusch_dmrs", pusch_dmrs)
            mp.setattr(jue, "ofdm_tx_sf", sc_fdma_tx)
            mp.setattr(jue, "freq_shift_half_subcarrier",
                       lambda samples, cell, direction=1: samples)
            mp.setattr(jue, "enb_ul_receive_grid", sc_fdma_rx)
            yield
    finally:
        _clear()
