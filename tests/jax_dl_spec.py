"""The JAX package's PHICH brought to TS 36.211 for the tests that hold the
port to it.

The port's PHICH follows TS 36.211 6.9 and 36.212 5.3.5: the HI (1 = ACK)
is coded as three equal bits, each BPSK-modulated as (1 - 2b)(1 + j)/sqrt(2)
(7.1.1), so that ACK is -(1 + j)/sqrt(2), and scrambled with c_init =
(floor(n_s / 2) + 1)(2 N_ID + 1) 2^9 + N_ID (6.9.1). The JAX package sends
ACK as a real +1 and scrambles with the PDCCH's c_init. ``spec_downlink()``
replaces JAX's ``phich_put`` and ``phich_decode``, while it is open, by the
specification's, written here on top of the JAX package's own pieces (its
group REs, orthogonal sequences, Gold sequence, SFBC precoder and
equalizer); the decode's metric is the despread symbol's projection on the
ACK symbol, as the port's. Every other JAX stage stays as it is, so the
port stays held to it as tightly as before. The JAX caches that could hold
a program traced with the other side's PHICH are cleared on entry and on
exit.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from empower_srslte_tpu.models import phich as jphich
from empower_srslte_tpu.models import ue_dl as jue_dl
from empower_srslte_tpu.ops.equalizer import eq_sfbc, precode_sfbc
from empower_srslte_tpu.utils.scatter import overlay
from empower_srslte_tpu.utils.sequence import cinit_pcfich, gold_sequence

#: the BPSK symbol of HI bit 0 (NACK); bit 1 (ACK) is its negative
BPSK0 = (1 + 1j) / np.sqrt(2)


def _scramble(cell, sf_idx: int) -> np.ndarray:
    """1 - 2 c(i), i < 12, c_init of 36.211 6.9.1."""
    c = gold_sequence(cinit_pcfich(2 * sf_idx, cell.id), 12)
    return (1.0 - 2.0 * c).astype(np.float32)


def phich_put(grid, ack: int, cell, sf_idx: int, group: int = 0,
              seq_idx: int = 0, ng: float = 1.0):
    """JAX's ``phich_put`` with the specification's symbols d(0..11)."""
    z = np.tile(jphich._W[seq_idx], 3) * _scramble(cell, sf_idx) * (
        -BPSK0 if ack else BPSK0)
    idx = jphich._group_re_indices(cell, ng, group)
    flat = grid.reshape(*grid.shape[:-3], grid.shape[-3], -1)
    zt = jnp.asarray(z.astype(np.complex64)).astype(grid.dtype)
    if cell.nof_ports >= 2:
        ps = precode_sfbc(jnp.stack([zt[0::2], zt[1::2]], axis=-2))
        rows = [overlay(flat[..., p, :], flat[..., p, jnp.asarray(idx)]
                        + ps[..., p, :], idx) for p in range(2)]
        flat = jnp.concatenate([r[..., None, :] for r in rows]
                               + [flat[..., 2:, :]], axis=-2)
    else:
        p0 = overlay(flat[..., 0, :], flat[..., 0, jnp.asarray(idx)] + zt,
                     idx)
        flat = jnp.concatenate([p0[..., None, :], flat[..., 1:, :]], axis=-2)
    return flat.reshape(grid.shape)


def phich_decode(grid, h, cell, sf_idx: int, group: int = 0,
                 seq_idx: int = 0, ng: float = 1.0, noise_est=0.0):
    """JAX's ``phich_decode`` on the specification's symbols: -> (ack,
    metric), the metric positive <=> ACK."""
    idx = jnp.asarray(jphich._group_re_indices(cell, ng, group))
    y = grid[..., 0, :][..., idx]
    if h.ndim == grid.ndim + 1 and h.shape[-3] >= 2:
        x, _ = eq_sfbc(y[..., None, :], h[..., 0, 0, :][..., idx][..., None, :],
                       h[..., 1, 0, :][..., idx][..., None, :])
    else:
        if h.ndim == grid.ndim + 1:
            h = h[..., 0, :, :]
        hh = h[..., 0, :][..., idx]
        x = y * jnp.conj(hh) / jnp.maximum(jnp.abs(hh) ** 2 + noise_est,
                                           1e-12)
    w = jnp.asarray(np.tile(np.conj(jphich._W[seq_idx]), 3))
    corr = jnp.sum(x * jnp.asarray(_scramble(cell, sf_idx)) * w,
                   axis=-1) / 12.0
    metric = -(jnp.real(corr) + jnp.imag(corr)) / np.float32(np.sqrt(2))
    return metric > 0, metric


def _clear() -> None:
    jue_dl._phich_cache.clear()
    jax.clear_caches()


@contextlib.contextmanager
def spec_downlink():
    """The JAX package's PHICH replaced by the specification's while the
    block runs."""
    _clear()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jphich, "phich_put", phich_put)
            mp.setattr(jphich, "phich_decode", phich_decode)
            yield
    finally:
        _clear()
