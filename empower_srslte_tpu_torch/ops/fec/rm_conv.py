"""Rate matching for convolutionally coded channels, 36.212 5.1.4.2.

Capability parity with lib/src/phy/fec/rm_conv.c (PBCH/PDCCH/UCI rate
matching): three sub-block interleavers with the convolutional column
permutation (Table 5.1.4-2), concatenated circular buffer, selection from
k0 = 0 skipping NULLs. Same precomputed-index design as rate_matching.py.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils.device import device_table

NCOLS = 32
#: Column permutation for convolutional sub-block interleaving
#: (36.212 Table 5.1.4-2).
PERM_CONV = np.array(
    [1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
     0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30],
    dtype=np.int64,
)


@functools.lru_cache(maxsize=512)
def _circle(k: int) -> np.ndarray:
    """One full circle of useful circular-buffer reads (flat d[3, K])."""
    r = -(-k // NCOLS)
    kp = r * NCOLS
    nd = kp - k
    j = np.arange(kp, dtype=np.int64)
    y = (j % r) * NCOLS + PERM_CONV[j // r]
    pos = y - nd
    w = np.concatenate([np.where(pos >= 0, s * k + pos, -1) for s in range(3)])
    return w[w >= 0]


@functools.lru_cache(maxsize=512)
def _selection(k: int, e: int) -> np.ndarray:
    """TX map: e output positions -> flat indices into d[3, K]."""
    circle = _circle(k)
    reps = -(-e // len(circle))
    return np.tile(circle, reps)[:e]


def rm_conv_tx(d, e: int):
    """d[..., 3, K] bits -> [..., E] (gather)."""
    k = d.shape[-1]
    idx = device_table(("rmc_tx", k, e), d.device, lambda: _selection(k, e))
    return d.reshape(*d.shape[:-2], 3 * k)[..., idx]


def rm_conv_rx(llr_e, k: int):
    """Soft de-rate-matching: [..., E] LLRs -> d_llr[..., 3, K], repetition
    combining as circle-sum + static placement."""
    e = llr_e.shape[-1]
    circle_np = _circle(k)
    circle = device_table(("rmc_circle", k), llr_e.device, lambda: circle_np)
    n = len(circle_np)
    reps = -(-e // n)
    pad = reps * n - e
    if pad:
        llr_e = torch.nn.functional.pad(llr_e, (0, pad))
    summed = llr_e.reshape(*llr_e.shape[:-1], reps, n).sum(-2)
    acc = llr_e.new_zeros((*llr_e.shape[:-1], 3 * k))
    acc[..., circle] = summed
    return acc.reshape(*acc.shape[:-1], 3, k)
