"""Resampling and interpolation (lib/src/phy/resampling/ parity).

interp.c's linear vector interpolation, integer decimation with an
anti-alias FIR, zero-stuffing interpolation and the rational-ratio
resampler built from them, batched over leading dims.
"""

from __future__ import annotations

import functools
from math import gcd

import numpy as np
import torch


def interp_linear(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Linear interpolation by an integer factor: [..., N] -> [..., N*f]
    (srslte_interp_linear_*, extrapolating the tail)."""
    n = x.shape[-1]
    right = torch.cat([x[..., 1:], 2 * x[..., -1:] - x[..., -2:-1]], dim=-1)
    t = torch.arange(factor, dtype=torch.float32, device=x.device) / factor
    out = x[..., :, None] * (1 - t) + right[..., :, None] * t
    return out.reshape(*x.shape[:-1], n * factor)


@functools.lru_cache(maxsize=64)
def _lowpass_fir(ntaps: int, cutoff: float) -> np.ndarray:
    n = np.arange(ntaps) - (ntaps - 1) / 2
    h = np.sinc(2 * cutoff * n) * np.hamming(ntaps)
    return (h / h.sum()).astype(np.float32)


def _fir(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """'Same'-length FIR along the last axis, zero-padded, one scaled
    shifted add per tap."""
    ln = len(taps)
    lead = x.shape[:-1]
    xp = torch.cat([x.new_zeros((*lead, ln // 2)), x,
                    x.new_zeros((*lead, ln - 1 - ln // 2))], dim=-1)
    out = 0
    for i in range(ln):
        out = out + float(taps[i]) * xp[..., i:i + x.shape[-1]]
    return out


def decimate(x: torch.Tensor, factor: int, ntaps: int = 33) -> torch.Tensor:
    """Anti-aliased decimation: [..., N] -> [..., N//f]."""
    if factor == 1:
        return x
    return _fir(x, _lowpass_fir(ntaps, 0.5 / factor))[..., ::factor]


def upsample(x: torch.Tensor, factor: int, ntaps: int = 33) -> torch.Tensor:
    """Zero-stuffing + lowpass interpolation: [..., N] -> [..., N*f]."""
    if factor == 1:
        return x
    up = x.new_zeros((*x.shape[:-1], x.shape[-1] * factor))
    up[..., ::factor] = x * factor
    return _fir(up, _lowpass_fir(ntaps, 0.5 / factor))


def resample_ratio(x: torch.Tensor, p: int, q: int) -> torch.Tensor:
    """Rational-ratio resampling by p/q (srslte_resample_arb)."""
    g = gcd(p, q)
    return decimate(upsample(x, p // g), q // g)
