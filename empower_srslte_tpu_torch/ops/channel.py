"""Channel models for tests, stimuli and BLER evaluation.

Capability parity with lib/src/phy/channel/ (ch_awgn.c AWGN via Box-Muller
gauss.c) plus a simple tapped-delay fading model for frequency-selective
tests. Counterpart of the JAX package's ops/channel.py:16-50: ``awgn``
draws on the tensor's device from an explicit ``torch.Generator`` where
the JAX version takes a PRNG key (the two draw different numbers).
"""

from __future__ import annotations

import numpy as np
import torch


def awgn(gen: torch.Generator, x: torch.Tensor, n0: float) -> torch.Tensor:
    """Add complex AWGN of total power n0 (per complex sample), drawn
    from ``gen`` (a generator on x's device)."""
    std = float(np.sqrt(n0 / 2))
    re = torch.randn(x.shape, generator=gen, device=x.device)
    im = torch.randn(x.shape, generator=gen, device=x.device)
    return x + (std * torch.complex(re, im)).to(x.dtype)


def awgn_np(rng: np.random.Generator, x: np.ndarray, n0: float) -> np.ndarray:
    n = rng.normal(size=x.shape) + 1j * rng.normal(size=x.shape)
    return (x + np.sqrt(n0 / 2) * n).astype(np.complex64)


def snr_to_n0(x, snr_db: float) -> float:
    """Noise power per sample giving ``snr_db`` against x's mean power
    (one host read for a tensor)."""
    if isinstance(x, torch.Tensor):
        p = float((x.abs() ** 2).to(torch.float64).mean())
    else:
        p = float(np.mean(np.abs(np.asarray(x)) ** 2))
    return p / 10 ** (snr_db / 10)


def rayleigh_taps(rng: np.random.Generator, delays: list[int],
                  powers_db: list[float]) -> np.ndarray:
    """Random static tapped-delay-line impulse response (EPA/EVA style)."""
    h = np.zeros(max(delays) + 1, np.complex64)
    for d, p in zip(delays, powers_db):
        amp = 10 ** (p / 20) / np.sqrt(2)
        h[d] += amp * (rng.normal() + 1j * rng.normal())
    return h


def apply_multipath(x: torch.Tensor, h_taps) -> torch.Tensor:
    """Convolve samples [..., N] with taps [L] (same-length output, the
    first L-1 samples see zeros before the start)."""
    taps = np.asarray(h_taps, np.complex64)
    l = len(taps)
    xp = torch.nn.functional.pad(torch.view_as_real(x), (0, 0, l - 1, 0))
    xp = torch.view_as_complex(xp)
    out = 0
    for i in range(l):
        out = out + complex(taps[i]) * xp[..., l - 1 - i:xp.shape[-1] - i]
    return out
