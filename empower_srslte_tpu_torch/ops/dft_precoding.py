"""SC-FDMA transform (DFT) precoding, 36.211 5.3.3.

Capability parity with lib/src/phy/dft/dft_precoding.c: the DFT spread of
PUSCH data symbols and its inverse, plus the valid-PRB rule (allocations
must factor as 2^a 3^b 5^c, dft_precoding.c:95-105). Batched ``torch.fft``
over [..., nsymb, M_sc] blocks.
"""

from __future__ import annotations

import numpy as np
import torch


def valid_prb(n_prb: int) -> bool:
    """True if n_prb = 2^a * 3^b * 5^c (dft_precoding.c:95)."""
    if n_prb < 1:
        return False
    for p in (2, 3, 5):
        while n_prb % p == 0:
            n_prb //= p
    return n_prb == 1


def dft_precode(symbols: torch.Tensor) -> torch.Tensor:
    """[..., M] -> DFT-spread [..., M], unitary scaling."""
    m = symbols.shape[-1]
    return torch.fft.fft(symbols, dim=-1) / float(np.float32(np.sqrt(m)))


def dft_deprecode(symbols: torch.Tensor) -> torch.Tensor:
    """Inverse transform (IDFT), unitary scaling."""
    m = symbols.shape[-1]
    return torch.fft.ifft(symbols, dim=-1) * float(np.float32(np.sqrt(m)))
