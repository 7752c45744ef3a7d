"""Gold-sequence scrambling of bits and LLRs.

Capability parity with lib/src/phy/scrambling/scrambling.c: bit XOR on the
TX side, LLR sign flip on the RX side. Sequences are generated host-side
per (c_init, length) (utils/sequence.py) and cached on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.device import device_table
from ..utils.sequence import gold_sequence


def scramble_bits(bits: torch.Tensor, c_init: int) -> torch.Tensor:
    """TX: bits [..., n] XOR c(n) (int8)."""
    n = bits.shape[-1]
    c = device_table(("gold", c_init, n), bits.device,
                     lambda: gold_sequence(c_init, n))
    return torch.bitwise_xor(bits.to(torch.int8), c)


def descramble_llrs(llrs: torch.Tensor, c_init: int) -> torch.Tensor:
    """RX: flip LLR signs where the scrambling bit is 1 (dtype preserved:
    the int8 lane descrambles in int8, scrambling.c:35-107)."""
    n = llrs.shape[-1]
    dtype = np.int8 if llrs.dtype == torch.int8 else np.float32
    sign = device_table(
        ("gold_sign", c_init, n, dtype), llrs.device,
        lambda: (1.0 - 2.0 * gold_sequence(c_init, n)).astype(dtype))
    return llrs * sign
