"""Gold-sequence scrambling of bits and LLRs.

Capability parity with lib/src/phy/scrambling/scrambling.c: bit XOR on the
TX side, LLR sign flip on the RX side. Sequences are generated host-side
per (c_init, length) (utils/sequence.py) and cached on the device.
"""

from __future__ import annotations

import torch

from ..utils.device import device_table
from ..utils.sequence import gold_sequence


def scramble_bits(bits: torch.Tensor, c_init: int) -> torch.Tensor:
    """TX: bits [..., n] XOR c(n) (int8)."""
    n = bits.shape[-1]
    c = device_table(("gold", c_init, n), bits.device,
                     lambda: gold_sequence(c_init, n))
    return torch.bitwise_xor(bits.to(torch.int8), c)


