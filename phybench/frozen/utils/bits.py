"""Bit pack/unpack helpers (host numpy).

Capability parity with lib/src/phy/utils/bit.c (srslte_bit_pack/unpack).
The data path keeps bits as int8 0/1 tensors; byte packing happens only at
host boundaries. Backend-free copy of the JAX package's numpy helpers.
"""

from __future__ import annotations

import numpy as np


def uint_to_bits(value: int, nbits: int) -> np.ndarray:
    """Integer -> MSB-first bit vector of fixed width."""
    return np.array([(value >> (nbits - 1 - i)) & 1 for i in range(nbits)], dtype=np.int8)


