"""Bit pack/unpack helpers (host numpy).

Capability parity with lib/src/phy/utils/bit.c (srslte_bit_pack/unpack).
The data path keeps bits as int8 0/1 tensors; byte packing happens only at
host boundaries. Backend-free copy of the JAX package's numpy helpers.
"""

from __future__ import annotations

import numpy as np


def unpack_bytes(data: np.ndarray, nbits: int | None = None) -> np.ndarray:
    """uint8 bytes -> MSB-first 0/1 int8 bits."""
    data = np.asarray(data, dtype=np.uint8)
    bits = np.unpackbits(data)
    if nbits is not None:
        bits = bits[:nbits]
    return bits.astype(np.int8)


def pack_bits(bits: np.ndarray) -> np.ndarray:
    """MSB-first 0/1 bits -> uint8 bytes (zero-padded to a byte boundary)."""
    bits = np.asarray(bits, dtype=np.uint8)
    return np.packbits(bits)


def uint_to_bits(value: int, nbits: int) -> np.ndarray:
    """Integer -> MSB-first bit vector of fixed width."""
    return np.array([(value >> (nbits - 1 - i)) & 1 for i in range(nbits)], dtype=np.int8)


def bits_to_uint(bits: np.ndarray) -> int:
    """MSB-first bit vector -> integer."""
    out = 0
    for b in np.asarray(bits).astype(np.int64):
        out = (out << 1) | int(b)
    return out
