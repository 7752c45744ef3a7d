"""Unaligned PER (X.691) primitives for the RRC codecs.

The reference hand-writes every message's bit layout across 14,399 lines
(lib/src/asn1/liblte_rrc.cc); here a small combinator engine encodes the
same 36.331 grammar declaratively (schema.py) — one engine, many message
specs. Only the UPER subset RRC Rel-8/9 needs is implemented: constrained
integers, enums + extension markers, choices, sequences with optional
bitmaps, sequence-of with constrained counts, bit/octet strings, and
unconstrained length determinants.
"""

from __future__ import annotations


class BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, n: int):
        """n-bit big-endian unsigned."""
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def put_bits(self, bits):
        self.bits.extend(int(b) & 1 for b in bits)

    def put_bytes(self, data: bytes):
        for b in data:
            self.put(b, 8)

    def to_bytes(self) -> bytes:
        n = len(self.bits)
        out = bytearray((n + 7) // 8)
        for i, b in enumerate(self.bits):
            if b:
                out[i // 8] |= 0x80 >> (i % 8)
        return bytes(out)

    def __len__(self):
        return len(self.bits)


class BitReader:
    def __init__(self, data: bytes, n_bits: int | None = None):
        self.data = data
        self.pos = 0
        self.n_bits = n_bits if n_bits is not None else 8 * len(data)

    def get(self, n: int) -> int:
        if self.pos + n > self.n_bits:
            raise ValueError("PER decode past end of message")
        v = 0
        for _ in range(n):
            byte = self.data[self.pos // 8]
            v = (v << 1) | ((byte >> (7 - self.pos % 8)) & 1)
            self.pos += 1
        return v

    def get_bytes(self, n: int) -> bytes:
        return bytes(self.get(8) for _ in range(n))

    @property
    def remaining(self) -> int:
        return self.n_bits - self.pos


def width(lo: int, hi: int) -> int:
    """Bits for a constrained whole number (X.691 10.5.3)."""
    n = hi - lo + 1
    if n <= 1:
        return 0
    return (n - 1).bit_length()


def put_length_det(w: BitWriter, n: int):
    """Unconstrained length determinant (X.691 10.9, <16384 only)."""
    if n < 128:
        w.put(n, 8)
    elif n < 16384:
        w.put(0x8000 | n, 16)
    else:
        raise ValueError("length >= 16384 not supported")


def get_length_det(r: BitReader) -> int:
    first = r.get(8)
    if first < 128:
        return first
    if first & 0xC0 == 0x80:
        return ((first & 0x3F) << 8) | r.get(8)
    raise ValueError("fragmented lengths not supported")
