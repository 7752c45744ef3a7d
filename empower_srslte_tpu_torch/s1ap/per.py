"""Aligned PER (X.691) primitives for the S1AP codecs.

The concrete layout mirrors what the reference's generated codec emits
(lib/src/asn1/liblte_s1ap.cc): 16-bit IE ids + 2-bit criticality +
byte-align + length determinant; large-range integers as a 2-bit
octet-count + aligned octets (liblte_s1ap.cc:5286-5297); open types as
length-prefixed byte blobs.
"""

from __future__ import annotations


class AWriter:
    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.bits.append((value >> i) & 1)

    def align(self):
        while len(self.bits) % 8:
            self.bits.append(0)

    def put_bytes(self, data: bytes):
        self.align()
        for b in data:
            self.put(b, 8)

    def put_length(self, n: int):
        """Length determinant (aligned; liblte layout)."""
        self.align()
        if n < 128:
            self.put(n, 8)
        elif n < 16384:
            self.put(0x8000 | n, 16)
        else:
            raise ValueError("length >= 16384 unsupported")

    def put_open(self, data: bytes):
        self.put_length(len(data))
        self.put_bytes(data)

    def put_big_int(self, v: int):
        """Unconstrained-ish integer (range > 64K): 2-bit octet count,
        align, value octets (liblte_s1ap.cc enb_ue_s1ap_id layout)."""
        n_octets = max(1, (v.bit_length() + 7) // 8)
        self.put(n_octets - 1, 2)
        self.align()
        self.put(v, 8 * n_octets)

    def to_bytes(self) -> bytes:
        self.align()
        out = bytearray(len(self.bits) // 8)
        for i, b in enumerate(self.bits):
            if b:
                out[i // 8] |= 0x80 >> (i % 8)
        return bytes(out)


class AReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.n_bits = 8 * len(data)

    def get(self, n: int) -> int:
        if self.pos + n > self.n_bits:
            raise ValueError("aligned-PER decode past end")
        v = 0
        for _ in range(n):
            v = (v << 1) | ((self.data[self.pos // 8]
                             >> (7 - self.pos % 8)) & 1)
            self.pos += 1
        return v

    def align(self):
        if self.pos % 8:
            self.pos += 8 - self.pos % 8

    def get_bytes(self, n: int) -> bytes:
        self.align()
        return bytes(self.get(8) for _ in range(n))

    def get_length(self) -> int:
        self.align()
        first = self.get(8)
        if first < 128:
            return first
        if first & 0xC0 == 0x80:
            return ((first & 0x3F) << 8) | self.get(8)
        raise ValueError("fragmented length unsupported")

    def get_open(self) -> bytes:
        return self.get_bytes(self.get_length())

    def get_big_int(self) -> int:
        n_octets = self.get(2) + 1
        self.align()
        return self.get(8 * n_octets)

    @property
    def remaining(self) -> int:
        return self.n_bits - self.pos
