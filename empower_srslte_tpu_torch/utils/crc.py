"""LTE CRC computation (36.212 5.1.1) as GF(2) linear algebra.

Capability parity with lib/src/phy/fec/crc.c (CRC8/16/24A/24B). LTE CRCs
use a zero initial register and no output inversion, so the CRC is a
*linear* map over GF(2): for each message length K the parity matrix
H[K, L] has H[i] = x^(K-1-i+L) mod g(x), and crc(bits) = (bits @ H) mod 2
— one float32 matrix product on the tensors' device, exact because row
sums stay far below 2^24. This turns the per-CB early-stop CRC check
inside the turbo iteration loop (lib/src/phy/phch/sch.c:382) into one
batched device op.

The host bitwise paths (``compute_np``/``attach_np``) serve tests and
table generation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .device import device_table

# Generator polynomials, MSB-first including the x^L term (36.212 5.1.1).
POLY_CRC24A = 0x1864CFB
POLY_CRC24B = 0x1800063
POLY_CRC16 = 0x11021
POLY_CRC8 = 0x19B


class Crc:
    """One CRC flavor: polynomial + order, with host and tensor paths."""

    def __init__(self, poly: int, order: int, name: str):
        self.poly = poly
        self.order = order
        self.name = name

    def __repr__(self) -> str:  # pragma: no cover
        return f"Crc({self.name})"

    # --- host path ----------------------------------------------------------

    def compute_np(self, bits: np.ndarray) -> np.ndarray:
        """CRC of a 0/1 bit vector (MSB-first), returned as [order] bits."""
        reg = 0
        top = 1 << self.order
        for b in np.asarray(bits, dtype=np.int64):
            reg = (reg << 1) | int(b)
            if reg & top:
                reg ^= self.poly
        for _ in range(self.order):
            reg <<= 1
            if reg & top:
                reg ^= self.poly
        return np.array(
            [(reg >> (self.order - 1 - i)) & 1 for i in range(self.order)], dtype=np.int8
        )

    def attach_np(self, bits: np.ndarray, mask_rnti: int = 0) -> np.ndarray:
        """bits ++ crc(bits), optionally XOR-masked by an RNTI (PDCCH)."""
        crc = self.compute_np(bits)
        if mask_rnti:
            mask = np.array(
                [(mask_rnti >> (self.order - 1 - i)) & 1 for i in range(self.order)],
                dtype=np.int8,
            )
            crc = crc ^ mask
        return np.concatenate([np.asarray(bits, dtype=np.int8), crc])

    @functools.lru_cache(maxsize=1024)
    def parity_matrix(self, length: int) -> np.ndarray:
        """H[length, order] with H[i] = x^(length-1-i+order) mod g(x), int8.

        crc(bits) == (bits @ H) mod 2 for an MSB-first bit vector of the
        given length. For a message with its CRC appended,
        (msg||crc) @ H_{K+L} mod 2 == 0 iff the CRC checks.
        """
        top = 1 << self.order
        rows = np.empty((length, self.order), dtype=np.int8)
        r = 1
        for _ in range(self.order):
            r <<= 1
            if r & top:
                r ^= self.poly
        for i in range(length - 1, -1, -1):
            rows[i] = [(r >> (self.order - 1 - j)) & 1 for j in range(self.order)]
            r <<= 1
            if r & top:
                r ^= self.poly
        return rows

    # --- tensor path --------------------------------------------------------

    def parity_tensor(self, length: int, device) -> torch.Tensor:
        """parity_matrix(length) as float32 on ``device`` (cached)."""
        return device_table(
            ("crc", self.poly, self.order, length), device,
            lambda: self.parity_matrix(length).astype(np.float32))

    def compute(self, bits: torch.Tensor) -> torch.Tensor:
        """Batched CRC: bits [..., K] 0/1 -> crc [..., order] int32."""
        h = self.parity_tensor(bits.shape[-1], bits.device)
        acc = torch.matmul(bits.to(torch.float32), h)
        return torch.remainder(acc.to(torch.int32), 2)

    def check(self, bits_with_crc: torch.Tensor) -> torch.Tensor:
        """Batched check: [..., K+order] -> bool [...] (True = OK)."""
        return torch.all(self.compute(bits_with_crc) == 0, dim=-1)


CRC24A = Crc(POLY_CRC24A, 24, "24A")
CRC24B = Crc(POLY_CRC24B, 24, "24B")
CRC16 = Crc(POLY_CRC16, 16, "16")
CRC8 = Crc(POLY_CRC8, 8, "8")
