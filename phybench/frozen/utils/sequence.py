"""Gold (length-31) pseudo-random sequence generation, 36.211 7.2.

Capability parity with the reference's lib/src/phy/common/sequence.c
(``srslte_sequence_LTE_pr``) and the per-channel c_init helpers scattered
through phch/. Design difference: the reference generates bit-by-bit in C
and caches per-RNTI sequences on the heap (lib/src/phy/phch/pdsch.c:616);
here sequences are generated host-side with a block-vectorized numpy LFSR
(28 new bits per slice XOR, exploiting the recurrence depth of 31) and
memoized, then shipped to device as constant arrays — scrambling on device
is then a pure sign-flip / XOR kernel (see ops/scrambling.py).
"""

from __future__ import annotations

import functools

import numpy as np

#: Gold sequence warm-up offset Nc (36.211 7.2).
NC = 1600


def _lfsr_fill(seq: np.ndarray, taps_x2: bool) -> None:
    """Fill seq[31:] in place from seq[:31] using the 36.211 recurrences.

    x1: s(n+31) = s(n+3) + s(n)            (mod 2)
    x2: s(n+31) = s(n+3) + s(n+2) + s(n+1) + s(n)

    The recurrence has depth 31, so 28 future values are computable from
    already-known entries per vectorized step.
    """
    n = len(seq)
    pos = 31
    while pos < n:
        m = min(28, n - pos)
        lo = pos - 31
        if taps_x2:
            seq[pos : pos + m] = (
                seq[lo + 3 : lo + 3 + m]
                ^ seq[lo + 2 : lo + 2 + m]
                ^ seq[lo + 1 : lo + 1 + m]
                ^ seq[lo : lo + m]
            )
        else:
            seq[pos : pos + m] = seq[lo + 3 : lo + 3 + m] ^ seq[lo : lo + m]
        pos += m


@functools.lru_cache(maxsize=4096)
def gold_sequence(c_init: int, length: int) -> np.ndarray:
    """c(n) for n in [0, length) as an int8 0/1 array (36.211 7.2)."""
    total = NC + length + 31
    x1 = np.zeros(total, dtype=np.int8)
    x1[0] = 1
    _lfsr_fill(x1, taps_x2=False)
    x2 = np.zeros(total, dtype=np.int8)
    for i in range(31):
        x2[i] = (c_init >> i) & 1
    _lfsr_fill(x2, taps_x2=True)
    return (x1[NC : NC + length] ^ x2[NC : NC + length]).astype(np.int8)


def cinit_pdsch(rnti: int, q: int, ns: int, cell_id: int) -> int:
    """PDSCH/PUSCH scrambling c_init (36.211 6.3.1 / 5.3.1).

    c_init = rnti * 2^14 + q * 2^13 + floor(ns/2) * 2^9 + cell_id
    where ns is the slot number in the frame (the reference passes
    2 * subframe, lib/src/phy/phch/pdsch.c scrambling setup).
    """
    return (rnti << 14) + (q << 13) + ((ns // 2) << 9) + cell_id


def cinit_pcfich(ns: int, cell_id: int) -> int:
    """PCFICH scrambling c_init (36.211 6.7.1)."""
    return ((ns // 2 + 1) * (2 * cell_id + 1) << 9) + cell_id


def cinit_pdcch(ns: int, cell_id: int) -> int:
    """PDCCH scrambling c_init (36.211 6.8.2)."""
    return ((ns // 2) << 9) + cell_id


def cinit_crs(ns: int, symbol: int, cell_id: int, cp_norm: bool) -> int:
    """Cell-specific reference signal c_init (36.211 6.10.1.1)."""
    n_cp = 1 if cp_norm else 0
    return (1 << 10) * (7 * (ns + 1) + symbol + 1) * (2 * cell_id + 1) + 2 * cell_id + n_cp


def prs_sequence(c_init: int, length: int) -> np.ndarray:
    """QPSK pseudo-random symbol sequence r(m) (36.211 6.10.1.1).

    r(m) = (1 - 2 c(2m))/sqrt(2) + j (1 - 2 c(2m+1))/sqrt(2); used for CRS
    and other reference signals.
    """
    c = gold_sequence(c_init, 2 * length).astype(np.float32)
    scale = np.float32(1.0 / np.sqrt(2.0))
    return (scale * ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2]))).astype(np.complex64)
