"""Turbo-code spec tables: valid CB sizes and QPP interleaver parameters.

3GPP TS 36.212 Table 5.1.3-3 (188 interleaver sizes K with quadratic
permutation polynomial coefficients f1, f2). Same constants the reference
carries in lib/src/phy/fec/tc_interl_lte.c:43-77 and generates K values for
in lib/src/phy/fec/cbsegm.c:58-155; here the K list is generated from its
arithmetic structure and the interleaver is a vectorized numpy index map
(memoized) used both for encoding gathers and extrinsic (de)interleaving
in the decoder.
"""

from __future__ import annotations

import functools

import numpy as np


def _k_sizes() -> tuple[int, ...]:
    """The 188 valid turbo interleaver sizes (36.212 Table 5.1.3-3).

    40..512 step 8, 528..1024 step 16, 1056..2048 step 32, 2112..6144
    step 64.
    """
    ks = list(range(40, 513, 8))
    ks += list(range(528, 1025, 16))
    ks += list(range(1056, 2049, 32))
    ks += list(range(2112, 6145, 64))
    assert len(ks) == 188
    return tuple(ks)


TURBO_CB_SIZES: tuple[int, ...] = _k_sizes()
MAX_CB_SIZE = TURBO_CB_SIZES[-1]  # 6144

# f1/f2 per K, 36.212 Table 5.1.3-3 (standard constants).
_F1 = (
    3, 7, 19, 7, 7, 11, 5, 11, 7, 41, 103, 15, 9, 17, 9, 21, 101, 21, 57, 23,
    13, 27, 11, 27, 85, 29, 33, 15, 17, 33, 103, 19, 19, 37, 19, 21, 21, 115,
    193, 21, 133, 81, 45, 23, 243, 151, 155, 25, 51, 47, 91, 29, 29, 247, 29,
    89, 91, 157, 55, 31, 17, 35, 227, 65, 19, 37, 41, 39, 185, 43, 21, 155,
    79, 139, 23, 217, 25, 17, 127, 25, 239, 17, 137, 215, 29, 15, 147, 29, 59,
    65, 55, 31, 17, 171, 67, 35, 19, 39, 19, 199, 21, 211, 21, 43, 149, 45,
    49, 71, 13, 17, 25, 183, 55, 127, 27, 29, 29, 57, 45, 31, 59, 185, 113,
    31, 17, 171, 209, 253, 367, 265, 181, 39, 27, 127, 143, 43, 29, 45, 157,
    47, 13, 111, 443, 51, 51, 451, 257, 57, 313, 271, 179, 331, 363, 375, 127,
    31, 33, 43, 33, 477, 35, 233, 357, 337, 37, 71, 71, 37, 39, 127, 39, 39,
    31, 113, 41, 251, 43, 21, 43, 45, 45, 161, 89, 323, 47, 23, 47, 263,
)
_F2 = (
    10, 12, 42, 16, 18, 20, 22, 24, 26, 84, 90, 32, 34, 108, 38, 120, 84, 44,
    46, 48, 50, 52, 36, 56, 58, 60, 62, 32, 198, 68, 210, 36, 74, 76, 78, 120,
    82, 84, 86, 44, 90, 46, 94, 48, 98, 40, 102, 52, 106, 72, 110, 168, 114,
    58, 118, 180, 122, 62, 84, 64, 66, 68, 420, 96, 74, 76, 234, 80, 82, 252,
    86, 44, 120, 92, 94, 48, 98, 80, 102, 52, 106, 48, 110, 112, 114, 58, 118,
    60, 122, 124, 84, 64, 66, 204, 140, 72, 74, 76, 78, 240, 82, 252, 86, 88,
    60, 92, 846, 48, 28, 80, 102, 104, 954, 96, 110, 112, 114, 116, 354, 120,
    610, 124, 420, 64, 66, 136, 420, 216, 444, 456, 468, 80, 164, 504, 172,
    88, 300, 92, 188, 96, 28, 240, 204, 104, 212, 192, 220, 336, 228, 232,
    236, 120, 244, 248, 168, 64, 130, 264, 134, 408, 138, 280, 142, 480, 146,
    444, 120, 152, 462, 234, 158, 80, 96, 902, 166, 336, 170, 86, 174, 176,
    178, 120, 182, 184, 186, 94, 190, 480,
)

_K_TO_INDEX = {k: i for i, k in enumerate(TURBO_CB_SIZES)}


def cb_size_index(k: int) -> int:
    """Index of K in the CB-size table; raises if K is not a valid size."""
    try:
        return _K_TO_INDEX[k]
    except KeyError:
        raise ValueError(f"K={k} is not a valid turbo CB size") from None


def cb_size_ceil(x: int) -> int:
    """Smallest valid CB size >= x (used by segmentation)."""
    for k in TURBO_CB_SIZES:
        if k >= x:
            return k
    raise ValueError(f"x={x} exceeds max CB size {MAX_CB_SIZE}")


def qpp_coefficients(k: int) -> tuple[int, int]:
    """(f1, f2) of K's QPP interleaver; raises if K is not a valid size."""
    idx = cb_size_index(k)
    return _F1[idx], _F2[idx]


@functools.lru_cache(maxsize=256)
def qpp_interleaver(k: int) -> np.ndarray:
    """QPP permutation pi[i] = (f1*i + f2*i^2) mod K as int32[K].

    Output relation (36.212 5.1.3.2.3): c'_i = c_{pi(i)} — i.e. position i
    of the interleaved sequence reads from pi(i) of the original.
    """
    f1, f2 = qpp_coefficients(k)
    i = np.arange(k, dtype=np.int64)
    return ((f1 * i + f2 * i * i) % k).astype(np.int32)


@functools.lru_cache(maxsize=256)
def qpp_deinterleaver(k: int) -> np.ndarray:
    """Inverse permutation: deintl[pi[i]] = i."""
    pi = qpp_interleaver(k)
    inv = np.empty_like(pi)
    inv[pi] = np.arange(k, dtype=np.int32)
    return inv
