"""Transport-block to code-block segmentation, 36.212 5.1.2.

Capability parity with lib/src/phy/fec/cbsegm.c (srslte_cbsegm). Pure
host-side arithmetic producing a frozen plan; the plan's sizes key the
compiled decode pipelines (bucketing by the 188 valid CB sizes is exactly
the reference's LUT-per-size design, SURVEY.md section 7 stage 4).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from .tables import TURBO_CB_SIZES, cb_size_ceil

#: Max code block size Z (36.212 5.1.2).
MAX_CB = 6144
#: CRC length attached per code block (CRC24B) when C > 1.
CB_CRC_LEN = 24
#: CRC length attached to the transport block (CRC24A).
TB_CRC_LEN = 24


@dataclass(frozen=True)
class CbSegm:
    """Segmentation of one transport block into turbo code blocks."""

    tbs: int          # transport block size in bits (payload, without CRC)
    c: int            # total number of code blocks
    c_plus: int       # number of code blocks of size k_plus
    c_minus: int      # number of code blocks of size k_minus
    k_plus: int       # larger CB size
    k_minus: int      # smaller CB size (0 if unused)
    f: int            # filler bits prepended to the first code block

    @property
    def cb_sizes(self) -> tuple[int, ...]:
        """Per-code-block K, in transmission order (K- blocks first)."""
        return (self.k_minus,) * self.c_minus + (self.k_plus,) * self.c_plus

    @property
    def payload_per_cb(self) -> tuple[int, ...]:
        """Data+CRC bits carried per CB (K minus filler for the first)."""
        sizes = list(self.cb_sizes)
        out = []
        for i, k in enumerate(sizes):
            out.append(k - self.f if i == 0 else k)
        return tuple(out)


def cbsegm(tbs: int) -> CbSegm:
    """Compute the CB segmentation for a TB of ``tbs`` payload bits.

    Follows 36.212 5.1.2 exactly: B = tbs + 24 (TB CRC); if B > 6144 the
    TB splits into C = ceil(B / (6144 - 24)) blocks, each gaining a CRC24B;
    block sizes K+/K- are adjacent valid interleaver sizes, F filler bits
    pad the first block.
    """
    b = tbs + TB_CRC_LEN
    if b <= MAX_CB:
        c = 1
        b_prime = b
        l = 0
    else:
        l = CB_CRC_LEN
        c = math.ceil(b / (MAX_CB - l))
        b_prime = b + c * l

    k_plus = cb_size_ceil(math.ceil(b_prime / c))
    if c == 1:
        k_minus = 0
        c_plus, c_minus = 1, 0
    else:
        # largest valid size strictly below k_plus
        smaller = [k for k in TURBO_CB_SIZES if k < k_plus]
        k_minus = smaller[-1] if smaller else 0
        delta = k_plus - k_minus
        if k_minus > 0:
            c_minus = (c * k_plus - b_prime) // delta
        else:
            c_minus = 0
        c_plus = c - c_minus

    f = c_plus * k_plus + c_minus * k_minus - b_prime
    return CbSegm(tbs=tbs, c=c, c_plus=c_plus, c_minus=c_minus,
                  k_plus=k_plus, k_minus=k_minus, f=f)
