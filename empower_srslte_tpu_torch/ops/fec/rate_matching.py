"""Turbo-code rate matching, 36.212 5.1.4.1: sub-block interleaver +
circular buffer + bit selection, and the soft-combining inverse.

Capability parity with lib/src/phy/fec/rm_turbo.c. Same design as the
reference — precompute everything as index tables per (K, rv, E)
(rm_turbo.c:65-93) — realized as numpy index arrays driving a tensor
gather (TX) and a static placement of the repetition-summed circle (RX
soft combine into the HARQ buffer).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils.device import device_table
from .tables import cb_size_index

#: Sub-block interleaver column count and permutation (36.212 Table 5.1.4-1).
NCOLS = 32
PERM = np.array(
    [0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
     1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31],
    dtype=np.int64,
)

_NULL = -1
#: known-zero LLR pinned on filler positions (llr > 0 <=> bit 0) for a
#: float32 decode; a bfloat16 decode takes a prior scaled to the data
#: (models/sch.py ``filler_prior``)
FILLER_LLR = 1e4


@functools.lru_cache(maxsize=512)
def _wmap(k: int, f: int) -> np.ndarray:
    """Circular-buffer map: w position -> flat index into d[3, K+4], or -1.

    Three sub-block interleavers (streams 0/1 row-column, stream 2 the
    +1-shifted variant) over inputs padded with ND leading NULLs, the
    first ``f`` filler positions of streams 0 and 1 also NULL (36.212
    5.1.3.2 / 5.1.4.1.1), then streams 1 and 2 interlaced after stream 0
    (5.1.4.1.2).
    """
    d = k + 4
    r = -(-d // NCOLS)
    kp = r * NCOLS
    nd = kp - d
    j = np.arange(kp, dtype=np.int64)
    y01 = (j % r) * NCOLS + PERM[j // r]
    y2 = (PERM[j // r] + NCOLS * (j % r) + 1) % kp

    def to_d(y: np.ndarray, stream: int, null_filler: bool) -> np.ndarray:
        pos = y - nd
        out = np.where(pos >= 0, stream * d + pos, _NULL)
        if null_filler and f > 0:
            out = np.where((pos >= 0) & (pos < f), _NULL, out)
        return out

    w = np.empty(3 * kp, dtype=np.int64)
    w[:kp] = to_d(y01, 0, True)
    w[kp::2] = to_d(y01, 1, True)
    w[kp + 1::2] = to_d(y2, 2, False)
    return w


@functools.lru_cache(maxsize=2048)
def _circle(k: int, f: int, rv: int, ncb: int) -> np.ndarray:
    """One full circle of useful (non-NULL) circular-buffer reads starting
    at k0(rv), as flat d[3, K+4] indices (36.212 5.1.4.1.2)."""
    d = k + 4
    r = -(-d // NCOLS)
    w = _wmap(k, f)[:ncb]
    k0 = r * (2 * (-(-ncb // (8 * r))) * rv + 2)
    valid = w[(k0 + np.arange(ncb)) % ncb]
    return valid[valid != _NULL]


@functools.lru_cache(maxsize=2048)
def _selection(k: int, f: int, rv: int, e: int, ncb: int) -> np.ndarray:
    """TX bit-selection map: e output positions -> flat d[3, K+4] indices."""
    circle = _circle(k, f, rv, ncb)
    reps = -(-e // len(circle))
    return np.tile(circle, reps)[:e]


class RateMatchTurbo:
    """Rate (de)matcher for one code-block size.

    k:   turbo interleaver size (valid CB size)
    f:   filler bits in this CB (first CB of a segmented TB)
    ncb: soft-buffer-limited circular buffer length (default Kw = 3*Kp)
    """

    def __init__(self, k: int, f: int = 0, ncb: int | None = None):
        cb_size_index(k)
        self.k = k
        self.d = k + 4
        self.rows = -(-self.d // NCOLS)
        self.kp = self.rows * NCOLS
        self.kw = 3 * self.kp
        self.ncb = self.kw if ncb is None else ncb
        self.f = f

    def tx_indices(self, rv: int, e: int) -> np.ndarray:
        return _selection(self.k, self.f, rv, e, self.ncb)

    def tx(self, d_streams, rv: int, e: int):
        """d[..., 3, K+4] -> [..., E] (gather)."""
        idx = device_table(("rm_tx", self.k, self.f, rv, e, self.ncb),
                           d_streams.device,
                           lambda: self.tx_indices(rv, e))
        flat = d_streams.reshape(*d_streams.shape[:-2], 3 * self.d)
        return flat[..., idx]

    def rx(self, llr_e, rv: int, softbuffer=None, filler=None):
        """Soft de-rate-matching with HARQ combining.

        llr_e[..., E] -> (d_llr[..., 3, K+4], new softbuffer[..., 3*(K+4)]).
        ``softbuffer`` carries combined LLRs across retransmissions (the
        reference's srslte_softbuffer_rx_t, softbuffer.c); None for a
        first transmission. Filler positions come out as strong known-zero
        LLRs: ``filler`` (a tensor over the leading dims of ``llr_e`` but
        its code block axis), else ``FILLER_LLR``. The prior enters
        ``d_llr`` only, never the softbuffer.

        int8 LLRs take the 8-bit lane (rm_turbo.c:378-905): the repetition
        sum and the HARQ add run in int32 and saturate back to +-127 (torch
        int8 arithmetic would wrap silently); the softbuffer stays int8 and
        the filler prior is 127.
        """
        e = llr_e.shape[-1]
        circle_np = _circle(self.k, self.f, rv, self.ncb)
        circle = device_table(("rm_circle", self.k, self.f, rv, self.ncb),
                              llr_e.device, lambda: circle_np)
        n = len(circle_np)
        reps = -(-e // n)
        pad = reps * n - e
        int8_lane = llr_e.dtype == torch.int8
        if int8_lane:
            llr_e = llr_e.to(torch.int32)
        if pad:
            llr_e = torch.nn.functional.pad(llr_e, (0, pad))
        summed = llr_e.reshape(*llr_e.shape[:-1], reps, n).sum(
            -2, dtype=llr_e.dtype)
        acc = llr_e.new_zeros((*llr_e.shape[:-1], 3 * self.d))
        acc[..., circle] = summed
        if softbuffer is not None:
            acc = acc + softbuffer.to(acc.dtype)
        if int8_lane:
            acc = torch.clamp(acc, -127, 127).to(torch.int8)
        d_llr = acc.reshape(*acc.shape[:-1], 3, self.d)
        if self.f > 0:
            d_llr = d_llr.clone()
            d_llr[..., 0, :self.f] = (
                127 if int8_lane else FILLER_LLR if filler is None
                else filler[..., None, None])
        return d_llr, acc
