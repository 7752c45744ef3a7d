"""Turbo-code rate matching, 36.212 5.1.4.1: sub-block interleaver +
circular buffer + bit selection, and the soft-combining inverse.

Capability parity with lib/src/phy/fec/rm_turbo.c. Same design as the
reference — precompute everything as index tables per (K, rv, E)
(rm_turbo.c:65-93) — realized as numpy index arrays driving a tensor
gather (TX) and a static placement of the repetition-summed circle (RX
soft combine into the HARQ buffer).

The receiver's path, ``derm_to_decoder``, de-rate-matches every code
block of one size straight into the turbo decoder's time-major inputs:
one launch of ``csrc/sch_derm.cu`` on the card, and on the CPU its plain
twin, ``RateMatchTurbo.rx`` per (E, F) group and
``TurboDecoder.prepare``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...utils.cuda_build import Kernel
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
#: the filler bits' LLR on the int8 lane
FILLER_LLR_INT8 = 127

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the de-rate-matching kernel's launcher (csrc/sch_derm.cu): llr, int8
#: lane, its row stride, rows, code blocks a row, the table, softbuffer in
#: and out, the prior (a row's, or the constant), the decoder's inputs,
#: bfloat16 metrics, K. A launch's shape in the launch registry is (K, rv,
#: the code blocks' (E, F, offset), rows, the LLR and metric dtypes,
#: softbuffer given, prior given)
SCH_DERM = Kernel("sch_derm", "sch_derm_launch",
                  [_P, _I32, _I64, _I32, _I32, _P, _P, _P, _P,
                   ctypes.c_float, _P, _I32, _I32])
#: ``derm_table``'s entries per code block
DERM_META = 5


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
                FILLER_LLR_INT8 if int8_lane else FILLER_LLR if filler is None
                else filler[..., None, None])
        return d_llr, acc


@functools.lru_cache(maxsize=256)
def derm_table(k: int, rv: int, cbs: tuple) -> np.ndarray:
    """The de-rate-matching kernel's table for the code blocks ``cbs``
    ((E, F, offset in the codeword) each) of size ``k`` at ``rv``, int32,
    flat: per code block (offset, E, circle length n, where its inverse
    circle starts, F), then one inverse circle per distinct F, each
    [3, 32, R] (stream, interleaver column, interleaver row): the circle
    position of d_s[row * 32 + column - ND], or -1 for a dummy, NULL or
    filler position (36.212 5.1.4.1.1-2)."""
    rm = RateMatchTurbo(k)
    d, r, nd = rm.d, rm.rows, rm.kp - rm.d
    start = len(cbs) * DERM_META
    circles, at = [], {}
    for f in sorted({f for _e, f, _off in cbs}):
        circle = _circle(k, f, rv, rm.ncb)
        inv = np.full(3 * rm.kp, -1, np.int64)
        y = circle % d + nd
        inv[(circle // d * NCOLS + y % NCOLS) * r + y // NCOLS] = \
            np.arange(len(circle))
        at[f] = (len(circle), start + 3 * rm.kp * len(circles))
        circles.append(inv)
    meta = np.asarray([(off, e, *at[f], f) for e, f, off in cbs], np.int64)
    return np.concatenate([meta.reshape(-1), *circles]).astype(np.int32)


def _on_card(t: torch.Tensor) -> bool:
    """Whether ``t`` takes the kernel (a CUDA tensor) or the twin."""
    return t.is_cuda


def derm_to_decoder(llrs, cbs: tuple, rv: int, decoder, softbuffer=None,
                    prior=None):
    """Soft de-rate-matching of the code blocks of one size straight into
    the turbo decoder's inputs.

    llrs[..., G]: codeword LLRs (float32, or int8 on the 8-bit lane);
    ``cbs``: the code blocks of size ``decoder.k``, in order, each as
    (E, F, offset in G); ``softbuffer``: [..., C, 3(K+4)] in the LLRs'
    dtype, or None; ``prior``: the filler bits' LLR over the leading dims
    (float32), or None for ``FILLER_LLR`` (127 on the int8 lane).
    -> (new softbuffer [..., C, 3(K+4)] in the LLRs' dtype, the decoder's
    inputs as ``decoder.prepare`` returns them: sys1, par1, sys2's tail
    and par2 time-major in ``decoder.metric_dtype``, decoder column
    b = row * C + j over the leading dims flattened, and (..., C)).

    On a CUDA tensor one launch of ``csrc/sch_derm.cu``; on the CPU the
    plain twin ``_derm_to_decoder_plain``."""
    if _on_card(llrs):
        return derm_to_decoder_cuda(llrs, cbs, rv, decoder, softbuffer,
                                    prior)
    return _derm_to_decoder_plain(llrs, cbs, rv, decoder, softbuffer, prior)


def _derm_to_decoder_plain(llrs, cbs: tuple, rv: int, decoder,
                           softbuffer=None, prior=None):
    """The kernel's plain twin, the chain it replaced:
    ``RateMatchTurbo.rx`` on each (E, F) group's code blocks stacked, the
    groups concatenated (they are runs of ``cbs``, so in its order), and
    ``decoder.prepare`` (the cast, the stream split, the transposes)."""
    k = decoder.k
    groups: dict = {}
    for j, (e, f, off) in enumerate(cbs):
        groups.setdefault((e, f), []).append((j, off))
    d_parts, soft_parts = [], []
    for (e, f), members in groups.items():
        seg = torch.stack([llrs[..., off:off + e] for _, off in members],
                          dim=-2)                          # [..., n_cb, E]
        sb = (torch.stack([softbuffer[..., j, :] for j, _ in members],
                          dim=-2)
              if softbuffer is not None else None)
        d_llr, ns = RateMatchTurbo(k, f=f).rx(seg, rv, softbuffer=sb,
                                              filler=prior)
        d_parts.append(d_llr)
        soft_parts.append(ns)
    if len(groups) == 1:
        return soft_parts[0], decoder.prepare(d_parts[0])
    return (torch.cat(soft_parts, dim=-2),
            decoder.prepare(torch.cat(d_parts, dim=-3)))


def derm_to_decoder_cuda(llrs, cbs: tuple, rv: int, decoder,
                         softbuffer=None, prior=None):
    """One launch of ``csrc/sch_derm.cu`` (``derm_to_decoder``'s
    arguments and results). The LLRs go in with their row stride, so a
    column slice of a wider array is not copied."""
    if not _on_card(llrs):
        raise ValueError("derm_to_decoder_cuda takes a CUDA tensor")
    if llrs.dtype not in (torch.float32, torch.int8):
        raise ValueError(f"LLRs {llrs.dtype}: float32 or int8")
    metric = decoder.metric_dtype
    if metric not in (torch.float32, torch.bfloat16):
        raise ValueError(f"metric dtype {metric}: float32 or bfloat16")
    k, c, g = decoder.k, len(cbs), llrs.shape[-1]
    if c == 0 or any(e < 1 or off < 0 or f < 0 for e, f, off in cbs) \
            or len({f for _e, f, _off in cbs}) > 2:
        # the kernel stages two inverse circles a tile: without and with
        # the filler bits of a transport block's first code block
        raise ValueError(f"code blocks {cbs}")
    if max(off + e for e, _f, off in cbs) > g:
        raise ValueError(f"code blocks {cbs} reach past the {g} LLRs")
    lead = llrs.shape[:-1]
    rows = int(np.prod(lead)) if lead else 1
    length = 3 * (k + 4)
    dev = llrs.device
    soft = torch.empty((*lead, c, length), dtype=llrs.dtype, device=dev)
    # sys1, par1, par2 and sys2's tail each start a row of K+4 (the
    # turbo kernels' inputs stay 4-byte aligned at any batch)
    out = torch.empty((3 * (k + 4) + 3, rows * c), dtype=metric,
                      device=dev)
    d = k + 4
    prepared = (out[:k + 3], out[d:d + k + 3], out[3 * d:],
                out[2 * d:2 * d + k + 3], (*lead, c))
    if rows == 0:
        return soft, prepared
    x = llrs.reshape(rows, g)
    if x.stride(-1) != 1:
        x = x.contiguous()
    sb = None
    if softbuffer is not None:
        if softbuffer.dtype != llrs.dtype \
                or tuple(softbuffer.shape) != tuple(soft.shape):
            raise ValueError(
                f"softbuffer {softbuffer.dtype} {tuple(softbuffer.shape)}, "
                f"want {llrs.dtype} {tuple(soft.shape)}")
        sb = softbuffer.contiguous()
    pr = None
    if prior is not None:
        if tuple(prior.shape) != tuple(lead):
            raise ValueError(f"prior shape {tuple(prior.shape)}, want "
                             f"{tuple(lead)}")
        pr = prior.to(torch.float32).contiguous()
    int8 = llrs.dtype == torch.int8
    tab = device_table(("sch_derm", k, rv, cbs), dev,
                       lambda: derm_table(k, rv, cbs))
    SCH_DERM.launch(
        dev, (k, rv, cbs, rows, str(llrs.dtype).removeprefix("torch."),
              str(metric).removeprefix("torch."), sb is not None,
              pr is not None),
        x.data_ptr(), int(int8), x.stride(0), rows, c, tab.data_ptr(),
        None if sb is None else sb.data_ptr(), soft.data_ptr(),
        None if pr is None else pr.data_ptr(),
        float(FILLER_LLR_INT8 if int8 else FILLER_LLR), out.data_ptr(),
        int(metric == torch.bfloat16), k)
    return soft, prepared
