"""Batched iterative turbo decoder over the hand-written constituent kernels.

Capability parity with lib/src/phy/fec/turbodecoder*.c: max-log-MAP with a
beta backward sweep then an alpha+LLR forward sweep, windowed, with
renormalization, and the CRC early stop between iterations (sch.c:382).

Counterpart of the JAX package's ``TurboDecoder``
(empower_srslte_tpu/ops/fec/turbo_decoder.py:293-639): the unit of work
is a batch of equal-size code blocks ``[..., 3, K+4]`` whose trellis is
cut into K/l windows decoded in parallel. Three constituent decoders:

* ``impl="nii"`` (the JAX ``"pallas2"`` path, :319-506): each window is
  initialized from its neighbours' boundary metrics of the previous
  half-iteration (NII, ops/fec/turbo_nii.py); iterations run in
  ``decode_tm``.
* ``impl="windowed"`` (the JAX ``"pallas"`` path, :539-639): each window
  trains over ``overlap`` steps on either side (srsLTE's
  turbodecoder_win.h, ops/fec/turbo_win.py); iterations run in
  ``decode_win``.
* ``impl="xla"`` (the JAX XLA scans, :63-296): the same v1 iteration loop
  over plain PyTorch sweeps, ``_map_decode`` (the full trellis, every
  beta stored) without a window and ``_windowed_map_decode`` (overlap
  training, ``PAD_LLR`` padding) with one. They loop over trellis steps
  in Python, a few tensor operations per step, and are not the
  ``turbo_win`` kernel's twin: the two pad and renormalize differently.

At a K without a window the windowed decoder runs the NII kernel over one
window of l = K, as ``"nii"`` does; JAX's ``run_map`` takes its full sweep
there. The two agree (bits equal, LLRs within 0.1).

Extrinsics move between the two constituents through the QPP
(de)interleaver as row gathers of time-major [K, B] arrays.

Metric precision (``dtype``, the JAX field and values): ``"auto"``
decodes in bfloat16 on the kernel paths, ``"nii"`` and ``"windowed"``
with a window, exactly where the JAX package's ``"auto"`` does on its
accelerator (its ``_decode_nii`` and the v1 kernel path), and in float32
otherwise (``"xla"``, and a K without a window, where JAX runs its
float32 full sweep). The rule is the same on every device, so the CPU
twins compute what the card computes. The iteration glue runs in the
resolved dtype, in JAX's order; ``decode`` returns LLRs in it.

LLR convention: positive LLR <=> bit 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...runtime import trace
from ...utils.device import device_table
from .tables import qpp_deinterleaver, qpp_interleaver
from .turbo_encoder import trellis
from .turbo_nii import map_decode_nii
from .turbo_win import DEFAULT_OVERLAP, map_decode_win

NEG_INF = -1e30
#: Padding LLR of the XLA windowed sweep's out-of-trellis training steps
#: (JAX turbo_decoder.py:147-156): a strong "bit 0" prior keeps the
#: terminated metric {state 0: 0, others: -inf} invariant through them.
PAD_LLR = 1e5


def _all_pass(any_fails: torch.Tensor) -> bool:
    """The early-stop read: the device's one-element "some code block
    fails" flag on the host. Its range ``turbo.stop_read`` holds the
    device-to-host read alone (the host waits there for the card to
    drain its queue); the flag is computed before it."""
    with trace.span("turbo.stop_read"):
        return not bool(any_fails)


def _perm(name: str, k: int, device):
    fn = qpp_interleaver if name == "pi" else qpp_deinterleaver
    return device_table((name, k), device, lambda: fn(k).astype(np.int64))


def parity_rows_interleaved(crc, k: int, device) -> torch.Tensor:
    """[order, K] float32: the CRC parity matrix with its rows permuted
    into the QPP-interleaved domain and transposed, so a syndrome is one
    product with the interleaved-domain hard bits [K, B] (row q <->
    natural bit pi[q])."""
    return device_table(
        ("crc_int", crc.poly, crc.order, k), device,
        lambda: np.ascontiguousarray(
            crc.parity_matrix(k).astype(np.float32)[qpp_interleaver(k)].T))


def _sweep_tables(device, dtype=torch.float32):
    """Trellis wiring of the plain sweeps, both inputs stacked (u-major,
    16 rows): next states and previous states [16] int64, and the signs
    of the systematic / parity terms of the forward and backward branch
    metrics [16, 1] in the metric ``dtype`` (exact: +-1)."""
    def build():
        t = trellis()
        su = np.repeat([1.0, -1.0], 8)[:, None]
        sign = lambda par: (1.0 - 2.0 * par.T.reshape(-1))[:, None]
        return dict(ns=t.next_state.T.reshape(-1).astype(np.int64),
                    ps=t.prev_state.T.reshape(-1).astype(np.int64),
                    su=su.astype(np.float32),
                    sp=sign(t.parity).astype(np.float32),
                    spp=sign(t.prev_parity).astype(np.float32))
    tb = {k: device_table(("turbo_sweep", k), device, lambda k=k: build()[k])
          for k in ("ns", "ps", "su", "sp", "spp")}
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in tb.items()}


def _renorm(m16: torch.Tensor) -> torch.Tensor:
    """max over the input bit of [16, B] candidates -> [8, B], minus the
    max over states."""
    new = torch.amax(m16.view(2, 8, -1), dim=0)
    return new - torch.amax(new, dim=0, keepdim=True)


def _beta_sweep(lsa, lp, beta0, tb):
    """Backward sweep over rows T-1..0 of lsa/lp [T, B] from beta0 [8, B]:
    -> betas [T, 8, B], betas[k] the metric entering step k from above."""
    betas = [None] * lsa.shape[0]
    beta = beta0
    for k in range(lsa.shape[0] - 1, -1, -1):
        betas[k] = beta
        g = 0.5 * (tb["su"] * lsa[k] + tb["sp"] * lp[k])
        beta = _renorm(beta[tb["ns"]] + g)
    return torch.stack(betas)


def _alpha_sweep(lsa, lp, betas, alpha0, tb, skip: int = 0):
    """Forward sweep over lsa/lp [T, B] from alpha0 [8, B], emitting the
    a-posteriori LLR of every row from ``skip`` on against betas
    [T - skip, 8, B] -> llr [T - skip, B] (the first ``skip`` rows only
    train alpha)."""
    llrs = []
    alpha = alpha0
    for k in range(lsa.shape[0]):
        if k >= skip:
            g = 0.5 * (tb["su"] * lsa[k] + tb["sp"] * lp[k])
            tot = (alpha.repeat(2, 1) + g + betas[k - skip][tb["ns"]]) \
                .view(2, 8, -1)
            llrs.append(torch.amax(tot[0], dim=0)
                        - torch.amax(tot[1], dim=0))
        g = 0.5 * (tb["su"] * lsa[k] + tb["spp"] * lp[k])
        alpha = _renorm(alpha[tb["ps"]] + g)
    return torch.stack(llrs)


def _edge_metric(device, dtype=torch.float32) -> torch.Tensor:
    """The terminated state metric {state 0: 0, others: NEG_INF} [8]."""
    return device_table("turbo_edge", device, lambda: np.asarray(
        [0.0] + [NEG_INF] * 7, np.float32)).to(dtype)


def _map_decode(lsa, lp, n_tail: int, init_alpha, init_beta):
    """One max-log-MAP constituent decode over a full trellis (the JAX
    package's XLA full sweep, turbo_decoder.py:63-145).

    lsa [T, B] systematic + a-priori LLRs (tail rows: systematic only),
    lp [T, B] parity LLRs, ``n_tail`` trailing termination steps (no LLR
    output), init_alpha / init_beta [8] initial state metrics.
    Returns llr_out [T - n_tail, B], the a-posteriori LLRs.
    """
    tb = _sweep_tables(lsa.device, lsa.dtype)
    b = lsa.shape[1]
    betas = _beta_sweep(lsa, lp, init_beta[:, None].expand(8, b), tb)
    llrs = _alpha_sweep(lsa, lp, betas, init_alpha[:, None].expand(8, b),
                        tb)
    return llrs[:lsa.shape[0] - n_tail] if n_tail else llrs


def _prepare_windows(lsa, lp, k: int, overlap: int, window: int,
                     halo=None):
    """The windowed sweeps' inputs, time-major with windows in lanes
    (lane = w * B + b): lsa_a, lp_a [O+L, W*B] (alpha: O training rows
    before each window), lsa_b, lp_b [L+O, W*B] (beta: O after).
    lsa/lp are [T, B] with T = K + 3, or the K local rows of a trellis
    slice (parallel/turbo_sp.py). Out-of-trellis rows hold systematic
    PAD_LLR and parity 0, unless ``halo`` = (lead_lsa, lead_lp, trail_lsa,
    trail_lp), each [O+3, B], gives the neighbours' real rows."""
    b = lsa.shape[1]
    if k % window or not 3 <= overlap <= window:
        raise ValueError(f"K {k}, window {window}, overlap {overlap}")
    w, l, o = k // window, window, overlap
    if halo is None:
        pad_s = lsa.new_full((o + 3, b), PAD_LLR)
        pad_p = lp.new_zeros((o + 3, b))
        halo = (pad_s, pad_p, pad_s, pad_p)
    lead_s, lead_p, trail_s, trail_p = halo
    lsa_pd = torch.cat([lead_s, lsa, trail_s])             # shift +O+3
    lp_pd = torch.cat([lead_p, lp, trail_p])
    base = np.arange(w)[:, None] * l
    idx_a = base + np.arange(-o, l)[None, :] + (o + 3)     # [W, O+L]
    idx_b = base + np.arange(0, l + o)[None, :] + (o + 3)  # [W, L+O]

    def gather_tm(x, idx, name):
        t = device_table(("turbo_win_idx", name, k, l, o), x.device,
                         lambda: idx.reshape(-1).astype(np.int64))
        return x[t].view(w, idx.shape[1], b).transpose(0, 1) \
            .reshape(idx.shape[1], w * b)

    return (gather_tm(lsa_pd, idx_a, "a"), gather_tm(lp_pd, idx_a, "a"),
            gather_tm(lsa_pd, idx_b, "b"), gather_tm(lp_pd, idx_b, "b"))


def _windowed_map_decode(lsa, lp, k: int, overlap: int, window: int,
                         init_alpha, init_beta, halo=None,
                         boundary=(True, True)):
    """Windowed max-log-MAP with overlap training (the JAX package's XLA
    windowed scan, turbo_decoder.py:147-296).

    lsa/lp [T, B] with T = K + 3 (payload + termination). The payload is
    cut into W = K / window windows riding the lane axis; each window's
    alpha (beta) recursion trains over ``overlap`` leading (trailing)
    steps from uniform metrics. Window 0's alpha and the last window's
    beta start from init_alpha / init_beta [8], carried through their
    padded training rows by the PAD_LLR construction; the last window's
    beta training covers the 3 real termination rows.

    Sequence-parallel decoding (parallel/turbo_sp.py) passes a slice of K
    rows with ``halo``, the neighbours' rows in place of the padding
    (``_prepare_windows``); ``boundary`` = (first, last) False starts that
    end's window from uniform metrics instead of init_alpha / init_beta,
    as an interior slice does. Returns llr_out [K, B].
    """
    b = lsa.shape[1]
    w, l, o = k // window, window, overlap
    tb = _sweep_tables(lsa.device, lsa.dtype)
    lsa_a, lp_a, lsa_b, lp_b = _prepare_windows(lsa, lp, k, o, l, halo)
    zeros = torch.zeros((8, w - 1, b), dtype=lsa.dtype, device=lsa.device)
    edge = lambda m, exact: (m if exact else torch.zeros_like(m))[
        :, None, None].expand(8, 1, b)
    alpha0 = torch.cat([edge(init_alpha, boundary[0]), zeros], 1) \
        .reshape(8, w * b)
    beta0 = torch.cat([zeros, edge(init_beta, boundary[1])], 1) \
        .reshape(8, w * b)
    betas = _beta_sweep(lsa_b, lp_b, beta0, tb)[:l]
    llrs = _alpha_sweep(lsa_a, lp_a, betas, alpha0, tb, skip=o)  # [L, W*B]
    return llrs.view(l, w, b).transpose(0, 1).reshape(k, b)


def map_decode_xla(lsa, lp, *, k: int, l: int | None,
                   o: int = DEFAULT_OVERLAP):
    """The XLA constituent decode as ``decode_win`` calls it: lsa/lp
    [K+3, B] -> a-posteriori LLRs [K, B], from the terminated state at
    both trellis ends; the full sweep when ``l`` is None, else the
    windowed sweep with windows of ``l`` and overlap ``o``."""
    edge = _edge_metric(lsa.device, lsa.dtype)
    if l is None:
        return _map_decode(lsa, lp, 3, edge, edge)
    return _windowed_map_decode(lsa, lp, k, o, l, edge, edge)


@dataclass(frozen=True)
class TurboDecoder:
    """Iterative turbo decoder for one CB size K.

    ``window``: trellis window length l (K % l == 0); None decodes the
    whole trellis: as one NII window (``"nii"`` and ``"windowed"``), or by
    the full sweep ``_map_decode`` (``"xla"``, as the JAX package does).
    ``impl``: ``"nii"``, ``"windowed"`` or ``"xla"``;
    ``overlap``: the windowed decoders' training length;
    ``dtype``: the metric precision, ``"auto"`` (bfloat16 for ``"nii"``
    and ``"windowed"`` with a window, float32 otherwise: see
    ``metric_dtype``), ``"float32"`` or ``"bfloat16"``.
    """

    k: int
    iterations: int = 5
    window: int | None = None
    impl: str = "nii"
    overlap: int = DEFAULT_OVERLAP
    dtype: str = "auto"

    def __post_init__(self):
        if self.impl not in ("nii", "windowed", "xla"):
            raise ValueError(
                f"impl {self.impl!r}: 'nii', 'windowed' or 'xla'")
        if self.dtype not in ("auto", "float32", "bfloat16"):
            raise ValueError(
                f"dtype {self.dtype!r}: 'auto', 'float32' or 'bfloat16'")

    @property
    def metric_dtype(self) -> torch.dtype:
        """The resolved metric dtype. ``"auto"`` is bfloat16 exactly where
        the JAX package's ``"auto"`` decodes in bfloat16 on its
        accelerator: a kernel decoder (``"nii"``, ``"windowed"``) with a
        window (JAX turbo_decoder.py:453, :528-533); float32 for
        ``"xla"`` and for a K without a window (JAX's full sweep)."""
        if self.dtype == "auto":
            kernel = self.impl in ("nii", "windowed") \
                and self.window is not None
            return torch.bfloat16 if kernel else torch.float32
        return getattr(torch, self.dtype)

    def _split_streams(self, d_llr):
        """d_llr[..., 3, K+4] -> per-constituent (sys1, par1, sys2_tail,
        par2); sys1/par1/par2 are [..., K+3], sys2_tail [..., 3].

        Tail de-permutation per 36.212 5.1.3.2.2 (see turbo_encoder).
        """
        k = self.k
        d0, d1, d2 = d_llr[..., 0, :], d_llr[..., 1, :], d_llr[..., 2, :]
        sys1 = torch.cat([d0[..., :k], d0[..., k:k + 1], d2[..., k:k + 1],
                          d1[..., k + 1:k + 2]], dim=-1)
        par1 = torch.cat([d1[..., :k], d1[..., k:k + 1], d0[..., k + 1:k + 2],
                          d2[..., k + 1:k + 2]], dim=-1)
        sys2_tail = torch.cat([d0[..., k + 2:k + 3], d2[..., k + 2:k + 3],
                               d1[..., k + 3:k + 4]], dim=-1)
        par2 = torch.cat([d2[..., :k], d1[..., k + 2:k + 3],
                          d0[..., k + 3:k + 4], d2[..., k + 3:k + 4]], dim=-1)
        return sys1, par1, sys2_tail, par2

    def decode_tm(self, sys, par1, par2, ut1, pt1, ut2, pt2, *, crc=None,
                  map_decode=map_decode_nii):
        """NII iteration driver on time-major arrays.

        sys/par1/par2 [K, B]; tails [3, B]. With ``crc`` (a Crc covering
        the K bits) iterate until every code block of the batch passes or
        ``iterations`` is reached; the all-pass flag is one device
        reduction, read once per iteration. Without it, run a fixed count.
        ``map_decode`` is the constituent decoder: the kernel wrapper, or
        its plain twin when the two are compared on the card.

        Returns (llr_int [K, B] interleaved-domain a-posteriori LLRs,
        n_iterations); natural order is ``llr_int[qpp_deinterleaver(k)]``.
        """
        k = self.k
        l = self.window or k
        dev = sys.device
        pi = _perm("pi", k, dev)
        pinv = _perm("pinv", k, dev)
        b = sys.shape[1]
        w_count = k // l
        zst = torch.zeros((w_count + 1, 8, b), dtype=sys.dtype, device=dev)
        sys_int = sys[pi]
        p_int = None if crc is None else parity_rows_interleaved(crc, k, dev)

        ext2 = torch.zeros_like(sys)
        a1 = b1 = a2 = b2 = zst
        n_it = 0
        while True:
            ext1, a1, b1 = map_decode(sys, par1, ut1, pt1, a1, b1, l=l,
                                          apr=ext2)
            ext1_int = ext1[pi]
            ext2i, a2, b2 = map_decode(sys_int, par2, ut2, pt2, a2, b2,
                                           l=l, apr=ext1_int)
            n_it += 1
            llr_int = sys_int + ext1_int + ext2i
            if n_it >= self.iterations:
                break
            if p_int is not None:
                bits = (llr_int < 0).to(torch.float32)
                snd = torch.remainder(torch.mm(p_int, bits), 2.0)
                if _all_pass(torch.any(snd != 0.0)):
                    break
            ext2 = ext2i[pinv]
        return llr_int, n_it

    def decode_win(self, sys1, par1, sys2_tail, par2, *, crc=None,
                   map_decode=map_decode_win):
        """Windowed-overlap iteration loop on time-major arrays (the JAX
        package's v1 loop, turbo_decoder.py:558-635); the XLA decoder
        without a window runs the full sweep ``_map_decode``.

        sys1/par1/par2 [K+3, B] (payload plus termination rows),
        sys2_tail [3, B]. Per iteration: ``lsa1 = sys + ext2``,
        ``ext1 = map(lsa1, par1) - lsa1``; ``lsa2 = (sys + ext1)[pi]``,
        ``ext2 = (map(lsa2, par2) - lsa2)[pinv]``. With ``crc`` iterate
        until every code block's natural-order hard bits pass (one host
        read per iteration) or ``iterations`` is reached.

        Returns (llr [K, B] natural-order a-posteriori LLRs, n_iterations).
        """
        k = self.k
        dev = sys1.device
        pi = _perm("pi", k, dev)
        pinv = _perm("pinv", k, dev)
        run = lambda lsa_pay, tail, par: map_decode(
            torch.cat([lsa_pay, tail]), par, k=k, l=self.window,
            o=self.overlap)
        h = None if crc is None else crc.parity_tensor(k, dev).t()
        sys_pay = sys1[:k]
        ext2 = torch.zeros_like(sys_pay)
        n_it = 0
        while True:
            lsa1 = sys_pay + ext2
            ext1 = run(lsa1, sys1[k:], par1) - lsa1
            lsa2 = (sys_pay + ext1)[pi]
            llr2 = run(lsa2, sys2_tail, par2)
            n_it += 1
            ext2 = (llr2 - lsa2)[pinv]
            llr = llr2[pinv]
            if n_it >= self.iterations:
                break
            if h is not None:
                bits = (llr < 0).to(torch.float32)
                snd = torch.remainder(torch.mm(h, bits), 2.0)
                if _all_pass(torch.any(snd != 0.0)):
                    break
        return llr, n_it

    def prepare(self, d_llr):
        """d_llr[..., 3, K+4] -> the decoder's inputs (sys1_tm, par1_tm,
        sys2_tail_tm, par2_tm, lead): the input (float32, bfloat16 or an
        int8 lane's LLRs, exact in bfloat16) cast to ``metric_dtype``,
        split into the constituents' streams (``_split_streams``) and
        made time-major: sys1/par1/par2 [K+3, B], sys2's tail [3, B],
        B = prod(lead) code blocks, ``lead`` = d_llr's leading dims.
        ``rate_matching.derm_to_decoder`` gives the same from the LLRs."""
        d_llr = d_llr.to(self.metric_dtype)
        sys1, par1, sys2_tail, par2 = self._split_streams(d_llr)
        lead = sys1.shape[:-1]
        b = int(np.prod(lead)) if lead else 1
        tm = lambda x: x.reshape(b, x.shape[-1]).t().contiguous()
        return tm(sys1), tm(par1), tm(sys2_tail), tm(par2), lead

    def decode_prepared(self, sys1_tm, par1_tm, sys2_tail_tm, par2_tm, lead,
                        crc=None, iters_out: list | None = None,
                        map_decode=None):
        """Decode the prepared inputs (``prepare``) -> (bits[*lead, K]
        int8, llr[*lead, K]), the LLRs in ``metric_dtype``.
        ``iters_out`` (a list) receives the iteration count.
        ``map_decode`` replaces the constituent kernel wrapper of ``impl``
        (with its plain twin, to compare the two)."""
        k = self.k
        if self.impl == "xla" or (self.impl == "windowed"
                                  and self.window is not None):
            default = map_decode_win if self.impl == "windowed" \
                else map_decode_xla
            llr, n_it = self.decode_win(
                sys1_tm, par1_tm, sys2_tail_tm, par2_tm, crc=crc,
                map_decode=map_decode or default)
        else:
            llr_int, n_it = self.decode_tm(
                sys1_tm[:k], par1_tm[:k], par2_tm[:k], sys1_tm[k:],
                par1_tm[k:], sys2_tail_tm, par2_tm[k:], crc=crc,
                map_decode=map_decode or map_decode_nii)
            llr = llr_int[_perm("pinv", k, sys1_tm.device)]
        if iters_out is not None:
            iters_out.append(n_it)
        llr = llr.t().reshape(*lead, k)
        return (llr < 0).to(torch.int8), llr

    def decode(self, d_llr, crc=None, iters_out: list | None = None,
               map_decode=None):
        """Decode d_llr[..., 3, K+4] -> (bits[..., K] int8, llr[..., K]):
        ``decode_prepared(*prepare(d_llr))``.

        Leading dims are batch. The input (float32, bfloat16 or an int8
        lane's LLRs, exact in bfloat16) is cast to ``metric_dtype``, and
        the LLRs come back in it. ``iters_out`` (a list) receives the
        iteration count. ``map_decode`` replaces the constituent kernel
        wrapper of ``impl`` (with its plain twin, to compare the two).
        """
        return self.decode_prepared(*self.prepare(d_llr), crc=crc,
                                    iters_out=iters_out,
                                    map_decode=map_decode)
