"""Batched iterative turbo decoder over the hand-written constituent kernels.

Capability parity with lib/src/phy/fec/turbodecoder*.c: max-log-MAP with a
beta backward sweep then an alpha+LLR forward sweep, windowed, with
renormalization, and the CRC early stop between iterations (sch.c:382).

Counterpart of the JAX package's ``TurboDecoder``
(empower_srslte_tpu/ops/fec/turbo_decoder.py:293-639): the unit of work
is a batch of equal-size code blocks ``[..., 3, K+4]`` whose trellis is
cut into K/l windows decoded in parallel. Two constituent decoders:

* ``impl="nii"`` (the JAX ``"pallas2"`` path, :319-506): each window is
  initialized from its neighbours' boundary metrics of the previous
  half-iteration (NII, ops/fec/turbo_nii.py); iterations run in
  ``decode_tm``.
* ``impl="windowed"`` (the JAX ``"pallas"`` path, :539-639): each window
  trains over ``overlap`` steps on either side (srsLTE's
  turbodecoder_win.h, ops/fec/turbo_win.py); iterations run in
  ``decode_win``.

Extrinsics move between the two constituents through the QPP
(de)interleaver as row gathers of time-major [K, B] arrays. Metrics are
float32.

LLR convention: positive LLR <=> bit 0.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...utils.device import device_table
from .tables import qpp_deinterleaver, qpp_interleaver
from .turbo_nii import map_decode_nii
from .turbo_win import DEFAULT_OVERLAP, map_decode_win


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


@dataclass(frozen=True)
class TurboDecoder:
    """Iterative turbo decoder for one CB size K.

    ``window``: trellis window length l (K % l == 0); None decodes the
    whole trellis as one window (NII only: the windowed decoder raises
    ``NotImplementedError`` there, where the JAX package falls back to
    its XLA full sweep). ``impl``: ``"nii"`` or ``"windowed"``;
    ``overlap``: the windowed decoder's training length.
    """

    k: int
    iterations: int = 5
    window: int | None = None
    impl: str = "nii"
    overlap: int = DEFAULT_OVERLAP

    def __post_init__(self):
        if self.impl not in ("nii", "windowed"):
            raise ValueError(f"impl {self.impl!r}: 'nii' or 'windowed'")

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
        zst = torch.zeros((w_count + 1, 8, b), dtype=torch.float32,
                          device=dev)
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
                if not bool(torch.any(snd != 0.0)):
                    break
            ext2 = ext2i[pinv]
        return llr_int, n_it

    def decode_win(self, sys1, par1, sys2_tail, par2, *, crc=None,
                   map_decode=map_decode_win):
        """Windowed-overlap iteration loop on time-major arrays (the JAX
        package's v1 loop, turbo_decoder.py:558-635).

        sys1/par1/par2 [K+3, B] (payload plus termination rows),
        sys2_tail [3, B]. Per iteration: ``lsa1 = sys + ext2``,
        ``ext1 = map(lsa1, par1) - lsa1``; ``lsa2 = (sys + ext1)[pi]``,
        ``ext2 = (map(lsa2, par2) - lsa2)[pinv]``. With ``crc`` iterate
        until every code block's natural-order hard bits pass (one host
        read per iteration) or ``iterations`` is reached.

        Returns (llr [K, B] natural-order a-posteriori LLRs, n_iterations).
        """
        k = self.k
        if self.window is None:
            raise NotImplementedError(
                f"K={k} has no turbo window: the full-trellis sweep of the "
                "windowed decoder is not ported")
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
                if not bool(torch.any(snd != 0.0)):
                    break
        return llr, n_it

    def decode(self, d_llr, crc=None, iters_out: list | None = None,
               map_decode=None):
        """Decode d_llr[..., 3, K+4] -> (bits[..., K] int8, llr[..., K]).

        Leading dims are batch. ``iters_out`` (a list) receives the
        iteration count. ``map_decode`` replaces the constituent kernel
        wrapper of ``impl`` (with its plain twin, to compare the two).
        """
        k = self.k
        d_llr = d_llr.to(torch.float32)
        sys1, par1, sys2_tail, par2 = self._split_streams(d_llr)
        lead = sys1.shape[:-1]
        b = int(np.prod(lead)) if lead else 1
        tm = lambda x: x.reshape(b, x.shape[-1]).t().contiguous()
        sys1_tm, par1_tm, par2_tm = tm(sys1), tm(par1), tm(par2)
        if self.impl == "windowed":
            llr, n_it = self.decode_win(
                sys1_tm, par1_tm, tm(sys2_tail), par2_tm, crc=crc,
                map_decode=map_decode or map_decode_win)
        else:
            llr_int, n_it = self.decode_tm(
                sys1_tm[:k], par1_tm[:k], par2_tm[:k], sys1_tm[k:],
                par1_tm[k:], tm(sys2_tail), par2_tm[k:], crc=crc,
                map_decode=map_decode or map_decode_nii)
            llr = llr_int[_perm("pinv", k, d_llr.device)]
        if iters_out is not None:
            iters_out.append(n_it)
        llr = llr.t().reshape(*lead, k)
        return (llr < 0).to(torch.int8), llr
