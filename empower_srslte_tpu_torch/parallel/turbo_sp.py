"""Sequence-parallel turbo decoding: the trellis sharded across devices.

Counterpart of the JAX package's ``parallel/turbo_sp.py``, time-major
[K, B] as ``TurboDecoder.decode_tm`` works. The K trellis steps are cut
into n chunks along one mesh axis; each shard decodes its chunk's windows
and the shards meet through the axis's communicator (``parallel/comm.py``),
in lockstep over the shards this process holds.

* ``sp_turbo_decode_nii``: the deployed decoder, trellis-sharded. Each
  shard launches the NII kernel (``ops/fec/turbo_nii.py map_decode_nii``;
  its plain twin on CPU tensors) on its own windows with its own
  ``bounds``: the first shard holds the trellis start, the last the
  termination, the others neither. Each half-iteration ships one
  boundary-metric slice per shard edge to the ring neighbour (the end
  alpha of the last window to the right, the start beta of the first to
  the left): exactly the metrics one device passes between adjacent
  windows, so the decode is bit-identical to ``TurboDecoder(impl="nii",
  window=l, dtype="float32")`` on one device. The QPP interleaver is a
  global permutation, so each half-iteration's extrinsic chunks are
  all-gathered before the (de)interleaving gather of the local rows.
* ``sp_turbo_decode``: the plain windowed sweeps with 40-step overlap
  training whose halos come from the neighbours
  (``_windowed_map_decode(halo=, boundary=)``), a cross-check that shares
  no kernel code with the NII path.

Both return (bits [..., K] int8, llr [..., K]) on the first local
shard's device; every shard computes the same result, as JAX's
replicated output.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.fec.turbo_decoder import (PAD_LLR, TurboDecoder, _edge_metric,
                                     _perm, _windowed_map_decode)
from ..ops.fec.turbo_nii import map_decode_nii
from .comm import each


def _pick_window(chunk: int, overlap: int) -> int:
    for w in (128, 96, 64, 160, 192, 256, 48, 320):
        if chunk % w == 0 and w >= overlap:
            return w
    raise ValueError(f"no window divides chunk={chunk}")


def _time_major(d_llr, k: int):
    """d_llr [..., 3, K+4] -> (lead dims, code blocks B, sys1, par1, par2
    [K+3, B], sys2_tail [3, B]), time-major and contiguous."""
    sys1, par1, sys2t, par2 = TurboDecoder(k=k)._split_streams(d_llr)
    lead = sys1.shape[:-1]
    b = int(np.prod(lead)) if lead else 1
    tm = lambda x: x.reshape(b, x.shape[-1]).t().contiguous()
    return lead, b, tm(sys1), tm(par1), tm(par2), tm(sys2t)


def _axis(mesh, axis: str, k: int):
    comm = mesh.comm(axis)
    if k % comm.size:
        raise ValueError(f"K {k} does not split into {comm.size} shards")
    coords = mesh.local()
    return comm, k // comm.size, coords, {c: mesh.devices[c] for c in coords}


def sp_turbo_decode_nii(d_llr, k: int, mesh, axis: str = "sf",
                        iterations: int = 5):
    """Trellis-sharded NII decode of d_llr [..., 3, K+4], in float32.

    The window is ``_pick_window(K / n, 16)``; shard i of n launches the
    kernel on its K / n rows with bounds (0 if i == 0 else -1, its last
    window if i == n - 1 else -1). -> (bits [..., K], llr [..., K])."""
    comm, chunk, coords, dev = _axis(mesh, axis, k)
    n = comm.size
    l = _pick_window(chunk, 16)
    n_loc = chunk // l
    lead, b, sys1, par1, par2, sys2t = _time_major(
        d_llr.to(torch.float32), k)
    sys = sys1[:k]
    sys_int = sys[_perm("pi", k, sys.device)]
    idx = {c: comm.index(c) for c in coords}
    rows = lambda x: {c: x[idx[c] * chunk:(idx[c] + 1) * chunk].to(dev[c])
                      for c in coords}
    whole = lambda x: {c: x.to(dev[c]) for c in coords}
    sys_l, sysi_l, p1_l, p2_l = rows(sys), rows(sys_int), rows(par1[:k]), \
        rows(par2[:k])
    ut1, pt1, ut2, pt2 = whole(sys1[k:]), whole(par1[k:]), whole(sys2t), \
        whole(par2[k:])
    pi_l = {c: _perm("pi", k, dev[c])[idx[c] * chunk:(idx[c] + 1) * chunk]
            for c in coords}
    pinv_l = {c: _perm("pinv", k, dev[c])[idx[c] * chunk:(idx[c] + 1) * chunk]
              for c in coords}
    bounds = {c: (0 if idx[c] == 0 else -1,
                  n_loc - 1 if idx[c] == n - 1 else -1) for c in coords}

    def dec_call(u, p, ut, pt, a_raw, b_raw, apr):
        # window w's alpha init is window w-1's end alpha (the left
        # neighbour's last window at the shard edge), its beta init window
        # w+1's start beta (the right neighbour's first): the slot
        # convention of map_decode_nii on one device
        left = comm.shift(each(lambda a: a[-1:], a_raw), 1)
        right = comm.shift(each(lambda x: x[:1], b_raw), -1)
        out = {c: map_decode_nii(
            u[c], p[c], ut[c], pt[c], torch.cat([left[c], a_raw[c]]),
            torch.cat([b_raw[c], right[c]]), l=l, apr=apr[c],
            bounds=bounds[c]) for c in coords}
        # carry the raw per-window metrics (slots 1.. of a_next, ..W-1 of
        # b_next)
        return (each(lambda o: o[0], out), each(lambda o: o[1][1:], out),
                each(lambda o: o[2][:-1], out))

    zst = {c: torch.zeros((n_loc, 8, b), device=dev[c]) for c in coords}
    a1 = b1 = a2 = b2 = zst
    ext2 = each(torch.zeros_like, sys_l)
    for _ in range(iterations):
        ext1, a1, b1 = dec_call(sys_l, p1_l, ut1, pt1, a1, b1, ext2)
        ext1_int = each(lambda e, pl: e[pl], comm.all_gather(ext1), pi_l)
        ext2i, a2, b2 = dec_call(sysi_l, p2_l, ut2, pt2, a2, b2, ext1_int)
        ext2 = each(lambda e, pl: e[pl], comm.all_gather(ext2i), pinv_l)
    # the a-posteriori LLRs as TurboDecoder.decode_tm forms them, in its
    # order: (sys_int + ext1_int) + ext2i
    llr_int = comm.all_gather(each(lambda s, e1, e2: s + e1 + e2,
                                   sysi_l, ext1_int, ext2i))
    c0 = coords[0]
    llr = llr_int[c0][_perm("pinv", k, dev[c0])].t().reshape(*lead, k)
    return (llr < 0).to(torch.int8), llr


def sp_turbo_decode(d_llr, k: int, mesh, axis: str = "sf",
                    iterations: int = 5, overlap: int = 40):
    """Decode d_llr [..., 3, K+4] with the trellis sharded over ``axis``
    on the plain windowed sweeps: each shard trains its edge windows over
    ``overlap`` rows of its neighbours (parity halos exchanged once, the
    systematic + a-priori halos cut from the gathered rows), the first
    shard from the trellis start, the last through the termination.
    -> (bits [..., K], llr [..., K])."""
    comm, chunk, coords, dev = _axis(mesh, axis, k)
    n, o = comm.size, overlap
    window = _pick_window(chunk, o)
    lead, b, sys1, par1, par2, sys2t = _time_major(d_llr, k)
    dt = sys1.dtype
    idx = {c: comm.index(c) for c in coords}
    whole = lambda x: {c: x.to(dev[c]) for c in coords}
    rows = lambda x: {c: x[idx[c] * chunk:(idx[c] + 1) * chunk].to(dev[c])
                      for c in coords}
    zeros_h = lambda c: torch.zeros((o + 3, b), dtype=dt, device=dev[c])

    def par_halos(par):
        loc = rows(par[:k])
        lead_h = comm.shift(each(lambda x: x[-(o + 3):], loc), 1)
        trail = comm.shift(each(lambda x: x[:o + 3], loc), -1)
        tail = torch.cat([par[k:], torch.zeros((o, b), dtype=dt,
                                               device=par.device)])
        return (loc,
                {c: zeros_h(c) if idx[c] == 0 else lead_h[c] for c in coords},
                {c: tail.to(dev[c]) if idx[c] == n - 1 else trail[c]
                 for c in coords})

    p1 = par_halos(par1)
    p2 = par_halos(par2)
    # the terminated metric at the trellis ends, uniform inside
    edge = lambda c, end: _edge_metric(dev[c], dt) if idx[c] == end \
        else torch.zeros(8, dtype=dt, device=dev[c])
    inits = {c: (edge(c, 0), edge(c, n - 1)) for c in coords}

    def local_map(lsa_full, par):
        """One constituent decode of each shard's rows; lsa_full [K+3, B]
        is whole on every shard, so its halos are cut locally (PAD_LLR
        outside the trellis)."""
        loc, p_lead, p_trail = par
        out = {}
        for c in coords:
            pad = torch.full((o + 3, b), PAD_LLR, dtype=dt, device=dev[c])
            full = torch.cat([pad, lsa_full[c], pad])
            s = idx[c] * chunk
            halo = (full[s:s + o + 3], p_lead[c],
                    full[s + o + 3 + chunk:s + 2 * (o + 3) + chunk],
                    p_trail[c])
            out[c] = _windowed_map_decode(
                full[s + o + 3:s + o + 3 + chunk], loc[c], chunk, o, window,
                *inits[c], halo=halo, boundary=(True, True))
        return out

    sys_pay, sys1_tail, sys2_tail = whole(sys1[:k]), whole(sys1[k:]), \
        whole(sys2t)
    pi, pinv = ({c: _perm(name, k, dev[c]) for c in coords}
                for name in ("pi", "pinv"))
    ext2 = each(torch.zeros_like, sys_pay)
    for _ in range(iterations):
        lsa1_pay = each(torch.add, sys_pay, ext2)
        llr1 = comm.all_gather(local_map(
            each(lambda x, t: torch.cat([x, t]), lsa1_pay, sys1_tail), p1))
        ext1 = each(torch.sub, llr1, lsa1_pay)
        lsa2_pay = each(lambda s, e, q: (s + e)[q], sys_pay, ext1, pi)
        llr2 = comm.all_gather(local_map(
            each(lambda x, t: torch.cat([x, t]), lsa2_pay, sys2_tail), p2))
        ext2 = each(lambda l2, ls, q: (l2 - ls)[q], llr2, lsa2_pay, pinv)
    c0 = coords[0]
    llr = llr2[c0][pinv[c0]].t().reshape(*lead, k)
    return (llr < 0).to(torch.int8), llr
