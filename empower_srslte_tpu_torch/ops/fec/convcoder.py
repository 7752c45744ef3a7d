"""K=7 tail-biting convolutional code, rate 1/3 (36.212 5.1.3.1).

Capability parity with lib/src/phy/fec/convcoder.c and viterbi.c (the soft
Viterbi decoders behind PBCH and PDCCH, pbch.c:156,425 / pdcch.c:79,341).

The decoder is a batched max-log Viterbi with register-exchange survivors,
tail-biting by the circular-halo trick (decode the circularly extended
sequence, keep the middle copy). ``viterbi_decode`` is the entry point:
on a CUDA tensor it launches the hand-written kernel
(ops/fec/viterbi37.py, csrc/viterbi37.cu); on a CPU tensor it runs
``viterbi_decode_plain``, the port of the JAX package's three-segment
scan (empower_srslte_tpu/ops/fec/convcoder.py:99-232), which is the
kernel's plain twin: the two take bit-identical decisions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils.device import device_table

#: Generator polynomials G0=133, G1=171, G2=165 (octal), MSB = newest bit.
POLYS = (0o133, 0o171, 0o165)
NOF_STATES = 64
RATE = 3
#: Circular-halo length for tail-biting convergence: ~6x the constraint
#: length (K=7), the standard truncation/training depth for Viterbi.
TRAIN_LEN = 40


@functools.lru_cache(maxsize=1)
def _tables():
    """Transition tables over state s = (u_{k-1}..u_{k-6}).

    next_state[s, u], out_bits[s, u, 3]; and the reverse view
    prev_state[s', b] (b = the shifted-out oldest bit hypothesis) with
    prev_u[s'] = newest input bit implied by s'.
    """
    ns = np.zeros((NOF_STATES, 2), np.int32)
    out = np.zeros((NOF_STATES, 2, RATE), np.int8)
    for s in range(NOF_STATES):
        for u in (0, 1):
            reg = (u << 6) | s
            ns[s, u] = (u << 5) | (s >> 1)
            for j, g in enumerate(POLYS):
                out[s, u, j] = bin(reg & g).count("1") % 2
    ps = np.zeros((NOF_STATES, 2), np.int32)
    pu = np.zeros(NOF_STATES, np.int32)
    pout = np.zeros((NOF_STATES, 2, RATE), np.int8)
    for sp in range(NOF_STATES):
        u = sp >> 5
        pu[sp] = u
        for b in (0, 1):
            s = ((sp & 31) << 1) | b
            ps[sp, b] = s
            pout[sp, b] = out[s, u]
    return ns, out, ps, pu, pout


def conv_encode(u: torch.Tensor) -> torch.Tensor:
    """Tail-biting encode u[..., K] 0/1 -> d[..., 3, K] int8 (initial
    state = last 6 input bits, 36.212 5.1.3.1)."""
    ns, out, *_ = _tables()
    dev = u.device
    ns_t = device_table("cc_ns", dev, lambda: ns.astype(np.int64))
    out_t = device_table("cc_out", dev, lambda: out)
    k = u.shape[-1]
    u = u.to(torch.int64)
    state = torch.zeros(u.shape[:-1], dtype=torch.int64, device=dev)
    for j in range(6):
        state = state | (u[..., k - 1 - j] << (5 - j))
    outs = []
    for i in range(k):
        ui = u[..., i]
        outs.append(out_t[state, ui])
        state = ns_t[state, ui]
    return torch.stack(outs, dim=-1)                    # [..., 3, K]


@functools.lru_cache(maxsize=1)
def _plain_tables_np():
    ns, out, ps, pu, pout = _tables()
    pidx = [((pout[:, u, 0].astype(np.int64) << 2)
             | (pout[:, u, 1].astype(np.int64) << 1) | pout[:, u, 2])
            for u in (0, 1)]
    return (ps[:, 0].astype(np.int64), ps[:, 1].astype(np.int64),
            pidx[0], pidx[1], pu.astype(np.int32)[:, None])


def viterbi_decode_plain(llr, train: int | None = TRAIN_LEN):
    """Three-segment tail-biting Viterbi in plain torch.

    llr [..., 3, K] soft values (positive <=> bit 0) -> bits [..., K] int8.
    The circular halo is min(train, K) steps per side (K when ``train``
    is None). Segment 1 (leading halo) updates metrics only; segment 2
    (the K middle steps) runs add-compare-select with register exchange
    (ceil(K/32) int32 words per state); segment 3 (trailing halo) keeps
    selecting survivors without shifting. Metrics renormalize by state
    0's; the winner is the first maximum.
    """
    *lead, three, k = llr.shape
    b = int(np.prod(lead)) if lead else 1
    dev = llr.device
    x = llr.reshape(b, 3, k).to(torch.float32).permute(2, 1, 0)  # [K, 3, B]
    halo = k if train is None else min(k, train)
    x_pre, x_post = x[k - halo:], x[:halo]
    ps0, ps1, pi0, pi1, pu_col = [
        device_table(("vit_plain", i), dev, lambda a=a: a)
        for i, a in enumerate(_plain_tables_np())]
    n_regs = (k - 1) // 32 + 1

    def metric_step(metric, llr_k):
        l0, l1, l2 = llr_k[0], llr_k[1], llr_k[2]            # [B]
        p01, m01 = l0 + l1, l0 - l1
        comb = torch.stack([p01 + l2, p01 - l2, m01 + l2, m01 - l2,
                            -m01 + l2, -m01 - l2, -p01 + l2, -p01 - l2],
                           dim=0) * 0.5                      # [8, B]
        cand0 = metric[ps0] + comb[pi0]
        cand1 = metric[ps1] + comb[pi1]
        best = cand1 > cand0                                 # [64, B]
        new = torch.where(best, cand1, cand0)
        return new - new[0:1], best

    metric = torch.zeros((NOF_STATES, b), dtype=torch.float32, device=dev)
    for t in range(halo):
        metric, _ = metric_step(metric, x_pre[t])
    regs = [torch.zeros((NOF_STATES, b), dtype=torch.int32, device=dev)
            for _ in range(n_regs)]
    for t in range(k):
        metric, best = metric_step(metric, x[t])
        sel = [torch.where(best, r[ps1], r[ps0]) for r in regs]
        carry = pu_col.expand_as(best)
        regs = []
        for r in sel:
            regs.append((r << 1) | carry)
            carry = (r >> 31) & 1
    for t in range(halo):
        metric, best = metric_step(metric, x_post[t])
        regs = [torch.where(best, r[ps1], r[ps0]) for r in regs]

    win = torch.argmax(metric, dim=0)                        # first maximum
    win_regs = [torch.gather(r, 0, win[None])[0] for r in regs]
    return unpack_regs(torch.stack(win_regs, dim=-1), k).reshape(*lead, k)


def unpack_regs(regs: torch.Tensor, k: int) -> torch.Tensor:
    """Winner registers [B, n_regs] int32 -> bits [B, K] int8: middle-copy
    decision t sits k-1-t bits from the newest."""
    pos = np.arange(k - 1, -1, -1)
    rsel = device_table(("vit_rsel", k), regs.device,
                        lambda: (pos // 32).astype(np.int64))
    shift = device_table(("vit_shift", k), regs.device,
                         lambda: (pos % 32).astype(np.int32))
    return ((regs[:, rsel] >> shift) & 1).to(torch.int8)


def viterbi_decode(llr, train: int | None = TRAIN_LEN):
    """Tail-biting Viterbi llr [..., 3, K] -> bits [..., K]: the CUDA
    kernel for CUDA tensors, the plain twin for CPU tensors."""
    if not llr.is_cuda:
        return viterbi_decode_plain(llr, train=train)
    from .viterbi37 import viterbi_decode_cuda

    return viterbi_decode_cuda(llr, train=train)
