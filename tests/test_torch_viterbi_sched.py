"""The Viterbi kernel's warp schedule, on the CPU.

``csrc/viterbi37.cu`` runs one warp per code word: lane j holds states j
and j+32, reads their shared predecessors 2j and 2j+1 from the raw metrics
of the previous step and renormalizes by state 0's metric where it reads,
packs each middle and flush step's decisions into two ballot words, finds
the winner by a (metric, state) warp reduction and walks the decisions
back into the packed survivor words. These tests check (a) the wrapper's
launch plan and (b) that a torch model of that schedule, written here
unit by unit as the kernel runs it, equals the unchanged plain twin
``viterbi_decode_plain`` bit for bit (``tests/test_torch_viterbi.py``
ties the twin to the JAX scan and the interpret-mode Pallas kernel).
"""

import numpy as np
import pytest
import torch

from empower_srslte_tpu_torch.ops.fec.convcoder import (
    TRAIN_LEN, conv_encode, unpack_regs, viterbi_decode_plain)
from empower_srslte_tpu_torch.ops.fec.viterbi37 import (
    MAX_K, WARPS, vit_plan)
from empower_srslte_tpu_torch.utils.device import MAX_SMEM


def _warp_bytes(k, halo):
    return 2 * 64 * 4 + 32 * k + 8 * (k + halo)


def test_plan_bytes_and_warps_at_the_path_shapes():
    for k, halo in [(55, 40), (44, 40), (38, 38), (20, 20), (256, 256)]:
        plan = vit_plan(k, halo)
        assert plan.warps == WARPS
        assert plan.smem == WARPS * _warp_bytes(k, halo)
    assert vit_plan(55, 40).smem == 4 * 3032        # blind search, DCI 1
    assert vit_plan(38, 38).smem == 4 * 2336        # the CQI's clamped halo


def test_plan_fits_every_k_up_to_max_k():
    assert MAX_K >= 256
    for k in list(range(1, 300)) + list(range(300, MAX_K + 1, 37)) + [MAX_K]:
        for halo in {0, min(TRAIN_LEN, k), k}:
            plan = vit_plan(k, halo)
            assert plan.warps == WARPS
            assert plan.smem == WARPS * _warp_bytes(k, halo) <= MAX_SMEM
    assert WARPS * _warp_bytes(MAX_K + 1, MAX_K + 1) > MAX_SMEM


@pytest.mark.parametrize("k,halo", [(MAX_K + 1, 40), (0, 0), (40, 41),
                                    (40, -1)])
def test_plan_refuses_out_of_range(k, halo):
    with pytest.raises(ValueError):
        vit_plan(k, halo)


# ---- the torch model of the kernel's schedule ----

def _out_idx(s, u):
    reg = (u << 6) | s
    par = lambda g: bin(reg & g).count("1") & 1
    return (par(0o133) << 2) | (par(0o171) << 1) | par(0o165)


LANE = torch.arange(32)
PS0 = 2 * LANE                                   # both states' predecessors
I0, I1 = (torch.tensor([_out_idx(2 * j + b, 0) for j in range(32)])
          for b in (0, 1))


def _ballot(d):
    """[32, B] bool -> [B] int64, bit j = lane j's predicate."""
    return (d.to(torch.int64) << LANE[:, None]).sum(0)


def vit_schedule_model(llr, halo):
    """csrc/viterbi37.cu in torch, lanes as rows: llr [B, 3, K] -> winner
    registers [B, ceil(K/32)] int32."""
    b, _, k = llr.shape
    x = llr.permute(2, 1, 0)                                 # [K, 3, B]
    l0, l1, l2 = x[:, 0], x[:, 1], x[:, 2]
    p01, m01 = l0 + l1, l0 - l1
    c = [(p01 + l2) * 0.5, (p01 - l2) * 0.5, (m01 + l2) * 0.5,
         (m01 - l2) * 0.5]
    combs = torch.stack(c + [-c[3], -c[2], -c[1], -c[0]], 1)  # [K, 8, B]

    def acs(raw, col):
        """One warp step: raw [64, B] of the previous step -> (raw of
        this step, lo and hi decisions [32, B])."""
        r0 = raw[0]
        m0, m1 = raw[PS0] - r0, raw[PS0 + 1] - r0   # renormalize at the read
        c0, c1 = combs[col][I0], combs[col][I1]
        # state j+32's index is 7 - state j's, and cb[7-i] == -cb[i]
        a0, a1, b0, b1 = m0 + c0, m1 + c1, m0 - c0, m1 - c1
        d_lo, d_hi = a1 > a0, b1 > b0
        return (torch.cat([torch.where(d_lo, a1, a0),
                           torch.where(d_hi, b1, b0)]), d_lo, d_hi)

    raw = torch.zeros((64, b), dtype=torch.float32)
    for t in range(halo):                                    # training
        raw, _, _ = acs(raw, k - halo + t)
    dec = []
    for t in range(k + halo):                                # middle, flush
        raw, d_lo, d_hi = acs(raw, t if t < k else t - k)
        dec.append((_ballot(d_lo), _ballot(d_hi)))

    m = raw - raw[0]                                         # [64, B]
    bm = torch.where(m[32:] > m[:32], m[32:], m[:32])
    bs = torch.where(m[32:] > m[:32], LANE[:, None] + 32,
                     LANE[:, None]).expand(32, b)
    for off in (16, 8, 4, 2, 1):                             # xor butterfly
        om, os_ = bm[LANE ^ off], bs[LANE ^ off]
        take = (om > bm) | ((om == bm) & (os_ < bs))
        bm, bs = torch.where(take, om, bm), torch.where(take, os_, bs)
    s = bs[0]                                                # lane 0's view

    def back(s, t):
        lo, hi = dec[t]
        w = torch.where((s & 32) != 0, hi, lo)
        return ((s & 31) << 1) | ((w >> (s & 31)) & 1)

    for t in range(k + halo - 1, k - 1, -1):                 # flush halo
        s = back(s, t)
    n_regs = (k - 1) // 32 + 1
    words = torch.zeros((b, n_regs), dtype=torch.int64)
    for p in range(k):                          # middle step k-1-p, bit p
        words[:, p // 32] |= (s >> 5) << (p % 32)
        s = back(s, k - 1 - p)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _pack(bits, k):
    """bits [B, K] (decision t) -> registers [B, ceil(K/32)] int32 with
    bit k-1-t set for decision t and zeros above: the inverse of
    ``unpack_regs``."""
    pos = torch.arange(k - 1, -1, -1)
    words = torch.zeros((bits.shape[0], (k - 1) // 32 + 1), dtype=torch.int64)
    for t in range(k):
        words[:, pos[t] // 32] |= bits[:, t].to(torch.int64) << (pos[t] % 32)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def _inputs(rng, k):
    """Noisy codewords, random N(0, 4) LLRs, and words built for ties:
    integer LLRs in {-1, 0, 1}, equal columns, all zeros."""
    u = torch.as_tensor(rng.integers(0, 2, size=(8, k)))
    d = conv_encode(u).numpy().astype(np.float32)
    noisy = 1.0 - 2.0 * d + 0.8 * rng.normal(size=d.shape)
    rand = 2.0 * rng.normal(size=(8, 3, k))
    ints = rng.integers(-1, 2, size=(6, 3, k))
    equal = np.repeat(rng.normal(size=(3, 3, 1)), k, axis=2)
    zero = np.zeros((1, 3, k))
    x = np.concatenate([noisy, rand, ints, equal, zero]).astype(np.float32)
    return torch.as_tensor(x)


@pytest.mark.parametrize("train", [TRAIN_LEN, None], ids=["train40", "none"])
@pytest.mark.parametrize("k", [20, 38, 40, 44, 55, 64, 100, 256])
def test_schedule_model_equals_plain_twin(rng, k, train):
    llr = _inputs(rng, k)
    halo = k if train is None else min(train, k)
    got = vit_schedule_model(llr, halo)
    ref_bits = viterbi_decode_plain(llr, train=train)
    assert torch.equal(got, _pack(ref_bits, k))
    assert torch.equal(unpack_regs(got, k), ref_bits)


@pytest.mark.parametrize("k", [20, 55])
def test_schedule_model_breaks_final_ties_like_argmax(rng, k):
    """With no flush halo the winner's own top bit is the last decision,
    so a tie between states j and j+32 (all-zero words tie all 64) shows
    in the bits: the lower state must win, as in the twin's argmax."""
    llr = torch.as_tensor(np.concatenate([
        np.zeros((2, 3, k)), rng.integers(-1, 2, size=(14, 3, k))]).astype(
            np.float32))
    got = vit_schedule_model(llr, 0)
    assert torch.equal(unpack_regs(got, k), viterbi_decode_plain(llr,
                                                                 train=0))
