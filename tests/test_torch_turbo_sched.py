"""The turbo kernels' checkpoint-and-recompute schedules, on the CPU.

The CUDA kernels ``csrc/turbo_nii.cu`` and ``csrc/turbo_win.cu`` keep no
beta store in device memory: a sweep keeps the carry entering each
segment, and the other recomputes a segment's metrics from it. In float32
one thread runs a window's whole schedule; in bfloat16 (the split
kernels) two threads share each window of a code block pair, one running
alpha up the lower half while the other runs beta down the upper half,
then each crossing into the other's half. These tests check (a) that the
wrappers' launch plans fit every window the decoders use into one
block's shared memory, with segments that tile the window on
renormalization-group boundaries, in both dtypes, and (b) that torch
models of the kernels' schedules, written here unit by unit as the
kernels run them (for the split kernels also the staging of a warp's
rows as aligned 32-bit words read back as code block pairs, which is how
an odd batch launches without padding), equal the unchanged plain twins
bit for bit.
"""

import numpy as np
import pytest
import torch

from empower_srslte_tpu_torch.models.sch import _pick_window
from empower_srslte_tpu_torch.ops.fec import turbo_nii, turbo_win
from empower_srslte_tpu_torch.ops.fec.tables import TURBO_CB_SIZES
from empower_srslte_tpu_torch.ops.fec.turbo_nii import (
    map_decode_nii_plain, nii_plan)
from empower_srslte_tpu_torch.ops.fec.turbo_win import (
    DEFAULT_OVERLAP, map_decode_win_plain, win_plan)
from empower_srslte_tpu_torch.utils.device import H100_SMS, MAX_SMEM


def _check_segments(plan, l, group):
    """Segments tile [0, l), each of at most one group, starting on a
    renormalization-group boundary; the checkpoints are the carries a
    schedule keeps (one thread: the backward carry entering every segment
    above the first; split: the alpha carry entering each of the lower
    ``split`` segments, the beta carry entering the top row of each upper
    one)."""
    segs = plan.segments
    assert segs[0][0] == 0 and segs[-1][1] == l
    for (lo, hi), (lo2, _) in zip(segs, segs[1:]):
        assert hi == lo2, "segments must tile the window"
    assert all(lo % group == 0 for lo, _ in segs), "checkpoints off-group"
    assert all(0 < hi - lo <= group for lo, hi in segs)
    if plan.sides == 1:
        assert plan.checkpoints == tuple(hi - 1 for _, hi in segs[1:])
    else:
        assert plan.split == len(segs) // 2
        assert plan.checkpoints == (
            tuple(lo for lo, _ in segs[:plan.split])
            + tuple(hi - 1 for _, hi in segs[plan.split:]))


def _check_split(plan, row_words):
    """The bfloat16 split plan: two warps over 32 code block pairs (one
    thread per code block), a 32-byte checkpoint per segment and pair in
    shared memory, and two rings of two slots of ``row_words`` 32-bit
    words per staged row."""
    assert (plan.threads, plan.cbs_per_thread, plan.sides) == (64, 2, 2)
    assert plan.threads_per_cb == 1.0
    assert plan.smem == (len(plan.segments) * 2 * turbo_nii.SPLIT_PAIRS * 16
                         + 2 * turbo_nii.SPLIT_SLOTS * row_words * 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", ["nii", "win"])
def test_launch_plans_fit_every_code_block_size(kernel, dtype):
    """Every K of the QPP table with its decoder window (NII: the whole
    trellis where ``_pick_window`` finds none) fits one block, in either
    metric dtype."""
    assert len(TURBO_CB_SIZES) == 188
    # one code block (an odd batch: the split kernel's shifted rows), and
    # an aligned batch the rule gives the one-thread kernel in bfloat16
    for k in TURBO_CB_SIZES:
        l = _pick_window(k)
        for cbs in (1, 1 << 20):
            words = turbo_nii.SPLIT_ROW_WORDS[
                "shifted" if cbs % 2 else "aligned"]
            if kernel == "nii":
                l = l or k
                for apr in (True, False):
                    plan = nii_plan(l, apr, dtype, cbs, k // l)
                    assert plan.smem <= MAX_SMEM, (k, l, plan.smem)
                    if dtype == torch.bfloat16 and cbs == 1:
                        # 8-row segments unless their checkpoints overflow
                        seg = plan.segments[0][1]
                        eight = turbo_nii.split_plan(
                            tuple((lo, lo + 8) for lo in range(0, l, 8)), 8,
                            3 if apr else 2, True)
                        assert seg == (8 if eight.smem <= MAX_SMEM else 16)
                        _check_segments(plan, l, seg)
                        _check_split(plan, seg * (3 if apr else 2) * words)
                    else:
                        _check_segments(plan, l, turbo_nii.GROUP)
                        assert (plan.threads, plan.sides) == (32, 1)
            elif l is not None:
                for o in (24, DEFAULT_OVERLAP):
                    plan = win_plan(l, o, dtype, cbs, k // l)
                    assert plan.smem <= MAX_SMEM, (k, l, plan.smem)
                    _check_segments(plan, l, turbo_win.GROUP)
                    if dtype == torch.bfloat16 and cbs == 1:
                        _check_split(plan, 8 * 2 * words)
                    else:
                        assert (plan.threads, plan.sides) == (32, 1)


def test_launch_plans_refuse_what_does_not_fit():
    with pytest.raises(ValueError):
        nii_plan(60, True)                  # not a multiple of 8
    with pytest.raises(ValueError):
        nii_plan(8 * 1000, True)            # checkpoints overflow the SM
    with pytest.raises(ValueError):
        win_plan(224, 44)


# ---- torch models of the kernels' schedules ----

def _beta_step(beta, g, w):
    ns0, ns1, gi0, gi1, _, _ = w
    return torch.maximum(beta[ns0] + g[gi0], beta[ns1] + g[gi1])


def _renorm(x):
    return x - torch.amax(x, 0)


def nii_schedule_model(u, p, tail_u, tail_p, a_st, b_st, *, l, apr=None,
                       bounds=None):
    """csrc/turbo_nii.cu's unit loop in torch, over all (window, code
    block) pairs at once: backward units over the plan's segments top
    down, keeping only the checkpoints (segment 0's betas go straight to
    the segment buffer), then forward units bottom up, each recomputing
    its segment's betas from its checkpoint."""
    plan = nii_plan(l, apr is not None)
    k, b = u.shape
    n_w = k // l
    first, last = (0, n_w - 1) if bounds is None else bounds
    wiring = turbo_nii._wiring(u.device)
    _, _, gi0, gi1, ps0, ps1 = wiring
    ns0, ns1 = wiring[:2]
    uu = (u + apr if apr is not None else u).view(n_w, l, b)
    pw = p.view(n_w, l, b)
    gam = lambda r: turbo_nii._gammas(uu[:, r], pw[:, r])

    beta = b_st[1:].permute(1, 0, 2).clone()
    if 0 <= last < n_w:
        bt = turbo_nii._exact((b,), u.device)
        for j in (2, 1, 0):
            bt = _beta_step(bt, turbo_nii._gammas(tail_u[j], tail_p[j]),
                            wiring)
        beta[:, last] = _renorm(bt)

    segs = plan.segments
    ckpt = {}
    buf = {}
    for j in range(len(segs) - 1, -1, -1):
        lo, hi = segs[j]
        if j > 0:
            ckpt[hi - 1] = beta
        for r in range(hi - 1, lo - 1, -1):
            if j == 0:
                buf[r] = beta
            beta = _beta_step(beta, gam(r), wiring)
        beta = _renorm(beta)                 # the group's lowest row
    b_next = torch.zeros_like(b_st)
    b_next[:n_w] = beta.permute(1, 0, 2)

    alpha = a_st[:n_w].permute(1, 0, 2).clone()
    if 0 <= first < n_w:
        alpha[:, first] = turbo_nii._exact((b,), u.device)
    ext = torch.empty((n_w, l, b), dtype=torch.float32)
    for j, (lo, hi) in enumerate(segs):
        if j > 0:
            buf = {}
            rb = ckpt[hi - 1]
            for r in range(hi - 1, lo - 1, -1):
                buf[r] = rb
                rb = _beta_step(rb, gam(r), wiring)
        for r in range(lo, hi):
            g = gam(r)
            br0, br1 = alpha + g[gi0], alpha + g[gi1]
            bk1 = buf[r]
            ext[:, r] = (torch.amax(br0 + bk1[ns0], 0)
                         - torch.amax(br1 + bk1[ns1], 0) - uu[:, r])
            alpha = torch.maximum(br0[ps0], br1[ps1])
            if r % turbo_nii.GROUP == turbo_nii.GROUP - 1 or r == l - 1:
                alpha = _renorm(alpha)
    a_next = torch.zeros_like(a_st)
    a_next[1:] = alpha.permute(1, 0, 2)
    return ext.reshape(k, b), a_next, b_next


def win_schedule_model(lsa, lp, *, k, l, o):
    """csrc/turbo_win.cu's unit loop in torch: phase A interleaves the O
    beta and alpha training steps; phase B sweeps beta over the window's
    segments top down, keeping only the checkpoints; phase C recomputes
    each segment from its checkpoint and emits. Renormalization follows
    the rows, as in the kernel (after a segment's lowest row the
    recomputed carry is unused, so the recompute skips it)."""
    plan = win_plan(l, o)
    g_n = turbo_win.GROUP
    b = lsa.shape[1]
    n_w = k // l
    n = n_w * b
    wiring = [torch.as_tensor(a) for a in turbo_nii._wiring_np()]
    ns0, ns1, gi0, gi1, ps0, ps1 = wiring
    ls = turbo_win._window_rows(lsa, turbo_win.PAD_LLR, k, l, o)
    lq = turbo_win._window_rows(lp, 0.0, k, l, o)

    def gam(r):                  # r: row of the padded window, w*L - O + r
        g00, g01 = ls[r] + lq[r], ls[r] - lq[r]
        return torch.stack([g00, g01, -g01, -g00])

    def edge(first):
        m = torch.zeros((8, n_w, b), dtype=torch.float32)
        m[1:, 0 if first else n_w - 1] = turbo_win.NEG
        return m.reshape(8, n)

    beta, alpha = edge(False), edge(True)
    for m in range(o // g_n):                                   # phase A
        for q in range(g_n):
            i_b = l + o - g_n * (m + 1) + (g_n - 1 - q)
            beta = _beta_step(beta, gam(o + i_b), wiring)
            i_a = g_n * m + q
            g = gam(i_a)
            alpha = torch.maximum((alpha + g[gi0])[ps0],
                                  (alpha + g[gi1])[ps1])
        beta, alpha = _renorm(beta), _renorm(alpha)

    segs = plan.segments
    ckpt, buf = {}, {}
    for j in range(len(segs) - 1, -1, -1):                      # phase B
        lo, hi = segs[j]
        if j > 0:
            ckpt[hi - 1] = beta
        for r in range(hi - 1, lo - 1, -1):
            if j == 0:
                buf[r] = beta
            beta = _beta_step(beta, gam(o + r), wiring)
            if r % g_n == 0:
                beta = _renorm(beta)
    llr = torch.empty((l, n), dtype=torch.float32)
    for j, (lo, hi) in enumerate(segs):                         # phase C
        if j > 0:
            buf = {}
            rb = ckpt[hi - 1]
            for r in range(hi - 1, lo - 1, -1):
                buf[r] = rb
                rb = _beta_step(rb, gam(o + r), wiring)
                if r % g_n == 0 and r > lo:
                    rb = _renorm(rb)
        for r in range(lo, hi):
            g = gam(o + r)
            br0, br1 = alpha + g[gi0], alpha + g[gi1]
            llr[r] = (torch.amax(br0 + buf[r][ns0], 0)
                      - torch.amax(br1 + buf[r][ns1], 0))
            alpha = torch.maximum(br0[ps0], br1[ps1])
            if r % g_n == g_n - 1:
                alpha = _renorm(alpha)
    return llr.view(l, n_w, b).transpose(0, 1).reshape(k, b)


@pytest.mark.parametrize("k,l,apr,bounds", [
    (40, 40, True, None), (40, 40, False, None),
    (56, 56, True, None), (56, 56, False, None),
    (512, 256, True, None), (512, 256, False, None),
    (512, 256, True, (-1, -1)), (56, 56, False, (-1, -1)),
])
def test_nii_schedule_model_equals_plain_twin(rng, k, l, apr, bounds):
    b = 6
    w = k // l
    x = lambda *s, sc=4.0: torch.as_tensor(
        (sc * rng.normal(size=s)).astype(np.float32))
    args = (x(k, b), x(k, b), x(3, b), x(3, b), x(w + 1, 8, b, sc=2.0),
            x(w + 1, 8, b, sc=2.0))
    kw = dict(l=l, apr=x(k, b) if apr else None, bounds=bounds)
    got = nii_schedule_model(*args, **kw)
    ref = map_decode_nii_plain(*args, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("k,o", [(192, DEFAULT_OVERLAP), (1024,
                                                            DEFAULT_OVERLAP),
                                 (192, 24)])
def test_win_schedule_model_equals_plain_twin(rng, k, o):
    l = _pick_window(k)
    b = 6
    x = lambda: torch.as_tensor(
        (4.0 * rng.normal(size=(k + 3, b))).astype(np.float32))
    lsa, lp = x(), x()
    got = win_schedule_model(lsa, lp, k=k, l=l, o=o)
    assert torch.equal(got, map_decode_win_plain(lsa, lp, k=k, l=l, o=o))


# ---- torch models of the bfloat16 split schedules ----

BF16 = torch.bfloat16
PAIRS = turbo_nii.SPLIT_PAIRS
#: the words a warp's row of 64 elements spans when it starts mid-word
WORDS = 33


def _bits(x):
    """bfloat16 tensor -> its 16-bit patterns as int64."""
    return x.contiguous().view(torch.int16).to(torch.int64) & 0xFFFF


def _from_bits(v):
    return (v.to(torch.int32) - ((v >= 0x8000).to(torch.int32) << 16)) \
        .to(torch.int16).view(BF16)


def staged_pairs(x, lead: int = 0):
    """The split kernels' staging of a [R, B] bfloat16 array laid out
    ``lead`` elements after a 4-byte boundary, as index gathers: for each
    row and block of 32 pairs, the 33 aligned 32-bit words from the one
    holding its first element (lane j copies word j, lane 31 word 32
    too; the first word holds the element before the row when the row
    starts mid-word), then each lane's pair picked from words j and j + 1
    (across them when the row starts mid-word). -> [R, 2P] with P the
    pairs of the launch rounded up to whole blocks. Past the array the
    model reads zeros where the kernel reads the array's last word again:
    columns >= B stand for what the kernel holds there, which it never
    stores (no operation mixes two code blocks)."""
    r, b = x.shape
    blocks = -(-(-(-b // 2)) // PAIRS)
    mem = torch.cat([torch.zeros(lead, dtype=torch.int64),
                     _bits(x).reshape(-1),
                     torch.zeros(2 * (2 * PAIRS * blocks + 2),
                                 dtype=torch.int64)])
    out = torch.empty((r, 2 * PAIRS * blocks), dtype=torch.int64)
    lanes = torch.arange(PAIRS)
    for row in range(r):
        for blk in range(blocks):
            a = lead + row * b + 2 * PAIRS * blk         # element address
            ws = a // 2                                  # first word
            words = mem[2 * ws + torch.arange(2 * WORDS)].view(WORDS, 2)
            if a % 2:           # the pair straddles words lane, lane + 1
                pair = torch.stack([words[lanes, 1], words[lanes + 1, 0]], 1)
            else:
                pair = words[lanes]
            out[row, 2 * PAIRS * blk:2 * PAIRS * (blk + 1)] = pair.reshape(-1)
    n_el = r * b                    # elements past the array read as zero
    idx = torch.arange(r)[:, None] * b + torch.arange(out.shape[1])[None]
    out[idx >= n_el] = 0
    return _from_bits(out)


def _pairs_cols(x):
    """[..., B] -> [..., 2P]: the pair columns of small per-launch arrays
    (tails, boundary metrics), read two elements at a time; a missing
    high half is zero."""
    b = x.shape[-1]
    width = 2 * PAIRS * -(-(-(-b // 2)) // PAIRS)
    return torch.nn.functional.pad(x, (0, width - b))


def nii_split_model(u, p, tail_u, tail_p, a_st, b_st, *, l, apr=None,
                    bounds=None, lead=0):
    """csrc/turbo_nii.cu's split kernel in torch over every (window, code
    block pair): inputs staged as the kernel stages them
    (``staged_pairs``); the alpha side walks the plan's segments
    0 .. n-1, the beta side n-1 .. 0; phase 1 keeps each side's carry
    entering its segments (alpha below ``split``, beta above); they meet;
    phase 2 recomputes the other side's segment from its checkpoint and
    emits. Returns the [K, B] outputs the kernel stores."""
    k, b = u.shape
    n_w = k // l
    plan = nii_plan(l, apr is not None, BF16, b, n_w, lead == 0)
    assert plan.sides == 2
    first, last = (0, n_w - 1) if bounds is None else bounds
    wiring = turbo_nii._wiring(u.device)
    ns0, ns1, gi0, gi1, ps0, ps1 = wiring
    su, sp = staged_pairs(u, lead), staged_pairs(p, lead)
    uu = su + staged_pairs(apr, lead) if apr is not None else su
    bc = su.shape[1]                                   # 2P columns
    uw, pw = uu.view(n_w, l, bc), sp.view(n_w, l, bc)
    gam = lambda r: turbo_nii._gammas(uw[:, r], pw[:, r])
    a_in, b_in = _pairs_cols(a_st), _pairs_cols(b_st)
    tu, tp = _pairs_cols(tail_u), _pairs_cols(tail_p)

    def alpha_step(alpha, g):
        br0, br1 = alpha + g[gi0], alpha + g[gi1]
        return torch.maximum(br0[ps0], br1[ps1]), br0, br1

    def emit(br0, br1, bk, r):
        return (torch.amax(br0 + bk[ns0], 0) - torch.amax(br1 + bk[ns1], 0)
                - uw[:, r])

    # ---- side 0: alpha init; side 1: beta init (tail walk) ----
    alpha = a_in[:n_w].permute(1, 0, 2).clone()
    if 0 <= first < n_w:
        alpha[:, first] = turbo_nii._exact((bc,), u.device, BF16)
    beta = b_in[1:].permute(1, 0, 2).clone()
    if 0 <= last < n_w:
        bt = turbo_nii._exact((bc,), u.device, BF16)
        for j in (2, 1, 0):
            bt = _beta_step(bt, turbo_nii._gammas(tu[j], tp[j]), wiring)
        beta[:, last] = _renorm(bt)

    segs, h = plan.segments, plan.split
    ck = {}
    staged = {0: [], 1: []}                 # each side's units, in order
    for j in range(h):                      # phase 1, alpha side
        staged[0].append(j)
        lo, hi = segs[j]
        ck[j] = alpha
        for r in range(lo, hi):
            alpha = alpha_step(alpha, gam(r))[0]
            if r % 16 == 15 or r == l - 1:
                alpha = _renorm(alpha)
    for j in range(len(segs) - 1, h - 1, -1):   # phase 1, beta side
        staged[1].append(j)
        lo, hi = segs[j]
        ck[j] = beta
        for r in range(hi - 1, lo - 1, -1):
            beta = _beta_step(beta, gam(r), wiring)
        if lo % 16 == 0:
            beta = _renorm(beta)
    # ---- the sides meet: every checkpoint is written ----
    assert sorted(ck) == list(range(len(segs)))
    ext = torch.empty((n_w, l, bc), dtype=BF16)
    for j in range(h, len(segs)):           # phase 2, alpha side
        staged[0].append(j)
        lo, hi = segs[j]
        rb, bk = ck[j], {}
        for r in range(hi - 1, lo - 1, -1):
            bk[r] = rb
            rb = _beta_step(rb, gam(r), wiring)
        for r in range(lo, hi):
            alpha, br0, br1 = alpha_step(alpha, gam(r))
            ext[:, r] = emit(br0, br1, bk[r], r)
            if r % 16 == 15 or r == l - 1:
                alpha = _renorm(alpha)
    for j in range(h - 1, -1, -1):          # phase 2, beta side
        staged[1].append(j)
        lo, hi = segs[j]
        ra, ak = ck[j], {}
        for r in range(lo, hi):             # no renorm before row hi - 1
            ak[r] = ra
            ra = alpha_step(ra, gam(r))[0]
        for r in range(hi - 1, lo - 1, -1):
            _, br0, br1 = alpha_step(ak[r], gam(r))
            ext[:, r] = emit(br0, br1, beta, r)
            beta = _beta_step(beta, gam(r), wiring)
        if lo % 16 == 0:
            beta = _renorm(beta)
    # each side stages every segment once, in its walking order
    assert staged[0] == list(range(len(segs)))
    assert staged[1] == list(range(len(segs) - 1, -1, -1))
    a_next = torch.zeros((n_w + 1, 8, bc), dtype=BF16)
    a_next[1:] = alpha.permute(1, 0, 2)
    b_next = torch.zeros((n_w + 1, 8, bc), dtype=BF16)
    b_next[:n_w] = beta.permute(1, 0, 2)
    return (ext.reshape(k, bc)[:, :b], a_next[..., :b], b_next[..., :b])


def win_split_model(lsa, lp, *, k, l, o, lead=0):
    """csrc/turbo_win.cu's split kernel in torch: the alpha side trains
    over the O rows before each window and the beta side over the O rows
    after it (rows outside the trellis substituted by index, never
    staged), then the two phases over the window's 8-row segments as in
    ``nii_split_model`` (renormalization after every tile)."""
    plan = win_plan(l, o, BF16)
    b = lsa.shape[1]
    n_w = k // l
    wiring = [torch.as_tensor(a) for a in turbo_nii._wiring_np()]
    ns0, ns1, gi0, gi1, ps0, ps1 = wiring
    sl, sq = staged_pairs(lsa, lead), staged_pairs(lp, lead)
    bc = sl.shape[1]
    pad = torch.full((bc,), turbo_win.PAD_LLR, dtype=BF16)
    zero = torch.zeros((bc,), dtype=BF16)
    half = torch.tensor(0.5, dtype=BF16)

    def gam(rows):                      # trellis row per window: [W]
        ls = torch.stack([sl[r] * half if 0 <= r < k + 3 else pad
                          for r in rows.tolist()])
        lq = torch.stack([sq[r] * half if 0 <= r < k + 3 else zero
                          for r in rows.tolist()])
        g00, g01 = ls + lq, ls - lq
        return torch.stack([g00, g01, -g01, -g00])

    def alpha_step(alpha, g):
        br0, br1 = alpha + g[gi0], alpha + g[gi1]
        return torch.maximum(br0[ps0], br1[ps1]), br0, br1

    def emit(br0, br1, bk):
        return torch.amax(br0 + bk[ns0], 0) - torch.amax(br1 + bk[ns1], 0)

    row0 = torch.arange(n_w) * l
    alpha = torch.zeros((8, n_w, bc), dtype=BF16)
    alpha[1:, 0] = turbo_win.NEG
    beta = torch.zeros((8, n_w, bc), dtype=BF16)
    beta[1:, n_w - 1] = turbo_win.NEG
    g_n = turbo_win.GROUP
    for t in range(o // g_n):               # training tiles, both sides
        for q in range(g_n):
            alpha = alpha_step(alpha, gam(row0 - o + g_n * t + q))[0]
        alpha = _renorm(alpha)
        for q in range(g_n - 1, -1, -1):
            beta = _beta_step(beta, gam(row0 + l + o - g_n * (t + 1) + q),
                              wiring)
        beta = _renorm(beta)
    segs, h = plan.segments, plan.split
    ck = {}
    for j in range(h):
        lo, hi = segs[j]
        ck[j] = alpha
        for r in range(lo, hi):
            alpha = alpha_step(alpha, gam(row0 + r))[0]
        alpha = _renorm(alpha)
    for j in range(len(segs) - 1, h - 1, -1):
        lo, hi = segs[j]
        ck[j] = beta
        for r in range(hi - 1, lo - 1, -1):
            beta = _beta_step(beta, gam(row0 + r), wiring)
        beta = _renorm(beta)
    llr = torch.empty((l, n_w, bc), dtype=BF16)
    for j in range(h, len(segs)):
        lo, hi = segs[j]
        rb, bk = ck[j], {}
        for r in range(hi - 1, lo - 1, -1):
            bk[r] = rb
            rb = _beta_step(rb, gam(row0 + r), wiring)
        for r in range(lo, hi):
            alpha, br0, br1 = alpha_step(alpha, gam(row0 + r))
            llr[r] = emit(br0, br1, bk[r])
        alpha = _renorm(alpha)
    for j in range(h - 1, -1, -1):
        lo, hi = segs[j]
        ra, ak = ck[j], {}
        for r in range(lo, hi):
            ak[r] = ra
            ra = alpha_step(ra, gam(row0 + r))[0]
        for r in range(hi - 1, lo - 1, -1):
            _, br0, br1 = alpha_step(ak[r], gam(row0 + r))
            llr[r] = emit(br0, br1, beta)
            beta = _beta_step(beta, gam(row0 + r), wiring)
        beta = _renorm(beta)
    return llr.transpose(0, 1).reshape(k, bc)[:, :b]


def _bf_draw(rng, *shape, sc=4.0):
    return torch.as_tensor((sc * rng.normal(size=shape)).astype(np.float32)) \
        .to(BF16)


@pytest.mark.parametrize("b,lead", [(5, 0), (64, 1), (67, 1), (70, 0)])
def test_staged_pairs_read_every_column(rng, b, lead):
    """Aligned-word staging read back as pairs gives every real column of
    every row, at even and odd batches and either start within a word."""
    x = _bf_draw(rng, 7, b)
    got = staged_pairs(x, lead)
    assert torch.equal(got[:, :b], x)
    assert got.shape[1] % (2 * PAIRS) == 0


@pytest.mark.parametrize("k,apr,bounds,b", [
    (40, False, None, 3), (40, True, (-1, -1), 2),
    (56, True, None, 5), (56, False, (0, -1), 4),
    (1024, True, None, 3), (1024, False, (-1, 3), 2),
    (1024, True, (0, -1), 65),
    (5760, True, None, 1), (5760, True, (-1, -1), 2),
    (6144, True, None, 3), (6144, False, (-1, 23), 1),
    (1952, True, None, 1),       # no window: the 16-row split schedule
])
def test_nii_split_model_equals_plain_twin(rng, k, apr, bounds, b):
    """The split schedule equals the bfloat16 twin bit for bit: K 40 and
    56 (one window), K 1024, 5760 and 6144 in their decoders' windows,
    with and without apr, the whole trellis and the trellis-sharded bounds
    (0, -1), (-1, -1), (-1, last), odd and even batches, arrays starting
    on and off a word boundary; and K 1952 as one window, whose 8-row
    checkpoints do not fit, on 16-row segments."""
    l = _pick_window(k) or k
    w = k // l
    args = (_bf_draw(rng, k, b), _bf_draw(rng, k, b), _bf_draw(rng, 3, b),
            _bf_draw(rng, 3, b), _bf_draw(rng, w + 1, 8, b, sc=2.0),
            _bf_draw(rng, w + 1, 8, b, sc=2.0))
    kw = dict(l=l, apr=_bf_draw(rng, k, b) if apr else None, bounds=bounds)
    got = nii_split_model(*args, **kw, lead=b % 2)
    ref = map_decode_nii_plain(*args, **kw)
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


@pytest.mark.parametrize("k,l,o,b", [
    (40, 40, DEFAULT_OVERLAP, 3), (56, 56, DEFAULT_OVERLAP, 2),
    (1024, None, DEFAULT_OVERLAP, 5), (1024, None, 24, 66),
    (5760, None, DEFAULT_OVERLAP, 1), (6144, None, DEFAULT_OVERLAP, 2),
])
def test_win_split_model_equals_plain_twin(rng, k, l, o, b):
    """The windowed split schedule equals the bfloat16 twin bit for bit,
    training tiles reaching past both ends of the trellis included, at
    odd and even batches."""
    l = l or _pick_window(k)
    lsa, lp = _bf_draw(rng, k + 3, b), _bf_draw(rng, k + 3, b)
    got = win_split_model(lsa, lp, k=k, l=l, o=o, lead=b % 2)
    assert torch.equal(got, map_decode_win_plain(lsa, lp, k=k, l=l, o=o))


@pytest.mark.parametrize("sms", [H100_SMS, 114])
@pytest.mark.parametrize("kernel", ["nii", "win"])
def test_bf16_plan_rule(kernel, sms):
    """The bfloat16 plans' fixed rule on the launch's shape: the split
    kernel for an odd batch, for arrays off a 4-byte boundary and for
    launches of at most the split limit in blocks (windows x ceil(B /
    64)) per SM of the card; the one-thread kernel (one warp, two code
    blocks per thread) above it. The split kernel stages a lane's pair as
    one aligned word for an even batch on aligned arrays, and as the two
    words it may straddle otherwise. The float32 plans never split."""
    if kernel == "nii":
        plan = lambda *a, **kw: nii_plan(240, True, *a, **kw, sms=sms)
        limit, w = turbo_nii.NII_SPLIT_BLOCKS_PER_SM * sms, 24
    else:
        plan = lambda *a, **kw: win_plan(224, DEFAULT_OVERLAP, *a, **kw,
                                         sms=sms)
        limit, w = turbo_win.WIN_SPLIT_BLOCKS_PER_SM * sms, 26
    big = 64 * (limit // w + 1)                # just above the limit
    assert turbo_nii.split_blocks(w, big) > limit
    assert turbo_nii.split_blocks(w, big - 64) <= limit
    assert plan(BF16, big, w).sides == 1
    assert plan(BF16, big, w).cbs_per_thread == 2
    assert plan(BF16, big, w).threads == 32
    assert not plan(BF16, big, w).shifted
    for cbs, aligned, shifted in ((big - 64, True, False),
                                  (big + 1, True, True),
                                  (big, False, True), (1, True, True),
                                  (None, True, False)):
        got = plan(BF16, cbs, w, aligned)
        assert (got.sides, got.shifted) == (2, shifted), (cbs, aligned)
    assert plan(torch.float32, big + 1, w).sides == 1
    assert plan(torch.float32, 1, w).sides == 1
