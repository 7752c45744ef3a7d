"""The two turbo kernels' checkpoint-and-recompute schedule, on the CPU.

The CUDA kernels ``csrc/turbo_nii.cu`` and ``csrc/turbo_win.cu`` keep no
beta store in device memory: the backward sweep keeps the carry entering
each segment, and the forward sweep recomputes a segment's betas from it.
These tests check (a) that the wrappers' launch plans fit every window the
decoders use into one block's shared memory, with segments that tile the
window on renormalization-group boundaries, and (b) that a torch model of
the kernels' schedule, written here unit by unit as the kernels run it,
equals the unchanged plain twins bit for bit.
"""

import numpy as np
import pytest
import torch

from empower_srslte_tpu_torch.models.sch import _pick_window
from empower_srslte_tpu_torch.ops.fec import turbo_nii, turbo_win
from empower_srslte_tpu_torch.ops.fec.tables import TURBO_CB_SIZES
from empower_srslte_tpu_torch.ops.fec.turbo_nii import (
    MAX_SMEM, map_decode_nii_plain, nii_plan)
from empower_srslte_tpu_torch.ops.fec.turbo_win import (
    DEFAULT_OVERLAP, map_decode_win_plain, win_plan)


def _check_segments(plan, l, group):
    """Segments tile [0, l), each of at most one group, starting on a
    renormalization-group boundary."""
    segs = plan.segments
    assert segs[0][0] == 0 and segs[-1][1] == l
    for (lo, hi), (lo2, _) in zip(segs, segs[1:]):
        assert hi == lo2, "segments must tile the window"
    assert all(lo % group == 0 for lo, _ in segs), "checkpoints off-group"
    assert all(0 < hi - lo <= group for lo, hi in segs)
    assert plan.checkpoints == tuple(hi - 1 for _, hi in segs[1:])


@pytest.mark.parametrize("kernel", ["nii", "win"])
def test_launch_plans_fit_every_code_block_size(kernel):
    """Every K of the QPP table with its decoder window (NII: the whole
    trellis where ``_pick_window`` finds none) fits one block."""
    assert len(TURBO_CB_SIZES) == 188
    for k in TURBO_CB_SIZES:
        l = _pick_window(k)
        if kernel == "nii":
            l = l or k
            for apr in (True, False):
                plan = nii_plan(l, apr)
                assert plan.smem <= MAX_SMEM, (k, l, plan.smem)
                _check_segments(plan, l, turbo_nii.GROUP)
        elif l is not None:
            for o in (24, DEFAULT_OVERLAP):
                plan = win_plan(l, o)
                assert plan.smem <= MAX_SMEM, (k, l, plan.smem)
                _check_segments(plan, l, turbo_win.GROUP)


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
    wiring = [torch.as_tensor(a) for a in turbo_win._wiring_np()]
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
