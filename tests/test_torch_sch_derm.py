"""The de-rate-matching kernel (csrc/sch_derm.cu) on the CPU: its plain
twin (``rate_matching._derm_to_decoder_plain``) against the chain it
replaced, bit for bit (the softbuffer and the turbo decoder's four
time-major inputs); the kernel's own index arithmetic (the inverse
circles laid out by interleaver column, the tail de-permutation read from
the kernel's source) emulated in PyTorch on the table the wrapper
uploads; ``TurboDecoder.decode`` against ``decode_prepared(*prepare())``;
``dlsch_decode`` against the code before the kernel; and the wrapper's
launch and refusals with a fake launcher. The kernel itself runs only on
a CUDA card, where ``chip_smoke.py --phases sch_derm`` holds it to the
twin at every shape the receive paths give it.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np
import pytest
import torch

from empower_srslte_tpu_torch.models import sch
from empower_srslte_tpu_torch.models.sch import DlschPlan, filler_prior
from empower_srslte_tpu_torch.ops.fec import rate_matching as rm
from empower_srslte_tpu_torch.ops.fec.turbo_decoder import TurboDecoder
from empower_srslte_tpu_torch.runtime import trace
from empower_srslte_tpu_torch.utils.crc import CRC24A, CRC24B

from tests.torch_fake_launch import fake_launches

SRC = (pathlib.Path(rm.__file__).resolve().parents[2] / "csrc"
       / "sch_derm.cu").read_text()

#: name -> (plan, leading dims, LLR dtype, softbuffer, what it covers)
CASES = {
    # the cells' codeword: 13 CBs of K 5824, E 6,642 (4) and 6,648 (9)
    "k5824_e6642_e6648": (DlschPlan(tbs=75376, g=86400, qm=6), (2, 2),
                          torch.float32, False),
    # Msg3's K 280 with E > N_cb: two and three repetitions
    "msg3_k280_e1152": (DlschPlan(tbs=256, g=1152, qm=2), (3,),
                        torch.float32, False),
    "k280_three_reps": (DlschPlan(tbs=256, g=1852, qm=2), (2,),
                        torch.float32, False),
    # F 4 at K 128: bfloat16 metrics (``filler_prior``), float32 ("xla":
    # FILLER_LLR)
    "filler_bf16_prior": (DlschPlan(tbs=100, g=480, qm=2), (3,),
                          torch.float32, False),
    "filler_f32": (DlschPlan(tbs=100, g=480, qm=2, decoder_impl="xla"),
                   (3,), torch.float32, False),
    "softbuffer": (DlschPlan(tbs=1000, g=2400, qm=4, rv=2), (2,),
                   torch.float32, True),
    "int8_softbuffer": (DlschPlan(tbs=256, g=1852, qm=2, rv=1), (2,),
                        torch.int8, True),
    "int8": (DlschPlan(tbs=100, g=480, qm=2), (4,), torch.int8, False),
    # K- 3072 (F 8) and K+ 3136
    "k_minus_k_plus": (DlschPlan(tbs=6128, g=9000, qm=4, rv=3), (2,),
                       torch.float32, False),
    **{f"rv{rv}": (DlschPlan(tbs=1000, g=1500, qm=2, rv=rv), (2,),
                   torch.float32, False) for rv in range(4)},
}


def _llrs(plan, lead, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((*lead, plan.g), generator=g) * 3
    if dtype == torch.int8:
        # near full scale, so that repetitions and the HARQ add saturate
        return torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
    return x


def _softbuffers(plan, lead, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    out = []
    for k, _e, _f, _off in plan.cb_plans:
        x = torch.randn((*lead, 3 * (k + 4)), generator=g) * 2
        out.append(torch.clamp(torch.round(x * 50), -127, 127)
                   .to(torch.int8) if dtype == torch.int8 else x)
    return out


def chain_before(llrs, plan, k, softbuffers=None):
    """The code before the kernel for the code blocks of size ``k``:
    ``dlsch_decode``'s de-rate-matching (per (K, E, F) group, the groups
    concatenated) and ``TurboDecoder.decode``'s input preparation (the
    cast, the stream split, the transposes). -> ({CB index: softbuffer},
    (sys1, par1, sys2's tail, par2, lead))."""
    prior = filler_prior(llrs, plan)
    groups: dict = {}
    for idx, (kk, e, f, off) in enumerate(plan.cb_plans):
        groups.setdefault((kk, e, f), []).append((idx, off))
    items = []
    for (kk, e, f), members in groups.items():
        if kk != k:
            continue
        seg = torch.stack([llrs[..., off:off + e] for _, off in members],
                          dim=-2)
        sb = (torch.stack([softbuffers[idx] for idx, _ in members], dim=-2)
              if softbuffers is not None else None)
        d_llr, ns = plan.rm(kk, f).rx(seg, plan.rv, softbuffer=sb,
                                      filler=prior)
        items.append((members, d_llr, ns))
    d_all = (torch.cat([d for _m, d, _n in items], dim=-3)
             if len(items) > 1 else items[0][1])
    soft = {idx: ns[..., j, :] for members, _d, ns in items
            for j, (idx, _off) in enumerate(members)}
    dec = plan.decoder(k)
    d_all = d_all.to(dec.metric_dtype)
    sys1, par1, sys2_tail, par2 = dec._split_streams(d_all)
    lead = sys1.shape[:-1]
    b = int(np.prod(lead))
    tm = lambda x: x.reshape(b, x.shape[-1]).t().contiguous()
    return soft, (tm(sys1), tm(par1), tm(sys2_tail), tm(par2), lead)


def dlsch_decode_before(llrs, plan, softbuffers=None):
    """``models/sch.py dlsch_decode`` before the kernel, on
    ``chain_before`` and ``TurboDecoder.decode``'s iterations."""
    segm = plan.segm
    stop_crc = (CRC24B if segm.c > 1 else CRC24A) if plan.early_stop else None
    new_soft, cb_bits, ok = [None] * segm.c, [None] * segm.c, []
    for k, members in plan.k_groups.items():
        soft, inputs = chain_before(llrs, plan, k, softbuffers)
        bits, _ = plan.decoder(k).decode_prepared(*inputs, crc=stop_crc)
        for j, (idx, _e, f, _off) in enumerate(members):
            new_soft[idx] = soft[idx]
            b = bits[..., j, :]
            if segm.c > 1:
                ok.append(CRC24B.check(b))
                cb_bits[idx] = b[..., f:k - 24]
            else:
                cb_bits[idx] = b[..., f:]
    full = torch.cat(cb_bits, dim=-1)
    tb_ok = CRC24A.check(full) & torch.any(full != 0, dim=-1)
    for o in ok:
        tb_ok = tb_ok & o
    return full[..., :plan.tbs], tb_ok, new_soft


def _derm(llrs, plan, k, softbuffers=None, fn=rm.derm_to_decoder):
    members = plan.k_groups[k]
    sb = (torch.stack([softbuffers[idx] for idx, *_ in members], dim=-2)
          if softbuffers is not None else None)
    return fn(llrs, tuple((e, f, off) for _i, e, f, off in members),
              plan.rv, plan.decoder(k), sb, filler_prior(llrs, plan))


def _tail_tables():
    """TAIL_ARRAY and TAIL_ROW as the kernel's source declares them."""
    out = []
    for name in ("TAIL_ARRAY", "TAIL_ROW"):
        body = re.search(name + r"\[3\]\[4\] = (\{[^;]*\});", SRC).group(1)
        out.append(np.array([int(v) for v in re.findall(r"-?\d+", body)])
                   .reshape(3, 4))
    return out


def emulate(llrs, cbs, rv, decoder, softbuffer=None, prior=None):
    """The kernel's arithmetic in PyTorch, fed ``derm_table`` as the
    wrapper uploads it: each position of each stream read through its
    interleaver column's inverse circle, its repetitions added in
    ascending order from 0, the softbuffer added and (int8) saturated,
    the prior put on stream 0's filler bits, and each stream position
    written to its decoder row (the tails by the kernel's own tables).
    -> ``derm_to_decoder``'s results."""
    k, c = decoder.k, len(cbs)
    tab = rm.derm_table(k, rv, cbs)
    d = k + 4
    r_ = -(-d // 32)
    nd = 32 * r_ - d
    lead = llrs.shape[:-1]
    rows = int(np.prod(lead))
    x = llrs.reshape(rows, -1)
    int8 = llrs.dtype == torch.int8
    acc_t = torch.int32 if int8 else torch.float32
    soft = torch.zeros((rows, c, 3 * d), dtype=llrs.dtype)
    out = torch.zeros((3 * d + 3, rows * c), dtype=torch.float32)
    tail_array, tail_row = _tail_tables()
    sb = None if softbuffer is None else softbuffer.reshape(rows, c, 3 * d)
    pr = (torch.full((rows,), float(rm.FILLER_LLR_INT8 if int8
                                    else rm.FILLER_LLR))
          if prior is None else prior.reshape(rows).float())
    y = np.arange(32 * r_)
    y = y[y >= nd]
    t = y - nd
    for j in range(c):
        off, e, n, start, f = (int(v) for v in tab[5 * j:5 * j + 5])
        for s in range(3):
            inv = tab[start + s * 32 * r_:start + (s + 1) * 32 * r_]
            i = torch.as_tensor(inv.reshape(32, r_)[y % 32, y // 32],
                                dtype=torch.int64)
            v = torch.zeros((rows, len(t)), dtype=acc_t)
            for rep in range(-(-e // n)):
                q = i + rep * n
                m = (i >= 0) & (q < e)
                v[:, m] = v[:, m] + x[:, off + q[m]].to(acc_t)
            p = s * d + t
            if sb is not None:
                v = v + sb[:, j, p].to(acc_t)
            if int8:
                v = torch.clamp(v, -127, 127)
            soft[:, j, p] = v.to(llrs.dtype)
            v = v.to(torch.float32)
            if s == 0:
                v[:, t < f] = pr[:, None]
            dest = s * d + t
            for jj in range(4):
                arr = tail_array[s][jj]
                dest = np.where(t == k + jj, arr * d + (k if arr < 3 else 0)
                                + tail_row[s][jj], dest)
            out[torch.as_tensor(dest)[:, None],
                (torch.arange(rows) * c + j)[None, :]] = v.t()
    out = out.to(decoder.metric_dtype)
    return soft.reshape(*lead, c, 3 * d), (
        out[:k + 3], out[d:d + k + 3], out[3 * d:], out[2 * d:2 * d + k + 3],
        (*lead, c))


def _max_reps(plan, k):
    n = 3 * (k + 4)
    return max(-(-e // (n - 2 * f)) for _i, e, f, _o in plan.k_groups[k])


def _assert_same(got, want, exact=True):
    soft, inputs = got
    soft_w, inputs_w = want
    if isinstance(soft_w, dict):
        members = list(soft_w)
        soft_w = torch.stack([soft_w[i] for i in members], dim=-2)
    assert soft.dtype == soft_w.dtype and soft.shape == soft_w.shape
    names = ("sys1", "par1", "sys2_tail", "par2")
    for name, a, b in zip(names, inputs[:4], inputs_w[:4]):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if exact:
            assert torch.equal(a, b), name
        else:
            # the float32 sums of 3+ repetitions round in another order:
            # at most one bfloat16 step of the inputs' scale apart
            tol = 2.0 ** -7 * float(b.float().abs().max())
            assert float((a.float() - b.float()).abs().max()) <= tol, name
    if exact:
        assert torch.equal(soft, soft_w)
    else:
        tol = 1e-6 * float(soft_w.abs().max())
        assert float((soft - soft_w).abs().max()) <= tol
    assert tuple(inputs[4]) == tuple(inputs_w[4])


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_equals_the_chain_before_the_kernel(case):
    """The twin's softbuffer and decoder inputs equal the old chain's, bit
    for bit, for every K of the plan."""
    plan, lead, dtype, with_sb = CASES[case]
    llrs = _llrs(plan, lead, dtype)
    sbs = _softbuffers(plan, lead, dtype) if with_sb else None
    for k in plan.k_groups:
        _assert_same(_derm(llrs, plan, k, sbs),
                     chain_before(llrs, plan, k, sbs))


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_arithmetic_reproduces_the_twin(case):
    """The kernel's gather, run in PyTorch on the uploaded table, equals
    the twin exactly wherever the repetitions add in the same order (at
    most two, or integers on the int8 lane), and within rounding
    elsewhere."""
    plan, lead, dtype, with_sb = CASES[case]
    llrs = _llrs(plan, lead, dtype, seed=3)
    sbs = _softbuffers(plan, lead, dtype, seed=4) if with_sb else None
    for k in plan.k_groups:
        exact = dtype == torch.int8 or _max_reps(plan, k) <= 2
        _assert_same(_derm(llrs, plan, k, sbs, fn=emulate),
                     _derm(llrs, plan, k, sbs), exact=exact)


def test_some_case_repeats_three_times_and_saturates():
    plan = CASES["k280_three_reps"][0]
    assert _max_reps(plan, 280) == 3
    plan8, lead, dtype, _ = CASES["int8_softbuffer"]
    llrs = _llrs(plan8, lead, dtype)
    soft, _ = _derm(llrs, plan8, 280, _softbuffers(plan8, lead, dtype))
    assert int(soft.abs().max()) == 127


def test_derm_table_holds_each_circle_once():
    plan = CASES["k_minus_k_plus"][0]
    for k, members in plan.k_groups.items():
        cbs = tuple((e, f, off) for _i, e, f, off in members)
        tab = rm.derm_table(k, plan.rv, cbs)
        kp = 32 * -(-(k + 4) // 32)
        for j, (e, f, off) in enumerate(cbs):
            o, ee, n, start, ff = tab[5 * j:5 * j + 5]
            assert (o, ee, ff) == (off, e, f)
            inv = tab[start:start + 3 * kp]
            assert n == 3 * (k + 4) - 2 * f
            assert sorted(inv[inv >= 0]) == list(range(n))
        assert len(tab) == 5 * len(cbs) + 3 * kp * len({f for _e, f, _o
                                                       in cbs})


@pytest.mark.parametrize("impl", ["nii", "windowed", "xla"])
def test_decode_is_decode_prepared_of_prepare(impl):
    k = 128
    dec = TurboDecoder(k=k, window=64, impl=impl, iterations=2)
    g = torch.Generator().manual_seed(5)
    d_llr = torch.randn((2, 3, 3, k + 4), generator=g) * 2
    bits, llr = dec.decode(d_llr, crc=CRC24B)
    bits2, llr2 = dec.decode_prepared(*dec.prepare(d_llr), crc=CRC24B)
    assert bits.shape == (2, 3, k) and llr.dtype == dec.metric_dtype
    assert torch.equal(bits, bits2) and torch.equal(llr, llr2)


@pytest.mark.parametrize("case", ["filler_bf16_prior", "softbuffer",
                                  "int8_softbuffer", "rv1"])
def test_dlsch_decode_equals_the_code_before_the_kernel(case):
    plan, lead, dtype, with_sb = CASES[case]
    g = torch.Generator().manual_seed(7)
    tb = torch.randint(0, 2, (*lead, plan.tbs), generator=g)
    cw = sch.dlsch_encode(tb, plan).float()
    llrs = (1 - 2 * cw) * 2 + torch.randn(cw.shape, generator=g)
    if dtype == torch.int8:
        llrs = torch.clamp(torch.round(llrs * 20), -127, 127).to(dtype)
    sbs = _softbuffers(plan, lead, dtype) if with_sb else None
    bits, ok, soft = sch.dlsch_decode(llrs, plan, softbuffers=sbs)
    bits_w, ok_w, soft_w = dlsch_decode_before(llrs, plan, sbs)
    assert torch.equal(bits, bits_w) and torch.equal(ok, ok_w)
    assert len(soft) == len(soft_w) == plan.segm.c
    assert all(torch.equal(a, b) for a, b in zip(soft, soft_w))
    if not with_sb and plan.rv == 0:
        assert bool(ok.all()) and torch.equal(bits, tb.to(bits.dtype))


def test_no_launch_without_a_card():
    plan, lead, dtype, _ = CASES["k_minus_k_plus"]
    trace.reset()
    for k in plan.k_groups:
        _derm(_llrs(plan, lead, dtype), plan, k)
    assert trace.launch_counts() == {}


def test_one_launch_a_k_with_the_llrs_row_stride(monkeypatch):
    """On the card's path (the launches recorded, not made): one launch
    a K, a column slice of a wider array passed with its row stride and
    not copied, the table and the outputs' shapes as the kernel takes
    them, each launch counted under its shape."""
    plan, lead, dtype, _ = CASES["k_minus_k_plus"]
    wide = torch.zeros((*lead, plan.g + 37))
    llrs = wide[..., 37:]
    monkeypatch.setattr(rm, "_on_card", lambda t: True)
    launched = fake_launches(monkeypatch, rm.SCH_DERM)
    trace.reset()
    try:
        results = {k: _derm(llrs, plan, k) for k in plan.k_groups}
        counts, shapes = (trace.launch_counts(),
                          trace.launch_shapes("sch_derm"))
    finally:
        trace.reset()
    assert counts == {"sch_derm": 2} and len(launched) == 2
    for (name, _dev, args), (k, members) in zip(launched,
                                                plan.k_groups.items()):
        (ptr, int8, stride, rows, c, tab, sb_in, sb_out, prior, const,
         out, bf16, kk) = args[:-1]
        assert name == "sch_derm" and kk == k and c == len(members)
        assert ptr == llrs.data_ptr() and stride == plan.g + 37
        # F 8 under bfloat16: the per-row prior, one float32 a row
        assert (rows, int8, sb_in) == (2, 0, None) and prior is not None
        assert const == rm.FILLER_LLR and bf16 == 1
        soft, (sys1, par1, tail, par2, lead_c) = results[k]
        assert sb_out == soft.data_ptr() and out == sys1.data_ptr()
        assert soft.shape == (*lead, c, 3 * (k + 4))
        assert sys1.shape == par1.shape == par2.shape == (k + 3, 2 * c)
        assert tail.shape == (3, 2 * c) and lead_c == (*lead, c)
        assert all(x.data_ptr() % 4 == 0 for x in (sys1, par1, tail, par2))
        assert sys1.dtype == torch.bfloat16
        cbs = tuple((e, f, off) for _i, e, f, off in members)
        assert (k, plan.rv, cbs, 2, "float32", "bfloat16", False,
                True) in shapes


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    plan, lead, dtype, _ = CASES["softbuffer"]
    llrs = _llrs(plan, lead, dtype)
    (k, members), = plan.k_groups.items()
    cbs = tuple((e, f, off) for _i, e, f, off in members)
    dec = plan.decoder(k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rm.derm_to_decoder_cuda(llrs, cbs, plan.rv, dec)
    monkeypatch.setattr(rm, "_on_card", lambda t: True)
    launched = fake_launches(monkeypatch, rm.SCH_DERM)
    sb = torch.zeros((*lead, len(cbs), 3 * (k + 4)))
    refusals = [
        ("float32 or int8", dict(llrs=llrs.double())),
        ("reach past", dict(llrs=llrs[..., :-1])),
        ("softbuffer", dict(softbuffer=sb.to(torch.int8))),
        ("softbuffer", dict(softbuffer=sb[..., :-1])),
        ("prior shape", dict(prior=torch.ones(5))),
    ]
    for match, kw in refusals:
        args = dict(llrs=llrs, softbuffer=None, prior=None) | kw
        with pytest.raises(ValueError, match=match):
            rm.derm_to_decoder_cuda(args["llrs"], cbs, plan.rv, dec,
                                    args["softbuffer"], args["prior"])
    with pytest.raises(ValueError, match="code blocks"):
        rm.derm_to_decoder_cuda(llrs, (), plan.rv, dec)
    assert launched == []


def test_dlsch_decode_launches_once_a_k_inside_dlsch_derm(monkeypatch):
    """On the card's path (the launch recorded, not made), ``dlsch_decode``
    launches the kernel once for each K of the plan, inside the range
    ``dlsch.derm`` and no other."""
    import contextlib

    plan, lead, dtype, _ = CASES["filler_bf16_prior"]
    llrs = _llrs(plan, lead, dtype)
    open_spans: list = []

    @contextlib.contextmanager
    def span(name):
        open_spans.append(name)
        try:
            yield
        finally:
            open_spans.pop()

    monkeypatch.setattr(sch.trace, "span", span)
    monkeypatch.setattr(rm, "_on_card", lambda t: True)
    launched = fake_launches(monkeypatch, rm.SCH_DERM)
    inside = []
    monkeypatch.setattr(rm.SCH_DERM, "_fn",
                        lambda *a: inside.append(list(open_spans)) or 0)
    trace.reset()
    try:
        sch.dlsch_decode(llrs, plan)
        counts = trace.launch_counts()
    finally:
        trace.reset()
    assert launched == [] and counts == {"sch_derm": len(plan.k_groups)}
    assert inside == [["dlsch.derm"]] * len(plan.k_groups)
