"""Port vs JAX reference: the bfloat16 turbo constituent decoders, the
``TurboDecoder.dtype`` rule, and the filler prior of a bfloat16 decode.

The JAX Pallas kernels take their dtype from their input; fed bfloat16,
every add, subtraction, max and halving rounds to bfloat16 (interpret
mode on the CPU, as the JAX package's own tests run them). The port's
plain twins do the same ops in the same order on torch bfloat16 tensors,
whose ops also round per op, so outputs and boundary metrics must be
equal exactly. Inputs are numpy draws from a seed, rounded to bfloat16
on both sides. The full decoders in bfloat16 are held to JAX's in
``tests/test_torch_turbo.py`` (NII), ``test_torch_turbo_win.py`` (v1
windowed) and ``test_torch_turbo_xla.py`` (XLA sweeps).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from empower_srslte_tpu.ops.fec.turbo_decoder import PAD_LLR
from empower_srslte_tpu.ops.fec.turbo_decoder_pallas import (
    fold_lanes, map_decode_fused, pad_trellis_rows, unfold_lanes)
from empower_srslte_tpu.ops.fec.turbo_decoder_pallas2 import (
    map_decode_nii as jax_map_decode_nii, to_tiles)

from empower_srslte_tpu_torch.models import sch
from empower_srslte_tpu_torch.models.sch import (
    DlschPlan, _pick_window, dlsch_decode, dlsch_encode, filler_prior)
from empower_srslte_tpu_torch.ops.fec.turbo_decoder import TurboDecoder
from empower_srslte_tpu_torch.ops.fec.turbo_nii import (
    map_decode_nii, map_decode_nii_plain, nii_plan)
from empower_srslte_tpu_torch.ops.fec.turbo_win import (
    map_decode_win, map_decode_win_plain, win_plan)
from empower_srslte_tpu_torch.runtime import trace

BF16 = torch.bfloat16


def _bf(x):
    """numpy float32 -> the same values rounded to bfloat16, as a JAX
    array and a torch tensor."""
    return jnp.asarray(x).astype(jnp.bfloat16), torch.as_tensor(x).to(BF16)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("apr,bounds", [
    pytest.param(True, None, id="apr-tail_walk"),
    pytest.param(False, (-1, -1), id="no_apr-no_edge")])
def test_nii_bf16_twin_matches_pallas(rng, apr, bounds):
    """ext and both boundary metrics exactly equal to the JAX kernel's in
    bfloat16: with the a-priori add and the last window's tail walk from
    bf16(-1e30), and without apr on a trellis slice with no edge."""
    k, l, b = 256, 64, 16
    w = k // l
    f = lambda *s: (4.0 * rng.normal(size=s)).astype(np.float32)
    u, p, e = f(k, b), f(k, b), f(k, b)
    tu, tp = f(3, b), f(3, b)
    a_st, b_st = f(w + 1, 8, b), f(w + 1, 8, b)
    pad8 = lambda x: np.concatenate([x, np.zeros((5, b), np.float32)])
    rows = lambda x: to_tiles(_bf(x)[0], 1, 8)
    state = lambda x: _bf(x.reshape(w + 1, 8, b // 8, 8, 1)
                          .transpose(2, 0, 1, 3, 4))[0]
    ext_j, a_j, b_j = jax_map_decode_nii(
        rows(u), rows(p), rows(pad8(tu)), rows(pad8(tp)), state(a_st),
        state(b_st), l=l, lanes=1, interpret=True,
        apr=rows(e) if apr else None,
        bounds=None if bounds is None else jnp.asarray(bounds, jnp.int32))

    t = lambda x: _bf(x)[1]
    ext, a_n, b_n = map_decode_nii(t(u), t(p), t(tu), t(tp), t(a_st),
                                   t(b_st), l=l, apr=t(e) if apr else None,
                                   bounds=bounds)
    assert ext.dtype == a_n.dtype == b_n.dtype == BF16
    np.testing.assert_array_equal(
        ext.float().numpy(), _np(ext_j).transpose(1, 0, 2, 3).reshape(k, b))
    for got, want in ((a_n, a_j), (b_n, b_j)):
        np.testing.assert_array_equal(
            got.float().numpy(),
            _np(want).transpose(1, 2, 0, 3, 4).reshape(w + 1, 8, b))


def test_win_bf16_twin_matches_pallas(rng):
    """The windowed kernel's twin in bfloat16 against ``map_decode_fused``
    on bfloat16 rows prepared as the JAX v1 decoder prepares them
    (halved, then padded with ``PAD_LLR`` as bfloat16 99,840): equal
    exactly."""
    k, b, o = 192, 8, 40
    l = _pick_window(k)
    lsa = (4.0 * rng.normal(size=(k + 3, b))).astype(np.float32)
    lp = (4.0 * rng.normal(size=(k + 3, b))).astype(np.float32)
    prep = lambda x, pad: fold_lanes(pad_trellis_rows(_bf(x)[0] * 0.5, o,
                                                      pad))
    assert float(jnp.full((1,), PAD_LLR, jnp.bfloat16)[0]) == 99840.0
    want = unfold_lanes(map_decode_fused(prep(lsa, PAD_LLR), prep(lp, 0.0),
                                         k, l, o, lanes=1, interpret=True))
    got = map_decode_win(_bf(lsa)[1], _bf(lp)[1], k=k, l=l, o=o)
    assert got.dtype == BF16 and got.shape == (k, b)
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


def test_auto_resolves_as_jax_on_its_accelerator():
    """``"auto"`` is bfloat16 for the kernel decoders with a window and
    float32 for ``"xla"`` and for a K without a window; the DL-SCH plans
    carry it unchanged."""
    rule = {("nii", 256): BF16, ("windowed", 256): BF16,
            ("xla", 256): torch.float32, ("nii", None): torch.float32,
            ("windowed", None): torch.float32, ("xla", None): torch.float32}
    for (impl, window), want in rule.items():
        assert TurboDecoder(k=1024, window=window,
                            impl=impl).metric_dtype == want, (impl, window)
        for name in ("float32", "bfloat16"):
            assert TurboDecoder(k=1024, window=window, impl=impl,
                                dtype=name).metric_dtype == getattr(torch,
                                                                    name)
    with pytest.raises(ValueError):
        TurboDecoder(k=40, dtype="float16")
    assert DlschPlan(tbs=1000, g=3000, qm=2).decoder(1024).metric_dtype \
        == BF16
    # Msg3's K 280 and K 40 have no window: one float32 NII window
    assert _pick_window(280) is None and _pick_window(40) is None
    for k in (40, 280):
        assert DlschPlan(tbs=1000, g=3000, qm=2, decoder_impl="windowed") \
            .decoder(k).metric_dtype == torch.float32


def test_bf16_wrappers_on_cpu(rng):
    """On CPU tensors the wrappers run the bfloat16 twins (no launch
    counted), refuse mixed dtypes, and give the bfloat16 plans the split
    kernels' geometry: two warps over 32 code block pairs, one thread per
    code block, a checkpoint per segment on chip, the alpha side starting
    on the lower half. An odd batch goes through as it is, with no
    padding: each code block's outputs equal its own decode alone."""
    k, l, b = 128, 64, 5
    x = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32)
                                   * 3).to(BF16)
    args = (x(k, b), x(k, b), x(3, b), x(3, b), x(3, 8, b), x(3, 8, b))
    apr = x(k, b)
    before = trace.launch_counts()
    got = map_decode_nii(*args, l=l, apr=apr)
    assert trace.launch_counts() == before
    assert all(g.dtype == BF16 and g.shape[-1] == b for g in got)
    for j in (0, b - 1):
        one = map_decode_nii_plain(*(a[..., j:j + 1].contiguous()
                                     for a in args), l=l,
                                   apr=apr[:, j:j + 1].contiguous())
        for r, o in zip(got, one):
            assert torch.equal(r[..., j:j + 1], o)
    with pytest.raises(TypeError):
        map_decode_nii(args[0].float(), *args[1:], l=l)

    lsa, lp = x(k + 3, b), x(k + 3, b)
    before = trace.launch_counts()
    out = map_decode_win(lsa, lp, k=k, l=l, o=24)
    assert trace.launch_counts() == before
    assert out.dtype == BF16 and out.shape == (k, b)
    assert torch.equal(out[:, b - 1:], map_decode_win_plain(
        lsa[:, b - 1:].contiguous(), lp[:, b - 1:].contiguous(), k=k, l=l,
        o=24))
    with pytest.raises(TypeError):
        map_decode_win(lsa.float(), lp, k=k, l=l, o=24)

    for plan32, plan16, nseg in (
            (nii_plan(240, True), nii_plan(240, True, BF16), 30),
            (win_plan(224, 40), win_plan(224, 40, BF16), 28)):
        assert (plan32.threads, plan32.cbs_per_thread, plan32.sides) == \
            (32, 1, 1)
        assert (plan16.threads, plan16.cbs_per_thread, plan16.sides) == \
            (64, 2, 2)
        assert plan16.threads_per_cb == plan32.threads_per_cb == 1.0
        assert [hi - lo for lo, hi in plan16.segments] == [8] * nseg
        assert plan16.split == nseg // 2
        assert len(plan16.checkpoints) == nseg
    assert nii_plan(240, True).smem == 26_624          # unchanged
    assert nii_plan(240, True, BF16).smem == 30 * 1024 + 2 * 2 * 8 * 3 * 32 * 4
    assert win_plan(224, 40, BF16, 5).smem == \
        28 * 1024 + 2 * 2 * 8 * 2 * 33 * 4              # an odd batch


class _F32Plan(DlschPlan):
    """The same plan with its decoders pinned to float32."""

    def decoder(self, k):
        return dataclasses.replace(super().decoder(k), dtype="float32")


def _f32(plan):
    return _F32Plan(**{f.name: getattr(plan, f.name)
                       for f in dataclasses.fields(plan)})


@pytest.mark.parametrize("tbs", [992, 6000])
def test_bf16_filler_prior_decodes_as_f32(rng, tbs, monkeypatch):
    """A TB whose segmentation has filler bits (TBS 992: one code block of
    K 1024 with F 8; TBS 6000: K 6080 with F 56). The default bfloat16
    decode, with the prior scaled to the data, passes every CRC with the
    float32 decode's bits. The float32 decode's fixed 1e4 prior, given to
    the bfloat16 decoder, fails every TB there (as the JAX package's
    sch.py:592-599 says: its offset swamps the metrics' bfloat16 ulp)."""
    plan = DlschPlan(tbs=tbs, g=3 * (tbs + 24) + 300, qm=2)
    seg = plan.segm
    assert seg.f > 0 and plan.decoder(seg.cb_sizes[0]).metric_dtype == BF16
    tb = torch.as_tensor(rng.integers(0, 2, (4, tbs)).astype(np.int8))
    coded = dlsch_encode(tb, plan).to(torch.float32)
    llr = 2.0 * (1.0 - 2.0 * coded + torch.as_tensor(
        rng.normal(size=coded.shape).astype(np.float32)))
    prior = filler_prior(llr, plan)
    assert prior.shape == (4,) and prior.dtype == torch.float32
    c_f = min(8.0, 128.0 / seg.f)
    assert torch.allclose(prior, c_f * llr.abs().mean(-1))
    assert filler_prior(llr, _f32(plan)) is None

    bits, ok, _ = dlsch_decode(llr, plan)
    bits32, ok32, _ = dlsch_decode(llr, _f32(plan))
    assert ok.all() and ok32.all()
    assert torch.equal(bits, bits32) and torch.equal(bits, tb)

    monkeypatch.setattr(sch, "filler_prior", lambda *a: None)
    _, ok_1e4, _ = dlsch_decode(llr, plan)
    assert not ok_1e4.any(), "the 1e4 prior no longer breaks bfloat16"
