"""Port vs JAX reference: the SRS (``tests/test_ul_hopping.py``'s cases),
``ue_ul_generate`` with PUCCH, SRS, CFO pre-compensation and timing
advance, ``ue_ul_pusch_jit``, the channel models of ops/channel.py, and
the busy control TTI and Msg3 stimuli of the chip run.

Host tables are equal; grids to 1e-6; samples through an IFFT in two
libraries to 1e-5. With a CFO the samples agree to 1e-4: JAX builds the
phase 2 pi cfo n / fft in float32, the port reduces it in float64 first
(as ``tests/test_torch_sync.py`` compares ``cfo_correct``). The AWGN of
``awgn`` draws from a torch generator where JAX's draws from a key, so it
is checked by its statistics, and ``awgn_np`` / ``rayleigh_taps``, which
take the same numpy generator, are equal.

The port's DMRS and SC-FDMA follow TS 36.211 5.5.2.1.1 and 5.6, where the
JAX package's depart from it: every test here runs with those JAX stages
replaced by the specification's (``tests/jax_ul_spec.py``), every other
JAX stage as it is.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from empower_srslte_tpu.models import pucch as jp
from empower_srslte_tpu.models import pusch as jpusch
from empower_srslte_tpu.models import ra as jra
from empower_srslte_tpu.models import refsignal_ul as jrs
from empower_srslte_tpu.models import ue_ul as jue
from empower_srslte_tpu.ops import channel as jch
from empower_srslte_tpu.utils.cell import Cell as JCell

from empower_srslte_tpu_torch import convert
from empower_srslte_tpu_torch.models import pucch as pp
from empower_srslte_tpu_torch.models.pusch import pusch_decode
from empower_srslte_tpu_torch.models.sch import _pick_window
from empower_srslte_tpu_torch.models import refsignal_ul as rs
from empower_srslte_tpu_torch.models import ue_ul
from empower_srslte_tpu_torch.ops import channel
from empower_srslte_tpu_torch.utils.cell import Cell

from tests.jax_ul_spec import spec_uplink


@pytest.fixture(scope="module", autouse=True)
def _spec_uplink():
    """The JAX package's PUSCH DMRS and SC-FDMA pair held to TS 36.211,
    as the port's are (``tests/jax_ul_spec.py``)."""
    with spec_uplink():
        yield


def _c(x):
    return np.asarray(x).astype(np.complex64)


@pytest.mark.parametrize("cell_id", [7, 150])
def test_srs_sequence_matches_jax(cell_id):
    c, jc = Cell(nof_prb=25, id=cell_id), JCell(nof_prb=25, id=cell_id)
    for gh in (False, True):
        for sf in (0, 1, 7):
            for n_prb, cs in ((4, 0), (8, 3), (24, 7)):
                np.testing.assert_array_equal(
                    rs.srs_sequence(c, n_prb, cs, sf_idx=sf,
                                    group_hopping=gh),
                    jrs.srs_sequence(jc, n_prb, cs, sf_idx=sf,
                                     group_hopping=gh))
    # group hopping moves the sequence group between subframes
    s0 = rs.srs_sequence(c, 4, sf_idx=0, group_hopping=True)
    s1 = rs.srs_sequence(c, 4, sf_idx=1, group_hopping=True)
    assert not np.allclose(s0, s1)


def test_srs_put_and_chest_match_jax(rng):
    c, jc = Cell(nof_prb=25, id=7), JCell(nof_prb=25, id=7)
    grid = (rng.normal(size=(3, 14, 300))
            + 1j * rng.normal(size=(3, 14, 300))).astype(np.complex64)
    for kw in (dict(n_prb_srs=8, prb_start=2, comb=1, cyclic_shift=3),
               dict(n_prb_srs=24, prb_start=0, comb=0, cyclic_shift=0)):
        got = rs.srs_put(torch.as_tensor(grid), c, **kw)
        want = jrs.srs_put(jnp.asarray(grid), jc, **kw)
        np.testing.assert_array_equal(got.numpy(), _c(want))
        np.testing.assert_allclose(rs.srs_chest(got, c, **kw).numpy(),
                                   _c(jrs.srs_chest(want, jc, **kw)),
                                   rtol=1e-6, atol=1e-6)
    # the LS estimate of a flat channel is the channel
    h = 0.7 - 0.2j
    g = rs.srs_put(torch.zeros((14, 300), dtype=torch.complex64), c, 24)
    np.testing.assert_allclose(rs.srs_chest(g * h, c, 24).numpy(), h,
                               rtol=1e-5)


@pytest.mark.parametrize("fmt,payload,ack", [
    ("1", (1,), ()), ("1a", (0,), ()), ("1b", (1, 0), ()),
    ("2", (1, 0, 1, 1), ()), ("2a", (0, 1, 1, 0, 1), (1,)),
    ("2b", (1, 1, 0, 0, 1, 0, 1), (0, 1))])
def test_ue_ul_generate_pucch_matches_jax(fmt, payload, ack):
    c, jc = Cell(nof_prb=6, id=3), JCell(nof_prb=6, id=3)
    kw = dict(sf_idx=4, n_pucch=5, format=fmt, n_rb_2=1)
    pucch = (pp.PucchConfig(cell=c, **kw), np.asarray(payload, np.int8))
    jpucch = (jp.PucchConfig(cell=jc, **kw), np.asarray(payload, np.int8))
    if ack:
        pucch, jpucch = pucch + (ack,), jpucch + (ack,)
    got = ue_ul.ue_ul_generate(c, pucch=pucch, device="cpu")
    want = jue.ue_ul_generate(jc, pucch=jpucch)
    np.testing.assert_allclose(got.numpy(), _c(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cfo,ta", [(0.0, 0), (0.05, 0), (0.0, 16),
                                    (-0.3, 7)])
def test_ue_ul_generate_srs_cfo_ta_match_jax(cfo, ta):
    c, jc = Cell(nof_prb=25, id=7), JCell(nof_prb=25, id=7)
    kw = dict(sf_idx=2, n_pucch=14, format="2b")
    pay = np.asarray([1, 0, 0, 1, 1, 1], np.int8)
    srs = dict(n_prb_srs=16, prb_start=4, comb=1, cyclic_shift=2)
    got = ue_ul.ue_ul_generate(
        c, pucch=(pp.PucchConfig(cell=c, **kw), pay, (1, 0)), srs=srs,
        cfo=cfo, timing_advance=ta, device="cpu")
    want = jue.ue_ul_generate(
        jc, pucch=(jp.PucchConfig(cell=jc, **kw), pay, (1, 0)), srs=srs,
        cfo=cfo, timing_advance=ta)
    tol = 1e-4 if cfo else 1e-5
    np.testing.assert_allclose(got.numpy(), _c(want), rtol=tol,
                               atol=tol * np.abs(np.asarray(want)).max())


def test_ue_ul_pusch_jit_matches_jax(rng):
    """The cached PUSCH-subframe generator, with a timing advance, on a
    batch of TBs: equal to JAX's jitted one and to ``ue_ul_generate``."""
    jcell = JCell(nof_prb=6, id=5)
    mod, tbs = jra.mcs_to_tbs(9, 6, dl=False)
    jcfg = jpusch.PuschConfig(cell=jcell, sf_idx=3, rnti=0x44, mod=mod,
                              prb_start=0, n_prb=6)
    cfg = convert.pusch_config_from_fields(vars(jcfg))
    jplan = jcfg.plan(tbs)
    plan = convert.dlsch_plan_from_fields(vars(jplan))
    tb = rng.integers(0, 2, size=(2, tbs)).astype(np.int8)
    fn = ue_ul.ue_ul_pusch_jit(cfg.cell, cfg, plan, timing_advance=5)
    assert fn is ue_ul.ue_ul_pusch_jit(cfg.cell, cfg, plan, timing_advance=5)
    got = fn(torch.as_tensor(tb))
    want = jue.ue_ul_pusch_jit(jcell, jcfg, jplan, timing_advance=5)(
        jnp.asarray(tb))
    np.testing.assert_allclose(got.numpy(), _c(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got.numpy(), ue_ul.ue_ul_generate(
        cfg.cell, pusch=(torch.as_tensor(tb), cfg, plan),
        timing_advance=5).numpy())


def test_ul_control_stimulus_decodes_exactly():
    """The chip phase's busy TTI at 25 PRB: every SR, ACK, CQI and RI
    decodes to what was sent and the SRS estimates each gain within 0.1.
    The timing-advance user's channel undoes its pre-compensation: its
    pre-compensated subframe arrives as the plain one, which the channel
    alone would move far away."""
    st = ue_ul.ul_control_stimulus(8, nof_prb=25, device="cpu")
    out = ue_ul.ul_control_receive(st.samples, st)
    for name, sent in st.sent.items():
        assert torch.equal(out[name], sent), name
    assert float((out["srs_h"].mean(-1) - st.srs_gain).abs().max()) < 0.1
    assert set(st.pucch) == {name for name, _, _ in ue_ul.CTRL_UES}

    ta_cfg = st.pucch[ue_ul.CTRL_TA_UE]
    pucch = (ta_cfg, *ue_ul._ctrl_payload(ue_ul.CTRL_TA_UE, 1))
    plain = ue_ul.ue_ul_generate(st.cell, pucch=pucch, device="cpu")
    sent = ue_ul.ue_ul_generate(st.cell, pucch=pucch, cfo=ue_ul.CTRL_CFO,
                                timing_advance=ue_ul.CTRL_TA, device="cpu")
    peak = float(plain.abs().max())
    arrived = ue_ul.ctrl_ta_channel(sent, st.cell)
    assert float((arrived - plain).abs().max()) < 1e-4 * peak
    assert float((ue_ul.ctrl_ta_channel(plain, st.cell) - plain).abs()
                 .max()) > 0.1 * peak


def test_msg3_grant_decodes_on_one_nii_window():
    """The stack's Msg3 grant (TBS 256: one code block of K 280, which has
    no turbo window) on the uplink's windowed plan: the decoder runs one
    NII window over the whole trellis, exactly as the NII plan does, and
    every TB decodes to what was sent."""
    st = ue_ul.ul_stimulus(4, 1e-3, grant=ue_ul.MSG3_GRANT, device="cpu")
    assert st.plan.segm.cb_sizes == (280,) and _pick_window(280) is None
    assert st.plan.decoder_impl == "windowed"
    grid = ue_ul.enb_ul_receive_grid(st.samples, st.cfg.cell)
    bits, ok, _ = pusch_decode(grid, st.cfg, st.plan, noise_est=1e-3)
    nii = dataclasses.replace(st.plan, decoder_impl="nii")
    bits_n, ok_n, _ = pusch_decode(grid, st.cfg, nii, noise_est=1e-3)
    assert bool(ok.all()) and torch.equal(bits, st.tb)
    assert torch.equal(bits, bits_n) and torch.equal(ok, ok_n)


def test_awgn_statistics_and_reproducibility():
    x = torch.zeros(200_000, dtype=torch.complex64)
    g = torch.Generator().manual_seed(3)
    y = channel.awgn(g, x, 0.5)
    assert y.dtype == torch.complex64
    assert float((y.abs() ** 2).mean()) == pytest.approx(0.5, rel=0.02)
    assert float(y.real.var()) == pytest.approx(0.25, rel=0.02)
    again = channel.awgn(torch.Generator().manual_seed(3), x, 0.5)
    assert torch.equal(y, again)
    # the JAX version's statistics on the same shape
    jy = np.asarray(jch.awgn(jax.random.PRNGKey(3), jnp.asarray(x.numpy()),
                             0.5))
    assert float(np.mean(np.abs(jy) ** 2)) == pytest.approx(0.5, rel=0.02)


def test_channel_helpers_match_jax():
    x = (np.random.default_rng(5).normal(size=(3, 400))
         + 1j * np.random.default_rng(6).normal(size=(3, 400))) \
        .astype(np.complex64)
    np.testing.assert_array_equal(
        channel.awgn_np(np.random.default_rng(7), x, 0.1),
        jch.awgn_np(np.random.default_rng(7), x, 0.1))
    assert channel.snr_to_n0(torch.as_tensor(x), 7.0) == pytest.approx(
        jch.snr_to_n0(x, 7.0), rel=1e-6)
    assert channel.snr_to_n0(x, 3.0) == jch.snr_to_n0(x, 3.0)
    delays, powers = [0, 3, 7, 11], [0.0, -1.5, -3.0, -9.0]
    taps = channel.rayleigh_taps(np.random.default_rng(9), delays, powers)
    np.testing.assert_array_equal(
        taps, jch.rayleigh_taps(np.random.default_rng(9), delays, powers))
    got = channel.apply_multipath(torch.as_tensor(x), taps)
    want = jch.apply_multipath(jnp.asarray(x), taps)
    np.testing.assert_allclose(got.numpy(), _c(want), rtol=1e-5, atol=1e-5)
    assert got.shape == x.shape
