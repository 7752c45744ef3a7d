"""Port vs JAX reference: the eNB PUSCH receiver with UCI and the UE
PUSCH transmitter that feeds it, on a 6-PRB cell.

Inputs are numpy draws handed to both packages. Host tables (base
sequences, DMRS) must agree to 1e-6; grids and samples, which go through
FFTs in two libraries, to 1e-5; the descrambled LLRs to 1e-4. Decoded
bits, CRC flags, ACK, RI and CQI must be equal, and equal to what was
sent. The JAX decoders run under ``jax.jit`` (its ``pusch_decode_uci``
calls ``int()`` on batched results when run eagerly). ``pusch_decode``
runs the v1 windowed turbo kernel in interpret mode (``decoder_impl=
"pallas_interpret"``, which decodes with bfloat16 metrics, so only bits
are compared after the turbo decoder), the port ``decoder_impl=
"windowed"``. Compiling that kernel costs ~20 s, so the UCI cases decode
the JAX side's data with its XLA decoder: there the point is the UCI
fields, and both sides' TB bits must still equal the sent ones
(tests/test_torch_turbo_win.py holds the decoder itself to the kernel).

The port's DMRS and SC-FDMA follow TS 36.211 5.5.2.1.1 and 5.6, where the
JAX package's depart from it: every test here runs with those JAX stages
replaced by the specification's (``tests/jax_ul_spec.py``), every other
JAX stage as it is.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from empower_srslte_tpu.models import pusch as jpusch
from empower_srslte_tpu.models import ra as jra
from empower_srslte_tpu.models import refsignal_ul as jrs
from empower_srslte_tpu.models import ue_ul as jue_ul
from empower_srslte_tpu.utils.cell import Cell as JCell

from empower_srslte_tpu_torch import convert
from empower_srslte_tpu_torch.models import pusch, refsignal_ul as rs, ue_ul
from empower_srslte_tpu_torch.models import uci
from empower_srslte_tpu_torch.runtime import trace
from empower_srslte_tpu_torch.utils.cell import Cell

from tests.jax_ul_spec import spec_uplink

CELL = dict(nof_prb=6, nof_ports=1, id=5)
#: 16QAM: TBS 1032 on 6 PRB (K=1056, 6 windows of 176); the decode
#: tests use 2 PRB from PRB 2 (TBS 328, K=352, 2 windows), which keeps
#: the JAX interpret-mode turbo kernel cheap
MCS = 11
DECODE = dict(n_prb=2, prb_start=2)
N0 = 0.01


@pytest.fixture(scope="module", autouse=True)
def _spec_uplink():
    """The JAX package's PUSCH DMRS and SC-FDMA pair held to TS 36.211,
    as the port's are (``tests/jax_ul_spec.py``)."""
    with spec_uplink():
        yield


def _cfgs(**kw):
    jcell, cell = JCell(**CELL), Cell(**CELL)
    mod, tbs = jra.mcs_to_tbs(MCS, kw.get("n_prb", 6), dl=False)
    base = dict(sf_idx=2, rnti=0x3a, mod=mod, n_prb=6)
    base.update(kw)
    jcfg = jpusch.PuschConfig(cell=jcell, **base)
    cfg = convert.pusch_config_from_fields(vars(jcfg))
    return jcfg, cfg, tbs


def _c(x):
    return np.asarray(x).astype(np.complex64)


@pytest.mark.parametrize("m_sc", [12, 24, 36, 72])
def test_base_sequences_match_jax(m_sc):
    for u, v in ((0, 0), (7, 0), (29, 1 if m_sc >= 72 else 0)):
        np.testing.assert_allclose(rs.base_sequence(u, v, m_sc),
                                   jrs.base_sequence(u, v, m_sc),
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("hop", ["group", "sequence"])
def test_pusch_dmrs_with_hopping_matches_jax(hop):
    kw = dict(delta_ss=3, group_hopping=hop == "group",
              sequence_hopping=hop == "sequence")
    for cell_id in (5, 47):
        seqs = set()
        for sf in (0, 3, 9):
            want = jrs.pusch_dmrs(JCell(nof_prb=6, id=cell_id), 6, 2,
                                  sf_idx=sf, **kw)
            got = rs.pusch_dmrs(Cell(nof_prb=6, id=cell_id), 6, 2,
                                sf_idx=sf, **kw)
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
            seqs.update(g.tobytes() for g in got)
        # without hopping every slot of a cell has the same sequence
        assert len(seqs) > 1


def _uci_data(o_cqi: int, ack: tuple):
    cqi_bits = tuple(int(b) for b in np.random.default_rng(o_cqi)
                     .integers(0, 2, o_cqi))
    return dict(cqi_bits=cqi_bits, ri=1, ack=ack)


def test_transmitter_matches_jax(rng):
    jcfg, cfg, tbs = _cfgs(group_hopping=True)
    tb = rng.integers(0, 2, size=(2, tbs)).astype(np.int8)
    jplan = jcfg.plan(tbs)
    plan = convert.dlsch_plan_from_fields(vars(jplan))
    got = pusch.pusch_encode(torch.as_tensor(tb), cfg, plan)
    want = jpusch.pusch_encode(jnp.asarray(tb), jcfg, jplan)
    np.testing.assert_allclose(got.numpy(), _c(want), rtol=1e-5, atol=1e-5)

    # with UCI (the JAX encoder takes one subframe when CQI rides along)
    fields = _uci_data(20, (1, 0))
    jplan_u = jpusch.UciPlan(jcfg, tbs, jpusch.UciData(**fields))
    plan_u = convert.uci_plan_from_fields(vars(jplan_u))
    got = pusch.pusch_encode_uci(torch.as_tensor(tb[0]), cfg, plan_u)
    want = jpusch.pusch_encode_uci(jnp.asarray(tb[0]), jcfg, jplan_u)
    np.testing.assert_allclose(got.numpy(), _c(want), rtol=1e-5, atol=1e-5)
    samples = ue_ul.ue_ul_generate(cfg.cell, pusch=(torch.as_tensor(tb[0]),
                                                    cfg, plan_u))
    want = jue_ul.ue_ul_generate(jcfg.cell, pusch=(jnp.asarray(tb[0]), jcfg,
                                                   jplan_u))
    np.testing.assert_allclose(samples.numpy(), _c(want), rtol=1e-5,
                               atol=1e-5)
    # timing advance: the JAX package rolls the subframe early
    samples = ue_ul.ue_ul_generate(cfg.cell, pusch=(torch.as_tensor(tb[0]),
                                                    cfg, plan_u),
                                   timing_advance=4)
    want = jue_ul.ue_ul_generate(jcfg.cell, pusch=(jnp.asarray(tb[0]), jcfg,
                                                   jplan_u),
                                 timing_advance=4)
    np.testing.assert_allclose(samples.numpy(), _c(want), rtol=1e-5,
                               atol=1e-5)


def _rx_samples(rng, jcfg, jplan, tb):
    """JAX transmitter + flat channel + AWGN of N0 per RE (in time)."""
    x = np.asarray(jue_ul.ue_ul_generate(jcfg.cell, pusch=(
        jnp.asarray(tb), jcfg, jplan))) * (0.9 - 0.2j)
    s = np.sqrt(N0 / jcfg.cell.fft_size / 2)
    n = rng.normal(size=(2, *x.shape)) * s
    return (x + n[0] + 1j * n[1]).astype(np.complex64)


@pytest.mark.parametrize("hopping", [False, True])
def test_receive_grid_and_chest_match_jax(rng, hopping):
    kw = dict(n_prb=3, prb_start=0, prb_start_slot1=3) if hopping else {}
    jcfg, cfg, tbs = _cfgs(**kw)
    tb = rng.integers(0, 2, size=(2, tbs)).astype(np.int8)
    y = _rx_samples(rng, jcfg, jcfg.plan(tbs), tb)
    jgrid = jue_ul.enb_ul_receive_grid(jnp.asarray(y), jcfg.cell)
    grid = ue_ul.enb_ul_receive_grid(torch.as_tensor(y), cfg.cell)
    np.testing.assert_allclose(grid.numpy(), _c(jgrid), rtol=1e-5, atol=1e-5)
    args = (cfg.prb_start, cfg.n_prb, cfg.cyclic_shift)
    kw = dict(prb_start_slot1=cfg.prb_start_slot1, sf_idx=cfg.sf_idx)
    want = jrs.chest_ul_pusch(jgrid, jcfg.cell, *args, **kw)
    got = rs.chest_ul_pusch(grid, cfg.cell, *args, **kw)
    np.testing.assert_allclose(got.numpy(), _c(want), rtol=1e-5, atol=1e-5)


def test_grid_noise_scaling():
    """Time-domain AWGN of variance n0 / fft_size per sample is n0 per
    received grid RE (the uplink stimulus' construction)."""
    st = ue_ul.ul_uci_stimulus(1, 0.05, device="cpu")
    clean = ue_ul.ul_uci_stimulus(1, 0.0, device="cpu")
    cell = st.cfg.cell
    d = (ue_ul.enb_ul_receive_grid(st.samples, cell)
         - ue_ul.enb_ul_receive_grid(clean.samples, cell))
    var = float((d.abs() ** 2).mean())
    assert abs(var / 0.05 - 1.0) < 0.05, var


def test_pusch_decode_matches_jax(rng, monkeypatch):
    jcfg, cfg, tbs = _cfgs(**DECODE)
    tb = rng.integers(0, 2, size=(3, tbs)).astype(np.int8)
    jplan = jcfg.plan(tbs, decoder_impl="pallas_interpret")
    plan = convert.dlsch_plan_from_fields(vars(jplan))
    assert plan.decoder_impl == "windowed"
    y = _rx_samples(rng, jcfg, jplan, tb)
    jgrid = jue_ul.enb_ul_receive_grid(jnp.asarray(y), jcfg.cell)
    grid = ue_ul.enb_ul_receive_grid(torch.as_tensor(y), cfg.cell)

    # the descrambled LLRs the UL-SCH decoder receives
    seen = {}

    def capture(llr, plan_, **kw):
        seen["llr"] = np.asarray(llr)
        return None, None, None

    monkeypatch.setattr(jpusch, "dlsch_decode", capture)
    jpusch.pusch_decode(jgrid, jcfg, jplan, noise_est=N0)
    monkeypatch.undo()
    np.testing.assert_allclose(
        pusch._pusch_llrs(grid, cfg, N0).numpy(), seen["llr"], rtol=1e-4,
        atol=1e-4)

    run = jax.jit(lambda g: jpusch.pusch_decode(g, jcfg, jplan,
                                                noise_est=N0)[:2])
    bits_j, ok_j = run(jgrid)
    before = trace.launch_counts()
    its = []
    bits, ok, _ = pusch.pusch_decode(grid, cfg, plan, noise_est=N0,
                                     iters_out=its)
    assert trace.launch_counts() == before       # CPU: the plain twin
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_j))
    assert ok.all() and (bits.numpy() == tb).all()


@pytest.mark.parametrize("o_cqi,ack", [(20, (1, 0)), (6, (1,))])
def test_pusch_decode_uci_matches_jax(rng, o_cqi, ack):
    """Long CQI (CRC8 + conv code, the Viterbi path) with 2 ACK bits;
    short CQI (RM (32, O)) with 1 ACK bit; both with a 1-bit RI."""
    jcfg, cfg, tbs = _cfgs(**DECODE)
    fields = _uci_data(o_cqi, ack)
    jplan = jpusch.UciPlan(jcfg, tbs, jpusch.UciData(**fields),
                           decoder_impl="pallas_interpret")
    plan = convert.uci_plan_from_fields(vars(jplan))
    assert plan.data_plan.decoder_impl == "windowed"
    tb = rng.integers(0, 2, size=(2, tbs)).astype(np.int8)
    y = np.stack([_rx_samples(rng, jcfg, jplan, t) for t in tb])
    jgrid = jue_ul.enb_ul_receive_grid(jnp.asarray(y), jcfg.cell)
    jplan_xla = jpusch.UciPlan(jcfg, tbs, jpusch.UciData(**fields),
                               decoder_impl="xla")
    want = jpusch.pusch_decode_uci_jit(jcfg, jplan_xla)(jgrid, N0)
    got = pusch.pusch_decode_uci(
        ue_ul.enb_ul_receive_grid(torch.as_tensor(y), cfg.cell), cfg, plan,
        noise_est=N0)

    sent_cqi = np.broadcast_to(np.asarray(fields["cqi_bits"]), (2, o_cqi))
    np.testing.assert_array_equal(got["cqi_bits"].numpy(),
                                  np.asarray(want["cqi_bits"]))
    np.testing.assert_array_equal(got["cqi_bits"].numpy(), sent_cqi)
    if o_cqi > 11:
        np.testing.assert_array_equal(got["cqi_ok"].numpy(),
                                      np.asarray(want["cqi_ok"]))
    assert got["cqi_ok"].all()
    assert len(got["ack"]) == len(ack)
    for g, w, a in zip(got["ack"], want["ack"], ack):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (g.numpy() == a).all()
    np.testing.assert_array_equal(got["ri"].numpy(), np.asarray(want["ri"]))
    assert (got["ri"].numpy() == 1).all()
    np.testing.assert_array_equal(got["crc_ok"].numpy(),
                                  np.asarray(want["crc_ok"]))
    np.testing.assert_array_equal(got["tb"].numpy(), np.asarray(want["tb"]))
    assert got["crc_ok"].all() and (got["tb"].numpy() == tb).all()


def test_uci_plan_carries_over_from_jax():
    jcfg, cfg, tbs = _cfgs(n_prb=3, prb_start=1)
    for fields in (_uci_data(30, (1, 0)), _uci_data(4, ()),
                   dict(ri=0, ack=(1,))):
        jplan = jpusch.UciPlan(jcfg, tbs, jpusch.UciData(**fields))
        for plan in (pusch.UciPlan(cfg, tbs, pusch.UciData(**fields)),
                     convert.uci_plan_from_fields(vars(jplan))):
            for name in ("q_ri", "q_ack", "q_cqi", "rows", "qm", "nb_q",
                         "g_data", "tbs"):
                assert getattr(plan, name) == getattr(jplan, name), name
            for name in ("ri_pos", "ack_pos", "perm"):
                np.testing.assert_array_equal(getattr(plan, name),
                                              getattr(jplan, name))
            assert plan.data_plan.cb_plans == jplan.data_plan.cb_plans
    # the JAX XLA scan maps to the port's plain copy of it
    jplan_xla = jcfg.plan(tbs, decoder_impl="xla")
    plan_xla = convert.dlsch_plan_from_fields(vars(jplan_xla))
    assert plan_xla.decoder_impl == "xla"
    assert plan_xla.cb_plans == jplan_xla.cb_plans


def test_cqi_payload_helpers_match_jax():
    from empower_srslte_tpu.models import uci as juci

    for prb in (6, 25, 50, 100):
        assert uci.cqi_hl_subband_nof_bits(prb) == \
            juci.cqi_hl_subband_nof_bits(prb)
        sbs = np.arange(juci.cqi_nof_subbands(prb)) % 16
        bits = uci.cqi_pack_hl_subband(9, sbs, prb)
        np.testing.assert_array_equal(bits,
                                      juci.cqi_pack_hl_subband(9, sbs, prb))
        assert uci.cqi_unpack_hl_subband(bits, prb) == \
            juci.cqi_unpack_hl_subband(bits, prb)
    for o in (4, 11, 20, 30):
        msg = np.random.default_rng(o).integers(0, 2, o).astype(np.int8)
        np.testing.assert_array_equal(uci.encode_cqi_pusch(msg, 200),
                                      juci.encode_cqi_pusch(msg, 200))


def test_uplink_entry_points_refuse_to_fall_back(monkeypatch):
    from empower_srslte_tpu_torch.tools import microbench_recursion as mr

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ue_ul.ul_uci_stimulus(1, N0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ue_ul.ue_ul_generate(Cell(**CELL))
    with pytest.raises(RuntimeError, match="CUDA"):
        mr.run(steps=1, lanes=4)
    x = ue_ul.ue_ul_generate(Cell(**CELL), device="cpu")
    assert x.device.type == "cpu" and x.shape == (Cell(**CELL)
                                                  .sf_sample_len,)
