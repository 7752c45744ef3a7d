"""Port vs JAX reference: the 8-bit LLR lane. Byte-scaled quantization
(demod_soft.c:44-46), int8 descrambling and de-rate-matching with
saturating HARQ combining (rm_turbo.c:378-905), int8 softbuffers, the
PDSCH receiver on the lane, the uplink's ``pusch_decode`` on it, and
``pusch_decode_uci``, which ignores the flag as the JAX package does.

Integers must be equal: quantized LLRs, de-rate-matched LLRs and
softbuffers. Decoded bits and CRC flags must be equal, and equal to what
was sent. Both packages decode the int8 lane's LLRs in bfloat16 (their
``dtype="auto"`` on the NII kernel path; the int8 values are exact in
bfloat16), so against the JAX ``pallas2_interpret`` decode the turbo
decoder's a-posteriori LLRs are equal too, bit for bit. The uplink test
holds the port's windowed bfloat16 decode to JAX's float32 XLA decoder,
so it compares bits only. The uplink tests replace the JAX package's
PUSCH DMRS and SC-FDMA pair, which depart from TS 36.211 where the
port's follow it, by the specification's (``tests/jax_ul_spec.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from empower_srslte_tpu.models import pdsch as jpdsch
from empower_srslte_tpu.models import pusch as jpusch
from empower_srslte_tpu.models import ra as jra
from empower_srslte_tpu.models import ue_ul as jue_ul
from empower_srslte_tpu.ops import modem as jmodem
from empower_srslte_tpu.ops import scrambling as jscr
from empower_srslte_tpu.ops.fec.rate_matching import RateMatchTurbo as JRm
from empower_srslte_tpu.ops.fec.turbo_decoder import TurboDecoder as JTurbo
from empower_srslte_tpu.utils.cell import Cell as JCell

from empower_srslte_tpu_torch import convert
from empower_srslte_tpu_torch.models import pdsch, pusch, ue_ul
from empower_srslte_tpu_torch.ops import modem, scrambling
from empower_srslte_tpu_torch.ops.fec.rate_matching import RateMatchTurbo
from empower_srslte_tpu_torch.ops.fec.turbo_decoder import TurboDecoder

from tests.jax_ul_spec import spec_uplink


@pytest.fixture(autouse=True)
def _tiny_tiles(monkeypatch):
    monkeypatch.setenv("TURBO_SUB", "8")
    monkeypatch.setenv("TURBO_LANES", "1")


def _int8(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    assert a.dtype == np.int8, a.dtype
    return a


@pytest.mark.parametrize("mod", ["BPSK", "QPSK", "QAM16", "QAM64"])
def test_quantize_matches_jax(rng, mod):
    m, jm = modem.Mod[mod], jmodem.Mod[mod]
    assert modem.DEMOD_INT8_SCALE[m] == jmodem.DEMOD_INT8_SCALE[jm]
    # exact half-way products round to even on both sides
    halves = np.array([0.05, -0.05, 0.025, -0.075, 10.0, -10.0, 0.0],
                      np.float32)
    llr = np.concatenate([halves, rng.normal(scale=2.0, size=500)
                          .astype(np.float32)])
    got = _int8(modem.quantize_llr_int8(torch.as_tensor(llr), m))
    np.testing.assert_array_equal(got, _int8(jmodem.quantize_llr_int8(
        jnp.asarray(llr), jm)))
    assert got[4] == 127 and got[5] == -127
    if mod == "QAM16":
        assert got[0] == 2 and got[1] == -2      # 0.05 * 30 = 1.5 -> 2
    if mod == "QPSK":
        assert got[0] == 1 and got[3] == -2      # 1.0, -1.5 -> -2
    c_init = 0x1234 << 14 | 77
    np.testing.assert_array_equal(
        _int8(scrambling.descramble_llrs(torch.as_tensor(got), c_init)),
        _int8(jscr.descramble_llrs(jnp.asarray(got), c_init)))


@pytest.mark.parametrize("k,f,e", [(512, 0, 768), (1056, 24, 4000)])
def test_int8_rate_matching_and_harq_saturation(rng, k, f, e):
    """rv 0 then rv 2 of one code block, strong LLRs: the combined buffer
    saturates at +-127 on both sides (int8 arithmetic would wrap)."""
    rm, jrm = RateMatchTurbo(k, f=f), JRm(k, f=f)
    q = rng.integers(-127, 128, size=(2, e)).astype(np.int8)
    d1, s1 = rm.rx(torch.as_tensor(q), 0)
    d1_j, s1_j = jrm.rx(jnp.asarray(q), 0)
    np.testing.assert_array_equal(_int8(d1), _int8(d1_j))
    np.testing.assert_array_equal(_int8(s1), _int8(s1_j))
    if f:
        assert (_int8(d1)[..., 0, :f] == 127).all()    # the filler prior
    d2, s2 = rm.rx(torch.as_tensor(q), 2, softbuffer=s1)
    d2_j, s2_j = jrm.rx(jnp.asarray(q), 2, softbuffer=s1_j)
    np.testing.assert_array_equal(_int8(d2), _int8(d2_j))
    np.testing.assert_array_equal(_int8(s2), _int8(s2_j))
    assert np.abs(_int8(s2)).max() == 127
    assert (np.abs(_int8(s2).astype(np.int32)) <= 127).all()

    # int8 HARQ state carried over from the JAX package stays int8
    soft = convert.softbuffers_from_numpy([np.asarray(s1_j)], device="cpu")
    assert soft[0].dtype == torch.int8
    d3, s3 = rm.rx(torch.as_tensor(q), 2, softbuffer=soft[0])
    np.testing.assert_array_equal(_int8(s3), _int8(s2_j))
    f32 = convert.softbuffers_from_numpy([np.zeros(4, np.float64)],
                                         device="cpu")
    assert f32[0].dtype == torch.float32


def _spy_decode(monkeypatch, cls, seen: list, method: str = "decode"):
    """Record the (bits, LLRs) of every ``cls.<method>`` call (the port's
    DL-SCH decode calls ``decode_prepared`` on the de-rate-matched
    inputs)."""
    real = getattr(cls, method)

    def spy(self, *a, **kw):
        out = real(self, *a, **kw)
        seen.append((self, out[1]))
        return out

    monkeypatch.setattr(cls, method, spy)


def test_pdsch_int8_lane_matches_jax(rng, monkeypatch):
    """The 10 MHz SISO point of the JAX package's int8 test (MCS 17, flat
    h 0.9-0.2j, SNR 14 dB, genie channel) cut to a 15-PRB cell. Both
    turbo decoders run in bfloat16 (JAX on its classic DL-SCH path), and
    their a-posteriori LLRs are equal exactly."""
    jcell = JCell(nof_prb=15, id=1)
    mod, tbs = jra.mcs_to_tbs(17, 15)
    jcfg = jpdsch.PdschConfig(cell=jcell, sf_idx=1, cfi=1, mod=mod,
                              llr_int8=True)
    jplan = jcfg.plan(tbs, decoder_impl="pallas2_interpret")
    cfg = convert.pdsch_config_from_fields(vars(jcfg))
    plan = convert.dlsch_plan_from_fields(vars(jplan))
    assert cfg.llr_int8 and cfg.g == jcfg.g
    tb = rng.integers(0, 2, size=(2, tbs)).astype(np.int8)
    grid = np.asarray(jpdsch.pdsch_encode(jnp.asarray(tb), jcfg, jplan))
    hval = np.complex64(0.9 - 0.2j)
    n0 = np.float32(10 ** (-14 / 10))
    nre = jcell.nof_re
    y = (grid * hval + np.sqrt(n0 / 2) * (
        rng.normal(size=(2, 1, 14, nre))
        + 1j * rng.normal(size=(2, 1, 14, nre)))).astype(np.complex64)
    h = np.full((2, 1, 1, 14, nre), hval, np.complex64)

    # the int8 LLRs dlsch_decode receives, on the JAX package's classic
    # (extracted) path
    seen = {}

    def capture(llr, plan_, **kw):
        seen["llr"] = np.asarray(llr)
        return None, None, None

    monkeypatch.setenv("SRSLTE_FUSED_RX", "0")
    monkeypatch.setattr(jpdsch, "dlsch_decode", capture)
    jpdsch.pdsch_decode(jnp.asarray(y), jnp.asarray(h), jcfg, jplan,
                        noise_est=n0)
    monkeypatch.undo()
    got = {}
    real_decode = pdsch.dlsch_decode

    def port_capture(llr, plan_, **kw):
        got["llr"] = llr
        return real_decode(llr, plan_, **kw)

    monkeypatch.setattr(pdsch, "dlsch_decode", port_capture)
    port_llr: list = []
    _spy_decode(monkeypatch, TurboDecoder, port_llr, "decode_prepared")
    bits, ok, soft = pdsch.pdsch_decode(torch.as_tensor(y),
                                        torch.as_tensor(h), cfg, plan,
                                        noise_est=float(n0))
    np.testing.assert_array_equal(_int8(got["llr"]), _int8(seen["llr"]))

    monkeypatch.setenv("TURBO_SUB", "8")
    monkeypatch.setenv("TURBO_LANES", "1")
    # the classic path, whose one TurboDecoder.decode call per code block
    # size the spy sees (the fused feed calls decode_tiles instead)
    monkeypatch.setenv("SRSLTE_FUSED_RX", "0")
    jax_llr: list = []
    _spy_decode(monkeypatch, JTurbo, jax_llr)
    # the decoder's LLRs leave the jitted function beside its results
    run = jax.jit(lambda y, h: (*jpdsch.pdsch_decode(
        y, h, jcfg, jplan, noise_est=n0)[:2], jax_llr[-1][1]))
    bits_j, ok_j, llr_j = run(jnp.asarray(y), jnp.asarray(h))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_j))
    assert ok.all() and (bits.numpy() == tb).all()
    assert all(s.dtype == torch.int8 for s in soft)
    (dec, llr_p), = port_llr
    assert dec.metric_dtype == torch.bfloat16
    assert llr_p.dtype == torch.bfloat16 and llr_j.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        llr_p.float().numpy(), np.asarray(llr_j.astype(jnp.float32)))


# --- uplink -----------------------------------------------------------------

CELL = dict(nof_prb=6, nof_ports=1, id=5)
N0 = 0.01


@pytest.fixture
def spec_ul():
    """The JAX package's PUSCH DMRS and SC-FDMA pair held to TS 36.211."""
    with spec_uplink():
        yield


def _pusch_cfgs(llr_int8: bool):
    mod, tbs = jra.mcs_to_tbs(11, 2, dl=False)
    jcfg = jpusch.PuschConfig(cell=JCell(**CELL), sf_idx=2, rnti=0x3a,
                              mod=mod, n_prb=2, prb_start=2,
                              llr_int8=llr_int8)
    return jcfg, convert.pusch_config_from_fields(vars(jcfg)), tbs


def _ul_samples(rng, jcfg, jplan, tb):
    x = np.asarray(jue_ul.ue_ul_generate(jcfg.cell, pusch=(
        jnp.asarray(tb), jcfg, jplan))) * (0.9 - 0.2j)
    s = np.sqrt(N0 / jcfg.cell.fft_size / 2)
    n = rng.normal(size=(2, *x.shape)) * s
    return (x + n[0] + 1j * n[1]).astype(np.complex64)


def test_pusch_decode_int8_matches_jax(rng, spec_ul):
    """The JAX side decodes with its XLA windowed decoder (float32), the
    port with the windowed twin (bfloat16, its default there): the point
    is the lane ahead of the decoder."""
    jcfg, cfg, tbs = _pusch_cfgs(True)
    assert cfg.llr_int8
    jplan = jcfg.plan(tbs, decoder_impl="xla")
    plan = convert.dlsch_plan_from_fields({**vars(jplan),
                                           "decoder_impl": "pallas"})
    tb = rng.integers(0, 2, size=(2, tbs)).astype(np.int8)
    y = _ul_samples(rng, jcfg, jplan, tb)
    jgrid = jue_ul.enb_ul_receive_grid(jnp.asarray(y), jcfg.cell)
    run = jax.jit(lambda g: jpusch.pusch_decode(g, jcfg, jplan,
                                                noise_est=N0))
    bits_j, ok_j, soft_j = run(jgrid)
    bits, ok, soft = pusch.pusch_decode(
        ue_ul.enb_ul_receive_grid(torch.as_tensor(y), cfg.cell), cfg, plan,
        noise_est=N0)
    assert all(s.dtype == torch.int8 for s in soft)
    assert all(np.asarray(s).dtype == np.int8 for s in soft_j)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_j))
    assert ok.all() and (bits.numpy() == tb).all()


def test_pusch_decode_uci_ignores_int8_flag_as_jax(rng, spec_ul):
    jcfg, cfg, tbs = _pusch_cfgs(True)
    fields = dict(cqi_bits=tuple(int(b) for b in rng.integers(0, 2, 20)),
                  ri=1, ack=(1, 0))
    jplan = jpusch.UciPlan(jcfg, tbs, jpusch.UciData(**fields),
                           decoder_impl="xla")
    plan = pusch.UciPlan(cfg, tbs, pusch.UciData(**fields),
                         decoder_impl="windowed")
    tb = rng.integers(0, 2, size=(2, tbs)).astype(np.int8)
    y = np.stack([_ul_samples(rng, jcfg, jplan, t) for t in tb])
    want = jpusch.pusch_decode_uci_jit(jcfg, jplan)(
        jue_ul.enb_ul_receive_grid(jnp.asarray(y), jcfg.cell), N0)
    got = pusch.pusch_decode_uci(
        ue_ul.enb_ul_receive_grid(torch.as_tensor(y), cfg.cell), cfg, plan,
        noise_est=N0)
    assert all(s.dtype == torch.float32 for s in got["softbuffers"])
    for key in ("cqi_bits", "cqi_ok", "ri", "crc_ok", "tb"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]), key)
    for g, w, a in zip(got["ack"], want["ack"], fields["ack"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert (g.numpy() == a).all()
    assert got["crc_ok"].all() and (got["tb"].numpy() == tb).all()
