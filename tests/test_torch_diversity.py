"""Port vs JAX reference: transmit diversity (2-port SFBC, 4-port
SFBC-FSTD), TM3 large-delay CDD, the layer maps, PMI / rank / CQI
reporting and the 4-port control channels, on Cell(6) grids.

Tolerances: the equalizers' float32 arithmetic agrees to rtol 1e-5 /
atol 1e-6 (XLA fuses complex multiplies into FMAs, so the two differ by
ulps); the precoders and layer maps, which only scale and move values,
are equal; PDSCH grids agree to 1e-6; decoded bits, CRC flags, CFI, DCI
hits and report fields are equal. The JAX PDSCH decodes compile as one
function each: the 4-port TM2 case with the NII Pallas kernel in
interpret mode (tiny tiles), the other cases with the JAX package's XLA
turbo decoder, since each interpret-mode compile costs ~40 s; every case
must also decode to the bits sent.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from empower_srslte_tpu.models import measurements as jmeas
from empower_srslte_tpu.models import pcfich as jpcfich
from empower_srslte_tpu.models import pdcch as jpdcch
from empower_srslte_tpu.models import pdsch as jpdsch
from empower_srslte_tpu.models import ra as jra
from empower_srslte_tpu.models.enb_dl import enb_dl_base_grid
from empower_srslte_tpu.models.regs import pdcch_nof_cces
from empower_srslte_tpu.ops import equalizer as jeq
from empower_srslte_tpu.utils.cell import Cell as JCell

from empower_srslte_tpu_torch.convert import (decoder_impl_from_jax,
                                              dlsch_plan_from_fields,
                                              pdsch_config_from_fields)
from empower_srslte_tpu_torch.models import measurements, pcfich, pdcch
from empower_srslte_tpu_torch.models import pdsch
from empower_srslte_tpu_torch.models.dci import format1_size
from empower_srslte_tpu_torch.ops import equalizer
from empower_srslte_tpu_torch.utils.cell import Cell

ELEM_TOL = dict(rtol=1e-5, atol=1e-6)
SF_IDX, CFI, RNTI = 1, 2, 0x1234


@pytest.fixture(autouse=True)
def _tiny_tiles(monkeypatch):
    monkeypatch.setenv("TURBO_SUB", "8")
    monkeypatch.setenv("TURBO_LANES", "1")


def _cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64) / np.float32(np.sqrt(2))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _both(fn_port, fn_jax, *arrays, **kw):
    got = fn_port(*(torch.as_tensor(a) for a in arrays), **kw)
    want = fn_jax(*(jnp.asarray(a) for a in arrays), **kw)
    return got, want


def test_diversity_equalizers_and_precoders(rng):
    y = _cplx(rng, 3, 2, 64)
    hs = [_cplx(rng, 3, 2, 64) for _ in range(4)]
    for got, want in zip(*_both(equalizer.eq_sfbc_fstd, jeq.eq_sfbc_fstd,
                                y, *hs)):
        np.testing.assert_allclose(_np(got), _np(want), **ELEM_TOL)
    layers4 = _cplx(rng, 3, 4, 16)
    got, want = _both(equalizer.precode_sfbc_fstd, jeq.precode_sfbc_fstd,
                      layers4)
    np.testing.assert_array_equal(_np(got), _np(want))
    got, want = _both(equalizer.precode_single, jeq.precode_single, layers4)
    np.testing.assert_array_equal(_np(got), _np(want))
    for mmse in (True, False):
        yy, hh = _cplx(rng, 4, 2, 48), _cplx(rng, 4, 2, 2, 48)
        for got, want in zip(*_both(equalizer.eq_mux_2x2, jeq.eq_mux_2x2,
                                    yy, hh, noise_est=0.05, mmse=mmse)):
            np.testing.assert_allclose(_np(got), _np(want), rtol=1e-4,
                                       atol=1e-5)


@pytest.mark.parametrize("ncw,nl", [(1, 2), (1, 4), (2, 2), (2, 3), (2, 4)])
def test_layer_maps(rng, ncw, nl):
    per_cw = {(1, 2): (24,), (1, 4): (24,), (2, 2): (12, 12),
              (2, 3): (12, 24), (2, 4): (24, 24)}[(ncw, nl)]
    cws = [_cplx(rng, 2, m) for m in per_cw]
    got = equalizer.layermap([torch.as_tensor(c) for c in cws], nl, ncw)
    want = jeq.layermap([jnp.asarray(c) for c in cws], nl, ncw)
    np.testing.assert_array_equal(_np(got), _np(want))
    back = equalizer.layerdemap(got, ncw)
    for b, w, c in zip(back, jeq.layerdemap(want, ncw), cws):
        np.testing.assert_array_equal(_np(b), _np(w))
        np.testing.assert_array_equal(_np(b), c)


def test_cdd_precoder_and_effective_channel(rng):
    # odd length: D(i) cycles by the RE's index in extraction order
    layers, h = _cplx(rng, 3, 2, 37), _cplx(rng, 3, 2, 2, 37)
    got, want = _both(equalizer.precode_cdd_2layer, jeq.precode_cdd_2layer,
                      layers)
    np.testing.assert_array_equal(_np(got), _np(want))
    got, want = _both(equalizer.effective_channel_cdd,
                      jeq.effective_channel_cdd, h)
    np.testing.assert_allclose(_np(got), _np(want), **ELEM_TOL)


def test_pmi_rank_and_measurement_report(rng):
    h = _cplx(rng, 5, 2, 2, 120)
    h[0, :, 1] *= 0.05                   # ill-conditioned: rank 1
    for fn, jfn in ((equalizer.pmi_select_2layer, jeq.pmi_select_2layer),
                    (equalizer.pmi_select_1layer, jeq.pmi_select_1layer)):
        (pmi, s), (pmi_j, s_j) = _both(fn, jfn, h, noise_est=1e-2)
        np.testing.assert_array_equal(_np(pmi), _np(pmi_j))
        np.testing.assert_allclose(_np(s), _np(s_j), rtol=1e-5, atol=1e-5)
    got, want = _both(equalizer.condition_number_db, jeq.condition_number_db,
                      h)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-4)
    got, want = _both(measurements.ue_measurement_report,
                      jmeas.ue_measurement_report, h, noise_est=1e-2)
    assert set(got) == set(want)
    for key in ("ri", "pmi", "cqi"):
        np.testing.assert_array_equal(_np(got[key]), _np(want[key]), key)
    assert set(_np(got["ri"]).tolist()) == {1, 2}
    np.testing.assert_allclose(_np(got["snr_db"]), _np(want["snr_db"]),
                               atol=1e-4)
    snr = np.linspace(-10.0, 30.0, 81).astype(np.float32)
    np.testing.assert_array_equal(_np(measurements.cqi_from_snr(snr)),
                                  _np(jmeas.cqi_from_snr(snr)))
    hh = _cplx(rng, 2, 14, 72)
    got, want = _both(measurements.snr_from_chest, jmeas.snr_from_chest, hh,
                      noise_est=0.01)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4)


def test_measurements_from_samples(rng):
    """Subband SNRs and RSRP from one subframe of IQ with CRS and noise."""
    from empower_srslte_tpu.models.enb_dl import enb_dl_gen_signal

    jcell = JCell(nof_prb=15, nof_ports=1, id=3)
    cell = Cell(nof_prb=15, nof_ports=1, id=3)
    x = np.asarray(enb_dl_gen_signal(enb_dl_base_grid(jcell, SF_IDX),
                                     jcell))[0]
    x = (x * (0.7 + 0.3j) + 0.002 * _cplx(rng, x.size)).astype(np.complex64)
    got = measurements.subband_snrs(torch.as_tensor(x), cell, SF_IDX)
    want = jmeas.subband_snrs(x, jcell, SF_IDX)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    assert abs(measurements.cell_rsrp(torch.as_tensor(x), cell, SF_IDX)
               - jmeas.cell_rsrp(x, jcell, SF_IDX)) <= 1e-4


# --- PDSCH: TM2 (2 and 4 ports) and TM3 (1 and 2 codewords) ---------------

#: (ports, mimo, layers, codewords, JAX turbo decoder) at MCS 10 (16QAM,
#: TBS 1256 at 6 PRB)
PDSCH_CASES = {
    "tm2_2port": (2, "DIVERSITY", 2, 1, "xla"),
    "tm2_4port": (4, "DIVERSITY", 4, 1, "pallas2_interpret"),
    "tm3_1cw": (2, "CDD", 2, 1, "xla"),
    "tm3_2cw": (2, "CDD", 2, 2, "xla"),
    # the port's own ``PdschConfig.plan(decoder_impl=)``: JAX's XLA sweeps
    "tm3_2cw_xla_plan": (2, "CDD", 2, 2, "xla"),
}


def _pdsch_case(name):
    ports, mimo, nl, ncw, impl = PDSCH_CASES[name]
    jcell = JCell(nof_prb=6, nof_ports=ports, id=1)
    mod, tbs = jra.mcs_to_tbs(10, 6)
    jcfg = jpdsch.PdschConfig(cell=jcell, sf_idx=SF_IDX, cfi=CFI, rnti=RNTI,
                              mod=mod, mimo=jeq.MimoType[mimo],
                              nof_layers=nl, nof_codewords=ncw)
    jplan = jcfg.plan(tbs, decoder_impl=impl)
    cfg = pdsch_config_from_fields(vars(jcfg))
    if name.endswith("_xla_plan"):
        plan = cfg.plan(tbs, decoder_impl=decoder_impl_from_jax(impl))
        assert plan == dlsch_plan_from_fields(vars(jplan))
    else:
        # the port decodes with its NII twin
        plan = dlsch_plan_from_fields({**vars(jplan), "decoder_impl": "auto"})
    return jcfg, jplan, cfg, plan


def _channel(rng, mimo, n_rx, n_tx, nof_re):
    """TM2: one complex gain per (rx, port), flat (SFBC combines a pair or
    quad under one channel); TM3: i.i.d. per RE."""
    if mimo == "DIVERSITY":
        g = _cplx(rng, 1, n_rx, n_tx, 1, 1)
        return np.broadcast_to(g, (1, n_rx, n_tx, 14, nof_re)).copy()
    return _cplx(rng, 1, n_rx, n_tx, 14, nof_re)


@pytest.mark.parametrize("name", sorted(PDSCH_CASES))
def test_pdsch_encode_decode_matches_jax(rng, name):
    jcfg, jplan, cfg, plan = _pdsch_case(name)
    ncw = jcfg.nof_codewords
    # the configuration crosses over as plain field values
    assert cfg.mimo.value == jcfg.mimo.value
    assert (cfg.nof_layers, cfg.nof_codewords) == (jcfg.nof_layers, ncw)
    assert cfg.g == jcfg.g and plan.cb_plans == jplan.cb_plans
    tbs = [rng.integers(0, 2, size=(1, jplan.tbs)).astype(np.int8)
           for _ in range(ncw)]
    extra = (lambda b, p: (b[1], p)) if ncw == 2 else (lambda b, p: ())
    got = pdsch.pdsch_encode(torch.as_tensor(tbs[0]), cfg, plan,
                             *extra([torch.as_tensor(t) for t in tbs], plan))
    want = np.asarray(jpdsch.pdsch_encode(
        jnp.asarray(tbs[0]), jcfg, jplan,
        *extra([jnp.asarray(t) for t in tbs], jplan)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)

    n_rx = 2
    h = _channel(rng, PDSCH_CASES[name][1], n_rx, want.shape[1],
                 jcfg.cell.nof_re)
    n0 = np.float32(1e-3)
    y = np.einsum("brpsk,bpsk->brsk", h, want) + np.sqrt(n0) * _cplx(
        rng, 1, n_rx, 14, jcfg.cell.nof_re)
    y = y.astype(np.complex64)

    def jax_rx(y, h):
        out = jpdsch.pdsch_decode(y, h, jcfg, jplan, noise_est=n0,
                                  **({"plan2": jplan} if ncw == 2 else {}))
        return out[:2]

    bits_j, ok_j = jax.jit(jax_rx)(jnp.asarray(y), jnp.asarray(h))
    out = pdsch.pdsch_decode(torch.as_tensor(y), torch.as_tensor(h), cfg,
                             plan, noise_est=float(n0),
                             **({"plan2": plan} if ncw == 2 else {}))
    bits, ok = out[:2]
    if ncw == 1:
        bits, ok, bits_j, ok_j = (bits,), (ok,), (bits_j,), (ok_j,)
    for b, o, bj, oj, sent in zip(bits, ok, bits_j, ok_j, tbs):
        np.testing.assert_array_equal(o.numpy(), np.asarray(oj))
        np.testing.assert_array_equal(b.numpy(), np.asarray(bj))
        assert o.all() and (b.numpy() == sent).all()


# --- 4-port control channels ------------------------------------------------


def test_four_port_pcfich_and_pdcch_match_jax(rng):
    """The PCFICH, and the PDCCH on SFBC-FSTD (TS 36.211 6.8.4), against
    JAX's with its 4-port PDCCH replaced by the specification's
    (``tests/jax_dl_spec.py``: JAX sends SFBC on ports 0 and 1)."""
    from tests.jax_dl_spec import spec_downlink

    with spec_downlink():
        _four_port_control(rng)


def _four_port_control(rng):
    jcell = JCell(nof_prb=6, nof_ports=4, id=1)
    cell = Cell(nof_prb=6, nof_ports=4, id=1)
    n_cce = pdcch_nof_cces(jcell, CFI)
    cands = jpdcch.ue_search_candidates(RNTI, SF_IDX, n_cce)
    l, cce = cands[-1]
    size = format1_size(6)
    dci = rng.integers(0, 2, size).astype(np.int8)
    grid = enb_dl_base_grid(jcell, SF_IDX)
    grid = jpcfich.pcfich_put(grid, CFI, jcell, SF_IDX)
    want_tx = grid + jpdcch.pdcch_encode(jnp.asarray(dci), RNTI, cce, l,
                                         jcell, CFI, SF_IDX)
    from empower_srslte_tpu_torch.models.enb_dl import (
        enb_dl_base_grid as base_grid)
    got_tx = pcfich.pcfich_put(base_grid(cell, SF_IDX, device="cpu"), CFI,
                               cell, SF_IDX)
    got_tx = got_tx + pdcch.pdcch_encode(torch.as_tensor(dci), RNTI, cce, l,
                                         cell, CFI, SF_IDX)
    np.testing.assert_allclose(got_tx.numpy(), np.asarray(want_tx),
                               rtol=1e-6, atol=1e-6)

    # one rx antenna, flat per-port gains, noise at 20 dB
    g = _cplx(rng, 4, 1, 1)
    y = (np.sum(g * np.asarray(want_tx), axis=0)
         + 0.1 * _cplx(rng, 14, jcell.nof_re)).astype(np.complex64)[None]
    h = np.broadcast_to(g, (4, 14, jcell.nof_re)).astype(np.complex64)[None]
    (cfi, corr), (cfi_j, corr_j) = _both(
        lambda a, b: pcfich.pcfich_decode(a, b, cell, SF_IDX, 0.01),
        lambda a, b: jpcfich.pcfich_decode(a, b, jcell, SF_IDX, 0.01), y, h)
    np.testing.assert_array_equal(_np(cfi), _np(cfi_j))
    assert (_np(cfi) == CFI).all()
    np.testing.assert_allclose(_np(corr), _np(corr_j), atol=1e-5)

    llr, llr_j = _both(
        lambda a, b: pdcch.pdcch_extract_llr(a, b, cell, CFI, SF_IDX, 0.01),
        lambda a, b: jpdcch.pdcch_extract_llr(a, b, jcell, CFI, SF_IDX,
                                              0.01), y[0], h[0])
    np.testing.assert_allclose(_np(llr), _np(llr_j), rtol=1e-5, atol=1e-5)
    hits = pdcch.pdcch_blind_decode(torch.as_tensor(y[0]),
                                    torch.as_tensor(h[0]), cell, CFI, SF_IDX,
                                    RNTI, (size,), noise_est=0.01)
    hits_j = jpdcch.pdcch_blind_decode(jnp.asarray(y[0]), jnp.asarray(h[0]),
                                       jcell, CFI, SF_IDX, RNTI, (size,),
                                       noise_est=0.01)
    assert [(x.l, x.cce, x.payload.tobytes()) for x in hits] == \
        [(x.l, x.cce, x.payload.tobytes()) for x in hits_j]
    assert hits and (hits[0].payload == dci).all()
