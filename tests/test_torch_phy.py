"""Port vs JAX reference on the receiver's PHY building blocks at
Cell(nof_prb=6, nof_ports=2): OFDM, channel estimation, noise estimate,
2x2 MMSE and SFBC equalizers, soft demapping, descrambling, turbo rate
matching and the TM4 PDSCH encoder.

Tolerances: complex64 FFTs sum in a different order in pocketfft (torch)
and in XLA's CPU FFT, so values through an FFT agree to a few float32
ulps of the transform's scale (atol 1e-5 on unit-power data); elementwise
float32 arithmetic agrees to rtol 1e-5; integer and bit outputs are
equal.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from empower_srslte_tpu.models import pdsch as jpdsch
from empower_srslte_tpu.models.ra import mcs_to_tbs
from empower_srslte_tpu.ops import chest as jchest
from empower_srslte_tpu.ops import equalizer as jeq
from empower_srslte_tpu.ops import modem as jmodem
from empower_srslte_tpu.ops import ofdm as jofdm
from empower_srslte_tpu.ops import scrambling as jscr
from empower_srslte_tpu.ops.fec.rate_matching import RateMatchTurbo as JRm
from empower_srslte_tpu.utils.cell import Cell as JCell

from empower_srslte_tpu_torch.convert import pdsch_config_from_fields
from empower_srslte_tpu_torch.models.pdsch import pdsch_encode
from empower_srslte_tpu_torch.ops import chest, equalizer, modem, ofdm
from empower_srslte_tpu_torch.ops import scrambling
from empower_srslte_tpu_torch.ops.fec.rate_matching import RateMatchTurbo
from empower_srslte_tpu_torch.utils.cell import Cell

FFT_TOL = dict(rtol=1e-4, atol=1e-5)
ELEM_TOL = dict(rtol=1e-5, atol=1e-6)

CELL = Cell(nof_prb=6, nof_ports=2, id=1)
JCELL = JCell(nof_prb=6, nof_ports=2, id=1)


def _cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64) / np.float32(np.sqrt(2))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_ofdm_tx_rx(rng):
    grid = _cplx(rng, 3, 14, CELL.nof_re)
    tx = ofdm.ofdm_tx_sf(torch.as_tensor(grid), CELL)
    np.testing.assert_allclose(_np(tx), _np(jofdm.ofdm_tx_sf(jnp.asarray(grid),
                                                             JCELL)), **FFT_TOL)
    samples = _cplx(rng, 3, CELL.sf_sample_len)
    rx = ofdm.ofdm_rx_sf(torch.as_tensor(samples), CELL)
    np.testing.assert_allclose(
        _np(rx), _np(jofdm.ofdm_rx_sf(jnp.asarray(samples), JCELL)),
        rtol=1e-4, atol=1e-4)    # forward FFT gain: |bin| ~ sqrt(fft)
    back = ofdm.ofdm_rx_sf(tx, CELL)          # ifft carries the 1/N
    np.testing.assert_allclose(_np(back), grid, **FFT_TOL)


@pytest.mark.parametrize("port", [0, 1])
def test_chest_and_noise(rng, port):
    grid = _cplx(rng, 2, 14, CELL.nof_re)
    for sf_idx in (0, 1):
        got = chest.chest_dl(torch.as_tensor(grid), CELL, sf_idx, port=port)
        ref = jchest.chest_dl(jnp.asarray(grid), JCELL, sf_idx, port=port)
        np.testing.assert_allclose(_np(got), _np(ref), **ELEM_TOL)
    n_got = chest.noise_est_pilots(torch.as_tensor(grid), CELL, 1, port=port)
    n_ref = jchest.noise_est_pilots(jnp.asarray(grid), JCELL, 1, port=port)
    np.testing.assert_allclose(_np(n_got), _np(n_ref), **ELEM_TOL)


def test_eq_mux_2x2(rng):
    y = _cplx(rng, 4, 2, 300)
    h = _cplx(rng, 4, 2, 2, 300)
    n0 = np.float32(0.05)
    x, csi = equalizer.eq_mux_2x2(torch.as_tensor(y), torch.as_tensor(h), n0)
    xr, csir = jeq.eq_mux_2x2(jnp.asarray(y), jnp.asarray(h), n0)
    np.testing.assert_allclose(_np(x), _np(xr), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(csi), _np(csir), rtol=1e-4, atol=1e-5)
    he = equalizer.effective_channel_mux(torch.as_tensor(h), pmi=1)
    np.testing.assert_allclose(_np(he), _np(jeq.effective_channel_mux(
        jnp.asarray(h), pmi=1)), **ELEM_TOL)


def test_eq_sfbc_and_precode(rng):
    y = _cplx(rng, 3, 1, 64)
    h0, h1 = _cplx(rng, 3, 1, 64), _cplx(rng, 3, 1, 64)
    x, csi = equalizer.eq_sfbc(*(torch.as_tensor(a) for a in (y, h0, h1)))
    xr, csir = jeq.eq_sfbc(*(jnp.asarray(a) for a in (y, h0, h1)))
    np.testing.assert_allclose(_np(x), _np(xr), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(_np(csi), _np(csir), **ELEM_TOL)
    layers = _cplx(rng, 3, 2, 32)
    np.testing.assert_allclose(
        _np(equalizer.precode_sfbc(torch.as_tensor(layers))),
        _np(jeq.precode_sfbc(jnp.asarray(layers))), **ELEM_TOL)
    np.testing.assert_allclose(
        _np(equalizer.precode_mux_2x2(torch.as_tensor(layers), 2)),
        _np(jeq.precode_mux_2x2(jnp.asarray(layers), 2)), **ELEM_TOL)


@pytest.mark.parametrize("mod", ["QPSK", "QAM16", "QAM64"])
def test_modulate_demod_descramble(rng, mod):
    m, jm = modem.Mod[mod], jmodem.Mod[mod]
    bits = rng.integers(0, 2, size=(2, 60 * m.bits_per_symbol)).astype(np.int8)
    sym = modem.modulate(torch.as_tensor(bits), m)
    np.testing.assert_allclose(_np(sym), _np(jmodem.modulate(
        jnp.asarray(bits), jm)), **ELEM_TOL)
    noisy = _np(sym) + 0.1 * _cplx(rng, *sym.shape)
    llr = modem.demod_soft(torch.as_tensor(noisy), m)
    llr_ref = jmodem.demod_soft(jnp.asarray(noisy), jm)
    np.testing.assert_allclose(_np(llr), _np(llr_ref), **ELEM_TOL)
    c_init = 0x1234 << 14 | 77
    np.testing.assert_array_equal(
        _np(scrambling.descramble_llrs(llr, c_init)),
        _np(jscr.descramble_llrs(llr_ref, c_init)))
    np.testing.assert_array_equal(
        _np(scrambling.scramble_bits(torch.as_tensor(bits), c_init)),
        _np(jscr.scramble_bits(jnp.asarray(bits), c_init)))


@pytest.mark.parametrize("k,f,rv,e", [(512, 0, 0, 1500), (1056, 24, 2, 4000),
                                      (6144, 0, 1, 20000)])
def test_rate_matching_tx_rx(rng, k, f, rv, e):
    d = rng.integers(0, 2, size=(2, 3, k + 4)).astype(np.int8)
    got = RateMatchTurbo(k, f=f).tx(torch.as_tensor(d), rv, e)
    np.testing.assert_array_equal(_np(got), _np(JRm(k, f=f).tx(
        jnp.asarray(d), rv, e)))
    llr = rng.normal(size=(2, e)).astype(np.float32)
    soft = rng.normal(size=(2, 3 * (k + 4))).astype(np.float32)
    for sb in (None, soft):
        d_llr, ns = RateMatchTurbo(k, f=f).rx(
            torch.as_tensor(llr), rv,
            softbuffer=None if sb is None else torch.as_tensor(sb))
        d_ref, ns_ref = JRm(k, f=f).rx(jnp.asarray(llr), rv,
                                       softbuffer=None if sb is None
                                       else jnp.asarray(sb))
        np.testing.assert_allclose(_np(d_llr), _np(d_ref), **ELEM_TOL)
        np.testing.assert_allclose(_np(ns), _np(ns_ref), **ELEM_TOL)


def test_pdsch_encode_tm4(rng):
    mod, tbs = mcs_to_tbs(10, 6)
    jcfg = jpdsch.PdschConfig(cell=JCELL, sf_idx=1, cfi=2, rnti=0x1234,
                              mod=mod, mimo=jeq.MimoType.SPATIAL_MUX,
                              nof_layers=2, nof_codewords=2, pmi=1)
    cfg = pdsch_config_from_fields(vars(jcfg))
    assert cfg.g == jcfg.g and cfg.cell == CELL
    jplan = jcfg.plan(tbs)
    plan = cfg.plan(tbs)
    tb = rng.integers(0, 2, size=(2, tbs)).astype(np.int8)
    tb2 = rng.integers(0, 2, size=(2, tbs)).astype(np.int8)
    got = pdsch_encode(torch.as_tensor(tb), cfg, plan, torch.as_tensor(tb2),
                       plan)
    ref = jpdsch.pdsch_encode(jnp.asarray(tb), jcfg, jplan, jnp.asarray(tb2),
                              jplan)
    np.testing.assert_allclose(_np(got), _np(ref), **ELEM_TOL)
