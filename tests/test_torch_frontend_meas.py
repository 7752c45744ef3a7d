"""Port vs JAX reference: the front end's measurements and helpers:
Gaussian channel-estimate smoothing, the PSS / pilot / empty-subcarrier
noise estimators, RSRP, RSSI, RSRQ and the pilot CFO; the constellation
tables and hard demapper; the AGC loop and the single-shot AGC; linear
interpolation, decimation, upsampling and rational resampling.

Tolerances: taps, constellations and hard bits are equal; channel
estimates within 1e-5, power measurements within rtol 1e-4 (float32 sums
in a different order), CFO within 1e-5 subcarrier; AGC gains within rtol
1e-5 per frame; resampled samples within 1e-5.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from empower_srslte_tpu.models.enb_dl import (enb_dl_base_grid,
                                              enb_dl_gen_signal,
                                              put_sync_signals)
from empower_srslte_tpu.ops import agc as jagc
from empower_srslte_tpu.ops import chest as jchest
from empower_srslte_tpu.ops import modem as jmodem
from empower_srslte_tpu.ops import resampling as jres
from empower_srslte_tpu.ops.ofdm import ofdm_rx_sf as jofdm_rx_sf
from empower_srslte_tpu.utils.cell import Cell as JCell

from empower_srslte_tpu_torch import convert
from empower_srslte_tpu_torch.ops import agc, chest, modem, resampling

RTOL = 1e-4


def _cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64) / np.float32(np.sqrt(2))


def _rx_grid(rng, jcell, sf_idx, cfo=0.0, snr_db=20.0, batch=2):
    """Subframes ``sf_idx`` of ``jcell`` (CRS, PSS/SSS) at one rx antenna,
    per-subframe flat port gains, a CFO and AWGN, demodulated by the JAX
    receiver: [batch, nsymb, nre] complex64 numpy."""
    grid = put_sync_signals(enb_dl_base_grid(jcell, sf_idx, ()), jcell,
                            sf_idx)
    x = np.asarray(enb_dl_gen_signal(grid, jcell))           # [P, T]
    g = _cplx(rng, batch, jcell.nof_ports)
    y = np.einsum("bp,pt->bt", g, x)
    y = y * np.exp(2j * np.pi * cfo * np.arange(y.shape[-1]) / jcell.fft_size)
    sigma = np.sqrt(np.mean(np.abs(y) ** 2) * 10 ** (-snr_db / 10))
    y = (y + sigma * _cplx(rng, *y.shape)).astype(np.complex64)
    return np.array(jofdm_rx_sf(jnp.asarray(y), jcell))


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("std", [0.3, 1.0, 2.5])
def test_gauss_smoothing_matches_jax(rng, std):
    for order in (2, 4, 6):
        np.testing.assert_array_equal(chest.gauss_taps(std, order),
                                      jchest.gauss_taps(std, order))
    for n0 in (0.0, 1e-3, 0.02):
        assert chest.auto_gauss_std(n0) == jchest.auto_gauss_std(n0)
    jcell = JCell(nof_prb=6, nof_ports=2, id=5)
    cell = convert.cell_from_fields(vars(jcell))
    y = _rx_grid(rng, jcell, 3)
    for port in (0, 1):
        got = chest.chest_dl(torch.as_tensor(y), cell, 3, port, gauss_std=std)
        want = jchest.chest_dl(jnp.asarray(y), jcell, 3, port, gauss_std=std)
        _close(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("ports", [1, 2])
def test_measurements_match_jax(rng, ports):
    """The PSS and empty-subcarrier noise of subframe 0, and RSRP, RSSI,
    RSRQ and the pilot CFO (at a CFO of 0.03 subcarrier) of every port."""
    jcell = JCell(nof_prb=15, nof_ports=ports, id=44)
    cell = convert.cell_from_fields(vars(jcell))
    y = _rx_grid(rng, jcell, 0, cfo=0.03)
    yt, yj = torch.as_tensor(y), jnp.asarray(y)
    ce = np.array(jchest.chest_dl(yj, jcell, 0, 0))
    _close(chest.noise_est_pss(yt, torch.as_tensor(ce), cell),
           jchest.noise_est_pss(yj, jnp.asarray(ce), jcell))
    _close(chest.noise_est_empty_sc(yt, cell),
           jchest.noise_est_empty_sc(yj, jcell))
    _close(chest.rssi(yt), jchest.rssi(yj))
    for port in range(ports):
        _close(chest.rsrp(yt, cell, 0, port), jchest.rsrp(yj, jcell, 0, port))
        _close(chest.rsrq(yt, cell, 0, port), jchest.rsrq(yj, jcell, 0, port))
        cfo = chest.cfo_est_pilots(yt, cell, 0, port)
        _close(cfo, jchest.cfo_est_pilots(yj, jcell, 0, port), rtol=0,
               atol=1e-5)
        assert np.all(np.abs(cfo.numpy() - 0.03) < 0.01)


@pytest.mark.parametrize("mod", ["BPSK", "QPSK", "QAM16", "QAM64"])
def test_constellation_and_demod_hard_match_jax(rng, mod):
    m, jm = modem.Mod[mod], jmodem.Mod[mod]
    table = modem.constellation(m)
    np.testing.assert_array_equal(table, jmodem.constellation(jm))
    # the table is the modulator's: each index's bits map to its symbol
    # (the closed-form modulator rounds its products to within an ulp)
    bps = m.bits_per_symbol
    idx = np.arange(2 ** bps)
    bits = ((idx[:, None] >> np.arange(bps - 1, -1, -1)) & 1).astype(np.int8)
    _close(modem.modulate(torch.as_tensor(bits.reshape(-1)), m).numpy(),
           table, rtol=0, atol=1e-6)
    sym = (table[rng.integers(0, len(table), 300)]
           + 0.2 * _cplx(rng, 300)).astype(np.complex64).reshape(3, 100)
    got = modem.demod_hard(torch.as_tensor(sym), m)
    assert got.dtype == torch.int8 and got.shape == (3, 100 * bps)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jmodem.demod_hard(jnp.asarray(sym), jm)))


def _agc_pair(**kw):
    return agc.Agc(**kw), jagc.Agc(**kw)


def _frames(rng, n, size, amp):
    return [(amp * _cplx(rng, size)) for _ in range(n)]


@pytest.mark.parametrize("mode,nof_frames", [("energy", 0), ("peak", 0),
                                             ("energy", 3), ("peak", 2)])
def test_agc_converges_like_jax(rng, mode, nof_frames):
    """``tests/test_rf_hal.py``'s convergence scenario from a weak and a
    strong input, in both level modes, with and without multi-frame
    accumulation: the gain after every frame and the scaled samples."""
    for amp in (0.01, 5.0):
        mine, ref = _agc_pair(target=1.0, bandwidth=0.7, mode=mode,
                              nof_frames=nof_frames)
        for x in _frames(rng, 40, 1024, amp):
            out = mine.process(torch.as_tensor(x))
            out_j = ref.process(x)
            assert mine.gain == pytest.approx(ref.gain, rel=1e-5)
            _close(out.numpy(), out_j, rtol=1e-5, atol=1e-7 * amp)
        assert mine.output_level() == pytest.approx(ref.output_level(),
                                                    rel=1e-5)
        assert mine.rssi() == pytest.approx(ref.rssi(), rel=1e-5)
        if mode == "energy":
            assert abs(mine.output_level() - 1.0) < 0.15


def test_agc_gain_callback_like_jax(rng):
    """The radio owns the gain: both AGCs ask for the same clamped dB
    values and leave the samples untouched."""
    asked, asked_j = [], []

    def radio(log):
        return lambda db: log.append(db) or float(np.clip(db, 0.0, 30.0))

    mine = agc.Agc(target=1.0, bandwidth=0.7, set_gain_callback=radio(asked),
                   min_gain_db=-30, max_gain_db=30)
    ref = jagc.Agc(target=1.0, bandwidth=0.7,
                   set_gain_callback=radio(asked_j), min_gain_db=-30,
                   max_gain_db=30)
    x = 0.01 * _cplx(rng, 512)
    for _ in range(10):
        out = mine.process(torch.as_tensor(x))
        ref.process(x)
    np.testing.assert_allclose(asked, asked_j, rtol=1e-5)
    assert asked[-1] > asked[0]
    assert torch.equal(out, torch.as_tensor(x))


def test_agc_state_carries_from_jax_and_locks(rng):
    """An AGC built from the JAX object's fields continues its loop (the
    carried state is plain floats), and the lock freezes both."""
    ref = jagc.Agc(target=1.0)
    for x in _frames(rng, 5, 256, 0.1):
        ref.process(x)
    mine = agc.Agc(**{f.name: getattr(ref, f.name)
                      for f in dataclasses.fields(ref)
                      if f.name != "_y_tmp"})
    for x in _frames(rng, 5, 256, 3.0):
        mine.process(torch.as_tensor(x))
        ref.process(x)
        assert mine.gain == pytest.approx(ref.gain, rel=1e-5)
    g = mine.gain
    for a in (mine, ref):
        a.set_lock(True)
    big = np.ones(64, np.complex64) * 7.0
    assert torch.equal(mine.process(torch.as_tensor(big)),
                       torch.as_tensor(big))
    ref.process(big)
    assert mine.gain == g and ref.gain == pytest.approx(g, rel=1e-5)


def test_agc_process_single_shot_matches_jax(rng):
    st, st_j = agc.AgcState(), jagc.AgcState()
    for amp in (0.01, 0.02, 5.0, 5.0, 1.0, 0.001):
        x = amp * _cplx(rng, 512)
        st, out = agc.agc_process(st, torch.as_tensor(x), target=2.0,
                                  bandwidth=0.5)
        st_j, out_j = jagc.agc_process(st_j, x, target=2.0, bandwidth=0.5)
        assert st.gain == pytest.approx(st_j.gain, rel=1e-5)
        assert st.avg_power == pytest.approx(st_j.avg_power, rel=1e-5)
        _close(out.numpy(), out_j, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("factor", [2, 3, 4])
def test_resampling_matches_jax(rng, factor):
    x = _cplx(rng, 2, 3, 97)
    xt, xj = torch.as_tensor(x), jnp.asarray(x)
    for got, want in [
            (resampling.interp_linear(xt, factor),
             jres.interp_linear(xj, factor)),
            (resampling.decimate(xt, factor), jres.decimate(xj, factor)),
            (resampling.upsample(xt, factor), jres.upsample(xj, factor)),
            (resampling.decimate(xt, factor, ntaps=17),
             jres.decimate(xj, factor, ntaps=17)),
            (resampling.resample_ratio(xt, factor, 2 * factor - 1),
             jres.resample_ratio(xj, factor, 2 * factor - 1))]:
        assert tuple(got.shape) == tuple(want.shape)
        _close(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(resampling._lowpass_fir(33, 0.5 / factor),
                                  jres._lowpass_fir(33, 0.5 / factor))
    assert resampling.decimate(xt, 1) is xt
    assert resampling.upsample(xt, 1) is xt
