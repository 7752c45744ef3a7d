"""Port vs JAX reference: PSS/SSS, CFO, CP detection, SFO, cell search,
``put_sync_signals`` and ``sync_and_align`` on 1.4 MHz captures made by
the JAX package's transmitter (``tests/test_sync.py``'s construction).

Tolerances: integer outputs (peak positions, IDs, half-frame, offsets,
votes) are equal; correlation magnitudes and PSR agree to rtol 1e-4 (the
two FFT libraries sum in different orders); CFO estimates to 1e-4
subcarrier; tables and grids exactly. The aligned subframes agree to atol
1e-4 on samples of RMS ~0.1: JAX builds the CFO correction's phase
2 pi cfo n / fft in float32 (~3e-5 rad off after 4e4 samples), the port
reduces it to a fraction of a cycle in float64 first.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from empower_srslte_tpu.models import enb_dl as jenb
from empower_srslte_tpu.models import ue_sync as jue_sync
from empower_srslte_tpu.ops import sync as jsync
from empower_srslte_tpu.ops.ofdm import ofdm_tx_sf as jofdm_tx_sf
from empower_srslte_tpu.utils.cell import CP as JCP
from empower_srslte_tpu.utils.cell import Cell as JCell

from empower_srslte_tpu_torch import convert
from empower_srslte_tpu_torch.models import enb_dl, ue_sync
from empower_srslte_tpu_torch.ops import sync

RTOL = 1e-4


def _t(x):
    return torch.as_tensor(np.array(x))


def _noise(rng, n, amp):
    return (amp * (rng.normal(size=n) + 1j * rng.normal(size=n))).astype(
        np.complex64)


def _capture(jcell, rng, nof_sf=22, cfo=0.0, offset=1234, snr_db=20.0,
             payload=None):
    """``tests/test_sync.py``'s capture: base grid + PSS/SSS per subframe
    (plus an optional PDSCH grid in one subframe), CFO, a noise lead-in
    of ``offset`` samples and AWGN, with the JAX transmitter."""
    sfs = []
    for i in range(nof_sf):
        grid = jenb.put_sync_signals(jenb.enb_dl_base_grid(jcell, i % 10, ()),
                                     jcell, i % 10)
        if payload is not None and i % 10 == payload[0]:
            grid = grid + payload[1]
        sfs.append(np.asarray(jenb.enb_dl_gen_signal(grid, jcell))[0])
    sig = np.concatenate(sfs)
    sig = sig * np.exp(2j * np.pi * cfo * np.arange(len(sig))
                       / jcell.fft_size)
    sig = np.concatenate([_noise(rng, offset, 0.01), sig]).astype(np.complex64)
    n0 = np.mean(np.abs(sig) ** 2) / 10 ** (snr_db / 10)
    return (sig + _noise(rng, len(sig), np.sqrt(n0 / 2))).astype(np.complex64)


def test_tables_equal_jax():
    for r in range(3):
        np.testing.assert_array_equal(sync.pss_freq(r), jsync.pss_freq(r))
        for fft in (128, 2048):
            np.testing.assert_array_equal(sync.pss_time(r, fft),
                                          jsync.pss_time(r, fft))
        np.testing.assert_array_equal(sync._sss_table(r),
                                      jsync._sss_table(r))
    for nid1 in (0, 29, 30, 100, 167):
        assert sync._m0m1(nid1) == jsync._m0m1(nid1)
        for sf in (0, 5):
            np.testing.assert_array_equal(sync.sss_freq(nid1, 2, sf),
                                          jsync.sss_freq(nid1, 2, sf))


def test_pss_find_matches_jax(rng):
    """Two windows, each with PSS replicas of two roots in noise."""
    fft, n = 128, 3000
    sig = _noise(rng, (2, n), 0.05).reshape(2, n)
    for b, (root, pos) in enumerate([(1, 700), (2, 1811)]):
        sig[b, pos:pos + fft] += jsync.pss_time(root, fft)
        sig[b, 90:90 + fft] += 0.5 * jsync.pss_time((root + 1) % 3, fft)
    mag, peak, psr = sync.pss_find(_t(sig), fft)
    mag_j, peak_j, psr_j = jsync.pss_find(jnp.asarray(sig), fft)
    np.testing.assert_array_equal(peak.numpy(), np.asarray(peak_j))
    assert peak[0, 1] == 700 and peak[1, 2] == 1811
    np.testing.assert_allclose(mag.numpy(), np.asarray(mag_j), rtol=RTOL,
                               atol=RTOL * float(mag.max()))
    np.testing.assert_allclose(psr.numpy(), np.asarray(psr_j), rtol=RTOL)


def test_cfo_estimates_match_jax(rng):
    fft = 128
    sig = _noise(rng, 2000, 0.02)
    sig[500:500 + fft] += jsync.pss_time(2, fft)
    sig = (sig * np.exp(2j * np.pi * 0.31 * np.arange(2000) / fft)).astype(
        np.complex64)
    est = sync.pss_cfo_estimate(_t(sig[None]), torch.tensor([500]), 2, fft)
    est_j = jsync.pss_cfo_estimate(jnp.asarray(sig[None]),
                                   jnp.asarray([500]), 2, fft)
    assert abs(float(est[0]) - float(est_j[0])) < 1e-4
    assert abs(float(est[0]) - 0.31) < 0.02
    back = sync.cfo_correct(_t(sig), float(est[0]), fft)
    back_j = jsync.cfo_correct(jnp.asarray(sig), float(est[0]), fft)
    np.testing.assert_allclose(back.numpy(), np.asarray(back_j), atol=1e-5)

    jcell = JCell(nof_prb=6, id=1)
    cell = convert.cell_from_fields(vars(jcell))
    s = jofdm_tx_sf(jnp.asarray(_noise(rng, (14, 72), 1.0).reshape(14, 72)),
                    jcell)
    s = np.asarray(s) * np.exp(2j * np.pi * 0.07 * np.arange(s.shape[-1])
                               / 128)
    s = s.astype(np.complex64)
    cp = sync.cp_cfo_estimate(_t(s), cell)
    cp_j = jsync.cp_cfo_estimate(jnp.asarray(s), jcell)
    assert abs(float(cp) - float(cp_j)) < 1e-4
    # r(t) r*(t + fft) of a CFO of +0.07 turns by -2 pi 0.07: the
    # estimator reads it with JAX's sign
    assert abs(float(cp) + 0.07) < 0.01


@pytest.mark.parametrize("nid1,sf", [(0, 0), (17, 5), (167, 0), (83, 5)])
def test_sss_detect_exact_matches_jax(nid1, sf):
    d = jsync.sss_freq(nid1, 2, sf)
    n1, is5, metric = sync.sss_detect(_t(d[None]), 2)
    n1_j, is5_j, metric_j = jsync.sss_detect(jnp.asarray(d[None]), 2)
    assert int(n1[0]) == int(n1_j[0]) == nid1
    assert bool(is5[0]) == bool(is5_j[0]) == (sf == 5)
    np.testing.assert_allclose(metric.numpy(), np.asarray(metric_j),
                               rtol=RTOL)


def test_sss_detect_noisy_matches_jax(rng):
    d = (jsync.sss_freq(101, 0, 5)[None]
         + _noise(rng, (8, 62), 0.6).reshape(8, 62))
    n1, is5, metric = sync.sss_detect(_t(d), 0)
    n1_j, is5_j, metric_j = jsync.sss_detect(jnp.asarray(d), 0)
    np.testing.assert_array_equal(n1.numpy(), np.asarray(n1_j))
    np.testing.assert_array_equal(is5.numpy(), np.asarray(is5_j))
    assert (n1.numpy() == 101).sum() >= 6
    np.testing.assert_allclose(metric.numpy(), np.asarray(metric_j),
                               rtol=RTOL)


@pytest.mark.parametrize("cp", ["normal", "extended"])
def test_detect_cp_matches_jax(rng, cp):
    jcell = JCell(nof_prb=6, id=1, cp=JCP(cp))
    grid = _noise(rng, (jcell.nsymb_sf, jcell.nof_re), 1.0).reshape(
        jcell.nsymb_sf, jcell.nof_re)
    s = np.asarray(jofdm_tx_sf(jnp.asarray(grid), jcell))
    is_norm, mn, me = sync.detect_cp(_t(s), 6)
    is_norm_j, mn_j, me_j = jsync.detect_cp(jnp.asarray(s), 6)
    assert bool(is_norm) == bool(is_norm_j) == (cp == "normal")
    np.testing.assert_allclose([float(mn), float(me)],
                               [float(mn_j), float(me_j)], rtol=RTOL)


def test_sfo_estimates_match_jax():
    # ops.sync: the least-squares slope of given peak positions
    peaks = (1000 + 1.7 * np.arange(6)).astype(np.int32)[None]
    peaks[0, 4] += 19200 - 3                      # a frame jump to unwrap
    est = sync.sfo_estimate(_t(peaks), 19200)
    est_j = jsync.sfo_estimate(jnp.asarray(peaks), 19200)
    assert abs(float(est[0]) - float(est_j[0])) < 1e-5
    # models.ue_sync: PSS peaks drifting 3 samples per half-frame
    jcell = JCell(nof_prb=6, id=1)
    half = 5 * jcell.sf_sample_len
    sig = np.zeros(8 * half, np.complex64)
    t = jsync.pss_time(jcell.n_id_2, jcell.fft_size)
    for i in range(8):
        p = 1000 + i * half + int(round(i * 3.0))
        sig[p:p + len(t)] += t
    got = ue_sync.sfo_estimate(sig, 1, 6, max_windows=8, device="cpu")
    want = jue_sync.sfo_estimate(sig, 1, 6, max_windows=8)
    assert got.keys() == want.keys()
    np.testing.assert_array_equal(got["positions"], want["positions"])
    for k in ("sfo_hz", "drift_samples_per_frame", "srate_hz"):
        assert got[k] == pytest.approx(want[k], rel=1e-12)
    assert abs(got["drift_samples_per_frame"] - 6.0) < 0.6


def test_cell_search_vote_matches_jax(rng):
    jcell = JCell(nof_prb=6, id=302)                # N_id_2 = 2
    sig = _capture(jcell, rng, nof_sf=30, offset=0, snr_db=15.0)
    best, votes, psr = ue_sync.cell_search_vote(sig, 6, max_frames=3,
                                                device="cpu")
    best_j, votes_j, psr_j = jue_sync.cell_search_vote(sig, 6, max_frames=3)
    assert (best, votes) == (best_j, votes_j)
    assert best == 2 and votes[2] == 3
    np.testing.assert_allclose(psr, psr_j, rtol=RTOL)


@pytest.mark.parametrize("sf_idx", [0, 5, 3])
def test_put_sync_signals_matches_jax(rng, sf_idx):
    jcell = JCell(nof_prb=15, nof_ports=2, id=211)
    cell = convert.cell_from_fields(vars(jcell))
    base = _noise(rng, (2, 2, 14, jcell.nof_re), 1.0).reshape(
        2, 2, 14, jcell.nof_re)
    got = enb_dl.put_sync_signals(_t(base), cell, sf_idx)
    want = jenb.put_sync_signals(jnp.asarray(base), jcell, sf_idx)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("cell_id,cfo", [(151, 0.0), (301, 0.22),
                                         (7, -0.15)])
def test_sync_and_align_matches_jax(rng, cell_id, cfo):
    jcell = JCell(nof_prb=6, id=cell_id)
    sig = _capture(jcell, rng, cfo=cfo, offset=2500)
    got = ue_sync.sync_and_align(sig, 6, device="cpu")
    want = jue_sync.sync_and_align(sig, 6)
    assert (got.cell_id, got.n_id_2, got.sf0_offset) == \
        (want.cell_id, want.n_id_2, want.sf0_offset)
    assert got.cell_id == cell_id
    assert (got.sf0_offset - 2500) % (10 * jcell.sf_sample_len) == 0
    assert abs(got.cfo - want.cfo) < 1e-4 and abs(got.cfo - cfo) < 0.03
    assert got.metric == pytest.approx(want.metric, rel=RTOL)
    assert got.subframes.device.type == "cpu"
    np.testing.assert_allclose(got.subframes.numpy(),
                               np.asarray(want.subframes), atol=1e-4)


def test_sync_entry_points_refuse_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sig = np.zeros(3 * 19200, np.complex64)
    for call in (lambda: ue_sync.sync_and_align(sig, 6),
                 lambda: ue_sync.cell_search_vote(sig, 6),
                 lambda: ue_sync.sfo_estimate(sig, 0, 6)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
