"""Port vs JAX reference: PRACH tables, preamble generation and detection,
formats 0-4 with unrestricted and restricted sets
(``tests/test_prach_formats.py``'s cases).

Tables and preamble tables are equal; generated preambles agree to 1e-5.
Detection runs on windows holding the JAX package's preambles plus noise
(numpy draws handed to both): detections and offsets are equal, metrics
agree to 1e-3 relative (the two FFT libraries sum in other orders).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from empower_srslte_tpu.models import prach as jpr
from empower_srslte_tpu.utils.cell import Cell as JCell

from empower_srslte_tpu_torch.models import prach as pr
from empower_srslte_tpu_torch.utils.cell import Cell

CELL, JCELL = Cell(id=1, nof_prb=50), JCell(id=1, nof_prb=50)


def test_format_tables_match_jax():
    for name in ("NZC", "NZC_F4", "TCP_TS", "TSEQ_TS", "NCS_UNRESTRICTED",
                 "NCS_RESTRICTED", "NCS_FORMAT4"):
        assert getattr(pr, name) == getattr(jpr, name), name
    for idx in (0, 17, 35, 51, 63, 70):
        assert pr.preamble_format(idx) == jpr.preamble_format(idx)
    for fmt in range(5):
        np.testing.assert_array_equal(pr.root_table(fmt),
                                      jpr.root_table(fmt))
        for nof_prb in (6, 25, 100):
            c, jc = Cell(nof_prb=nof_prb), JCell(nof_prb=nof_prb)
            for fn in ("prach_seq_len", "prach_cp_len", "prach_total_len"):
                assert getattr(pr, fn)(c, fmt) == getattr(jpr, fn)(jc, fmt)
            for off in (0, 4):
                np.testing.assert_array_equal(
                    pr.prach_freq_bins(c, off, fmt),
                    jpr.prach_freq_bins(jc, off, fmt))


def test_restricted_params_match_jax():
    for u in range(1, 839, 7):
        for ncs in pr.NCS_RESTRICTED:
            assert pr.restricted_params(u, ncs) == \
                jpr.restricted_params(u, ncs), (u, ncs)


@pytest.mark.parametrize("fmt,high_speed", [(0, False), (0, True),
                                            (2, False), (3, True),
                                            (4, False)])
def test_preamble_tables_match_jax(fmt, high_speed):
    zczs = range(7) if fmt == 4 else range(1, 15)
    for zcz in zczs:
        for rsi in (0, 128, 500, 837):
            rsi = rsi % len(pr.root_table(fmt))
            assert pr.preamble_table(rsi, zcz, fmt, high_speed) == \
                jpr.preamble_table(rsi, zcz, fmt, high_speed)
            assert pr._detect_zones(rsi, zcz, fmt, high_speed) == \
                jpr._detect_zones(rsi, zcz, fmt, high_speed)


@pytest.mark.parametrize("fmt,zcz,hs", [(0, 1, False), (1, 5, False),
                                        (2, 5, False), (3, 1, False),
                                        (4, 2, False), (0, 4, True)])
def test_prach_gen_matches_jax(fmt, zcz, hs):
    rsi = 128 if fmt != 4 else 2
    for idx in (0, 7, 63):
        for off in (0, 4):
            got = pr.prach_gen(CELL, rsi, idx, zcz=zcz, freq_offset_prb=off,
                               fmt=fmt, high_speed=hs, device="cpu")
            want = jpr.prach_gen(JCELL, rsi, idx, zcz=zcz,
                                 freq_offset_prb=off, fmt=fmt, high_speed=hs)
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                       atol=1e-5)
    np.testing.assert_array_equal(
        pr.prach_freq_bins(CELL, 0, fmt), jpr.prach_freq_bins(JCELL, 0, fmt))


def _windows(rng, fmt, zcz, idx, delay, high_speed=False, snr_db=None,
             extra=()):
    """Two receive windows (``tests/test_prach_formats.py``'s loopback):
    JAX preamble ``idx`` at ``delay`` (plus ``extra`` (idx, delay) pairs)
    in window 0, window 1 empty; both with the same noise level."""
    rsi = 128 if fmt != 4 else 2
    cp = jpr.prach_cp_len(JCELL, fmt)
    reps = 2 if fmt in (2, 3) else 1
    n = cp + reps * jpr.prach_seq_len(JCELL, fmt) + max(delay, 96) + 64
    sig = np.zeros((2, n), np.complex64)
    for i, d in ((idx, delay), *extra):
        pre = jpr.prach_gen(JCELL, rsi, i, zcz=zcz, fmt=fmt,
                            high_speed=high_speed)
        sig[0, d:d + len(pre)] += pre
    n0 = 10 ** (-(30.0 if snr_db is None else snr_db) / 10)
    sig = sig + (np.sqrt(n0 / 2) * (rng.normal(size=sig.shape)
                                    + 1j * rng.normal(size=sig.shape))
                 ).astype(np.complex64)
    return rsi, sig[:, cp:]


def _compare(rsi, win, fmt, zcz, high_speed=False):
    got = pr.prach_detect(torch.as_tensor(win), CELL, rsi, zcz=zcz, fmt=fmt,
                          high_speed=high_speed)
    want = jpr.prach_detect(jnp.asarray(win), JCELL, rsi, zcz=zcz, fmt=fmt,
                            high_speed=high_speed)
    det, off, met = (x.numpy() for x in got)
    np.testing.assert_array_equal(det, np.asarray(want[0]))
    np.testing.assert_array_equal(off, np.asarray(want[1]))
    np.testing.assert_allclose(met, np.asarray(want[2]), rtol=1e-3)
    assert off.dtype == np.int64 and met.dtype == np.float32
    return det, off


@pytest.mark.parametrize("case", [
    dict(fmt=0, zcz=1, idx=7, delay=0), dict(fmt=1, zcz=1, idx=7, delay=0),
    dict(fmt=2, zcz=1, idx=7, delay=0), dict(fmt=3, zcz=1, idx=7, delay=0),
    dict(fmt=4, zcz=2, idx=5, delay=0), dict(fmt=0, zcz=2, idx=11, delay=0),
    dict(fmt=0, zcz=5, idx=11, delay=0), dict(fmt=0, zcz=10, idx=11, delay=0),
    dict(fmt=0, zcz=4, idx=23, delay=0, high_speed=True),
    dict(fmt=0, zcz=6, idx=3, delay=96),
    dict(fmt=1, zcz=5, idx=31, delay=32, snr_db=0),
    dict(fmt=2, zcz=5, idx=9, delay=0, snr_db=-3),
    dict(fmt=0, zcz=11, idx=40, delay=300, snr_db=0,
         extra=((2, 150), (41, 20)))],
    ids=lambda c: "_".join(f"{k}{v}" for k, v in c.items()
                           if k != "extra"))
def test_prach_detect_matches_jax(case, rng):
    case = dict(case)
    extra = case.pop("extra", ())
    fmt, zcz, idx, delay = (case.pop(k) for k in ("fmt", "zcz", "idx",
                                                  "delay"))
    hs = case.get("high_speed", False)
    rsi, win = _windows(rng, fmt, zcz, idx, delay, extra=extra, **case)
    det, off = _compare(rsi, win, fmt, zcz, hs)
    assert det[0, idx]
    for i, _d in extra:
        assert det[0, i]
    step = jpr.prach_seq_len(JCELL, fmt) // jpr._nzc(fmt)
    assert abs(int(off[0, idx]) - delay) <= 2 * step


def test_prach_stimulus_detects_every_preamble():
    """The chip phase's construction at 1.4 MHz: windows of 1-3 preambles
    at random delays below N_cs, all detected, offsets within one delay
    bin; the format-2 and restricted-set variants too."""
    cell = Cell(nof_prb=6, id=1)
    for kw in (dict(), dict(high_speed=True), dict(fmt=2, zcz=5)):
        st = pr.prach_stimulus(8, cell=cell, freq_offset_prb=0, seed=3,
                               device="cpu", **kw)
        det, off, _ = pr.prach_detect(st.samples, cell, pr.STACK_RSI,
                                      zcz=st.zcz, fmt=st.fmt,
                                      high_speed=st.high_speed)
        sent = st.index >= 0
        rows = st.index.clamp_min(0)
        assert bool((torch.gather(det, 1, rows) | ~sent).all())
        step = pr.prach_seq_len(cell, st.fmt) / pr._nzc(st.fmt)
        err = (torch.gather(off, 1, rows) - st.delay).abs()[sent]
        assert bool((err <= step).all())
    assert pr.prach_false_alarm_rate(11) == pytest.approx(
        64 * 93 * np.exp(-13.0))
