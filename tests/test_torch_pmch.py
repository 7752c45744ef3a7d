"""Port vs JAX reference: the MBSFN reference signals and RE map, the
MBSFN OFDM pair (non-MBSFN regions 1 and 2), the unicast pair on both
CPs, and the PMCH chain (``tests/test_pmch.py``'s cases) on 6- and 25-PRB
extended-CP cells.

Tables and encoded grids are equal; samples through an FFT in two
libraries agree to 1e-5; the channel estimate to 1e-5. The JAX chain
(encode, channel estimate, decode) compiles as one ``jax.jit`` at 6 PRB,
where its ``"xla"`` plan decodes with its XLA scan; CRC flags and bits
are equal, and equal to what was sent. The port decodes with its default
NII plan (the kernel's plain twin on the CPU).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from empower_srslte_tpu.models import pmch as jpm
from empower_srslte_tpu.ops import ofdm as jofdm
from empower_srslte_tpu.ops.modem import Mod as JMod
from empower_srslte_tpu.utils.cell import CP as JCP
from empower_srslte_tpu.utils.cell import Cell as JCell

from empower_srslte_tpu_torch.models import pmch as pm
from empower_srslte_tpu_torch.ops import ofdm
from empower_srslte_tpu_torch.ops.modem import Mod
from empower_srslte_tpu_torch.utils.cell import CP, Cell


def _cfgs(prb=6, area=5, sf=2, cfi=2, mod="QAM16"):
    cfg = pm.PmchConfig(cell=Cell(nof_prb=prb, id=1, cp=CP.EXT),
                        area_id=area, sf_idx=sf, cfi=cfi, mod=Mod[mod])
    jcfg = jpm.PmchConfig(cell=JCell(nof_prb=prb, id=1, cp=JCP.EXT),
                          area_id=area, sf_idx=sf, cfi=cfi, mod=JMod[mod])
    return cfg, jcfg


def _grid(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)) \
        .astype(np.complex64)


def test_mbsfn_rs_and_re_map_match_jax():
    for prb in (6, 25, 100):
        for area in (0, 1, 5):
            for sf in (1, 2, 3):
                rows, syms, vals = pm.mbsfn_rs(area, prb, sf)
                jrows, jsyms, jvals = jpm.mbsfn_rs(area, prb, sf)
                np.testing.assert_array_equal(syms, jsyms)
                for a, b in zip(rows, jrows):
                    np.testing.assert_array_equal(a, b)
                for a, b in zip(vals, jvals):
                    np.testing.assert_array_equal(a, b)
        for cfi in (1, 2):
            cfg, jcfg = _cfgs(prb=prb, cfi=cfi)
            idx = pm.pmch_re_indices(cfg.cell, 2, cfi)
            np.testing.assert_array_equal(
                idx, jpm.pmch_re_indices(jcfg.cell, 2, cfi))
            assert cfg.nof_re == jcfg.nof_re and cfg.g == jcfg.g
            assert cfg.cinit() == jcfg.cinit()
            rows, syms, _ = pm.mbsfn_rs(5, prb, 2)
            nre = cfg.cell.nof_re
            rs_flat = {int(s) * nre + int(k) for row, s in zip(rows, syms)
                       for k in row}
            assert not set(idx.tolist()) & rs_flat
    with pytest.raises(ValueError):
        pm.PmchConfig(cell=Cell(nof_prb=6))


@pytest.mark.parametrize("prb", [6, 25, 100])
@pytest.mark.parametrize("region", [1, 2])
def test_mbsfn_ofdm_pair_matches_jax(prb, region, rng):
    cell, jcell = Cell(nof_prb=prb, id=1), JCell(nof_prb=prb, id=1)
    grid = _grid(rng, 2, 12, 12 * prb)
    starts = ofdm._symbol_starts_mbsfn(prb, region)
    np.testing.assert_array_equal(starts,
                                  jofdm._symbol_starts_mbsfn(prb, region))
    tx = ofdm.ofdm_tx_sf_mbsfn(torch.as_tensor(grid), cell, region)
    jtx = np.asarray(jofdm.ofdm_tx_sf_mbsfn(jnp.asarray(grid), jcell, region))
    assert tx.shape[-1] == cell.sf_sample_len
    scale = np.abs(jtx).max()
    np.testing.assert_allclose(tx.numpy(), jtx, rtol=1e-5, atol=1e-5 * scale)
    rx = ofdm.ofdm_rx_sf_mbsfn(tx, cell, region)
    jrx = np.asarray(jofdm.ofdm_rx_sf_mbsfn(jnp.asarray(jtx), jcell, region))
    np.testing.assert_allclose(rx.numpy(), jrx, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(rx.numpy(), grid, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prb", [6, 25])
def test_ofdm_pair_both_cps_match_jax(prb, rng):
    """The unicast pair on normal and extended CP (the PMCH cell is the
    extended-CP twin): samples and grids equal to JAX's to 1e-5."""
    for cp, jcp in ((CP.NORM, JCP.NORM), (CP.EXT, JCP.EXT)):
        cell = Cell(nof_prb=prb, id=2, cp=cp)
        jcell = JCell(nof_prb=prb, id=2, cp=jcp)
        grid = _grid(rng, 3, cell.nsymb_sf, cell.nof_re)
        tx = ofdm.ofdm_tx_sf(torch.as_tensor(grid), cell)
        jtx = np.asarray(jofdm.ofdm_tx_sf(jnp.asarray(grid), jcell))
        np.testing.assert_allclose(tx.numpy(), jtx, rtol=1e-5,
                                   atol=1e-5 * np.abs(jtx).max())
        rx = ofdm.ofdm_rx_sf(tx, cell)
        np.testing.assert_allclose(
            rx.numpy(), np.asarray(jofdm.ofdm_rx_sf(jnp.asarray(jtx), jcell)),
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rx.numpy(), grid, rtol=1e-5, atol=1e-5)


def test_put_rs_and_chest_match_jax(rng):
    for prb in (6, 25):
        cfg, jcfg = _cfgs(prb=prb, area=1, sf=1)
        grid = _grid(rng, 2, 12, 12 * prb)
        put = pm.pmch_put_rs(torch.as_tensor(grid), cfg)
        jput = np.asarray(jpm.pmch_put_rs(jnp.asarray(grid), jcfg))
        np.testing.assert_array_equal(put.numpy(), jput)
        noisy = (jput * (0.8 - 0.3j) + 0.05 * _grid(rng, *jput.shape)) \
            .astype(np.complex64)
        h = pm.pmch_chest(torch.as_tensor(noisy), cfg)
        jh = np.asarray(jpm.pmch_chest(jnp.asarray(noisy), jcfg))
        np.testing.assert_allclose(h.numpy(), jh, rtol=1e-5,
                                   atol=1e-5 * np.abs(jh).max())


def _jax_chain(jcfg, jplan, n0):
    @jax.jit
    def run(tb, rx):
        grid = jpm.pmch_encode(tb, jcfg, jplan)
        bits, ok, _ = jpm.pmch_decode(rx, jcfg, jplan, noise_est=n0)
        return grid, bits, ok
    return run


def test_pmch_chain_matches_jax(rng):
    """Encode, flat channel + AWGN, decode: the grids are equal, and CRC
    flags and bits equal JAX's and the sent bits; a wrong MBSFN area's
    descrambling fails every CRC (``tests/test_pmch.py``)."""
    cfg, jcfg = _cfgs()
    tbs, n0 = 1096, 2e-3
    plan = cfg.plan(tbs)
    jplan = jcfg.plan(tbs, decoder_impl="xla")
    tb = rng.integers(0, 2, size=(3, tbs)).astype(np.int8)
    grid = pm.pmch_encode(torch.as_tensor(tb), cfg, plan)
    rx = (grid.numpy() * (0.9 * np.exp(0.5j))
          + np.sqrt(n0 / 2) * _grid(rng, *grid.shape)).astype(np.complex64)
    rx[2] = 0.9 * np.sqrt(n0 / 2) * _grid(rng, *rx.shape[1:])  # noise only
    jgrid, jbits, jok = _jax_chain(jcfg, jplan, n0)(jnp.asarray(tb),
                                                   jnp.asarray(rx))
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jgrid))
    bits, ok, soft = pm.pmch_decode(torch.as_tensor(rx), cfg, plan,
                                    noise_est=n0)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.tolist() == [True, True, False]
    np.testing.assert_array_equal(bits.numpy()[:2], np.asarray(jbits)[:2])
    np.testing.assert_array_equal(bits.numpy()[:2], tb[:2])
    assert len(soft) == plan.segm.c

    other, _ = _cfgs(area=9)
    _, ok_other, _ = pm.pmch_decode(grid, other, plan)
    assert not ok_other.any()


def test_pmch_stimulus_decodes():
    """The chip phase's chain at 6 PRB: ``pmch_stimulus`` (extended-CP
    twin, cfi 2, MBSFN OFDM, 25 dB) through ``pmch_receive``, data MCS and
    the MCCH's MCS."""
    for mcs in (pm.MTCH_MCS, pm.MCCH_MCS):
        st = pm.pmch_stimulus(2, mcs=mcs, nof_prb=6, device="cpu")
        assert st.cfg.cfi == 2 and st.cfg.cell.cp is CP.EXT
        its: list = []
        bits, ok, _ = pm.pmch_receive(st.samples, st, iters_out=its)
        assert bool(ok.all()) and torch.equal(bits, st.tb) and its
