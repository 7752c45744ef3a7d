"""The whole slice, port vs JAX reference, at Cell(nof_prb=6, nof_ports=2):
the 2x2 TM4 two-codeword transmitter and the no-genie receiver chain of
the reference's full-chain benchmark (bench.py ``bench_uedl(mimo=True)``)
at batch 4 and 30 dB, plus the per-subframe ``ue_dl_decode``.

The JAX chain decodes with ``decoder_impl="pallas2_interpret"`` (its NII
Pallas kernel in interpret mode, tiny tiles as in the reference's tests);
the port runs on the CPU. Decoded bits and flags must be equal; the
transmitters' samples agree to float32 FFT rounding (atol 1e-5 on samples
of RMS ~0.1: the two FFT libraries sum in different orders).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from empower_srslte_tpu.models import dci as jdci
from empower_srslte_tpu.models import ra as jra
from empower_srslte_tpu.models.enb_dl import (enb_dl_base_grid,
                                              enb_dl_gen_signal)
from empower_srslte_tpu.models.pcfich import pcfich_decode, pcfich_put
from empower_srslte_tpu.models.pdcch import (pdcch_blind_bits, pdcch_encode,
                                             pdcch_extract_llr,
                                             ue_search_candidates)
from empower_srslte_tpu.models.pdsch import (PdschConfig, pdsch_decode,
                                             pdsch_encode)
from empower_srslte_tpu.models.regs import pdcch_nof_cces
from empower_srslte_tpu.models.ue_dl import ue_dl_decode as jax_ue_dl_decode
from empower_srslte_tpu.ops.chest import chest_dl, noise_est_pilots
from empower_srslte_tpu.ops.equalizer import MimoType
from empower_srslte_tpu.ops.ofdm import ofdm_rx_sf
from empower_srslte_tpu.utils.bits import uint_to_bits
from empower_srslte_tpu.utils.cell import Cell as JCell
from empower_srslte_tpu.utils.crc import CRC16

from empower_srslte_tpu_torch.convert import (cell_from_fields,
                                              dlsch_plan_from_fields,
                                              pdsch_config_from_fields)
from empower_srslte_tpu_torch.models.enb_dl import enb_dl_tm4, tm4_draws
from empower_srslte_tpu_torch.models.ue_dl import (ue_dl_decode,
                                                   ue_dl_tm4_batch)

BATCH, NOF_PRB, MCS, CFI, SF_IDX, RNTI = 4, 6, 10, 2, 1, 0x1234
#: per-transmission SNR at which one MCS-9 transmission fails alone and
#: two combined decode
SNR_HARQ = 0.0


@pytest.fixture(autouse=True)
def _tiny_tiles(monkeypatch):
    monkeypatch.setenv("TURBO_SUB", "8")
    monkeypatch.setenv("TURBO_LANES", "1")


def _jax_tm4_tx(cell, cfg, plan):
    """bench.py make_tx (the mimo branch) on the JAX package, compiled as
    one function of the draws."""

    def tx(d):
        grid = enb_dl_base_grid(cell, SF_IDX, batch_shape=(BATCH,))
        grid = pcfich_put(grid, CFI, cell, SF_IDX)
        grid = grid + pdcch_encode(d["dci_bits"], RNTI, 0, 4, cell, CFI,
                                   SF_IDX)
        grid = grid + pdsch_encode(d["tb"], cfg, plan, d["tb2"], plan)
        grid = jnp.einsum("brp,bpsk->brsk", d["h2"], grid)
        samples = enb_dl_gen_signal(grid, cell)
        p_sig = jnp.mean(jnp.abs(samples) ** 2)
        sigma = jnp.sqrt(p_sig * 10 ** (-30.0 / 10) / 2)
        return samples + sigma * jax.lax.complex(d["nz_re"], d["nz_im"])

    return jax.jit(tx)


def _jax_tm4_rx(cell, cfg, plan, sizes):
    """bench.py fn (the mimo branch): per-subframe counts kept apart."""
    cands = ue_search_candidates(RNTI, SF_IDX, pdcch_nof_cces(cell, CFI))
    mask16 = jnp.asarray(uint_to_bits(RNTI & 0xFFFF, 16))

    def fn(samples):
        grid = ofdm_rx_sf(samples, cell)
        h = jnp.stack([jnp.stack([chest_dl(grid[:, r], cell, SF_IDX, port=p)
                                  for p in range(2)], axis=1)
                       for r in range(2)], axis=1)
        n0 = jnp.maximum(noise_est_pilots(grid[:, 0], cell, SF_IDX), 1e-7)
        grid0, h0 = grid[:, 0], h[:, 0]
        cfi_hat, _ = pcfich_decode(grid0, h0, cell, SF_IDX,
                                   noise_est=n0[..., None])
        llr = pdcch_extract_llr(grid0, h0, cell, CFI, SF_IDX,
                                noise_est=n0[..., None])
        n_det = jnp.zeros((BATCH,), jnp.int32)
        for size in sizes:
            bits = pdcch_blind_bits(llr, cands, size)
            unmasked = jnp.concatenate(
                [bits[..., :size], jnp.bitwise_xor(bits[..., size:], mask16)],
                axis=-1)
            n_det = n_det + jnp.sum(
                CRC16.jnp_check(unmasked).astype(jnp.int32), axis=-1)
        (b1, b2), (ok1, ok2), _ = pdsch_decode(
            grid, h, cfg, plan, noise_est=n0[:, None], plan2=plan)
        return cfi_hat, n_det, b1, b2, ok1, ok2

    return jax.jit(fn)


def test_tm4_slice_matches_jax():
    jcell = JCell(nof_prb=NOF_PRB, nof_ports=2, id=1)
    mod, tbs = jra.mcs_to_tbs(MCS, NOF_PRB)
    jcfg = PdschConfig(cell=jcell, sf_idx=SF_IDX, cfi=CFI, rnti=RNTI,
                       mod=mod, mimo=MimoType.SPATIAL_MUX, nof_layers=2,
                       nof_codewords=2)
    jplan = jcfg.plan(tbs, decoder_impl="pallas2_interpret")
    sizes = sorted({jdci.format1_size(NOF_PRB), jdci.format0_1a_size(NOF_PRB)})
    d = tm4_draws(BATCH, tbs, jdci.format1_size(NOF_PRB),
                  jcell.sf_sample_len)

    # the configuration crosses over as plain field values
    cfg = pdsch_config_from_fields(vars(jcfg))
    plan = dlsch_plan_from_fields(vars(jplan))
    assert plan.cb_plans == jplan.cb_plans

    y_jax = np.array(_jax_tm4_tx(jcell, jcfg, jplan)(d))
    noise = torch.complex(torch.as_tensor(d["nz_re"]),
                          torch.as_tensor(d["nz_im"]))
    y_port = enb_dl_tm4(torch.as_tensor(d["tb"]), torch.as_tensor(d["tb2"]),
                        torch.as_tensor(d["h2"]), noise, cfg, plan,
                        torch.as_tensor(d["dci_bits"]), 0, 4)
    np.testing.assert_allclose(y_port.numpy(), y_jax, rtol=1e-4, atol=1e-5)

    cfi_j, det_j, b1_j, b2_j, ok1_j, ok2_j = (
        np.asarray(x) for x in _jax_tm4_rx(jcell, jcfg, jplan, sizes)(
            jnp.asarray(y_jax)))
    res = ue_dl_tm4_batch(torch.as_tensor(y_jax), cfg, plan)

    np.testing.assert_array_equal(res.cfi.numpy(), cfi_j)
    assert (cfi_j == CFI).all()
    np.testing.assert_array_equal(res.dci_hits.numpy(), det_j)
    assert (det_j >= 1).all()
    for got, ref, sent in ((res.tb_bits[0], b1_j, d["tb"]),
                           (res.tb_bits[1], b2_j, d["tb2"])):
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(got.numpy(), sent)
    np.testing.assert_array_equal(res.crc_ok[0].numpy(), ok1_j)
    np.testing.assert_array_equal(res.crc_ok[1].numpy(), ok2_j)
    assert ok1_j.all() and ok2_j.all()


def _single_port_subframe(rng, snr_db, tb=None, mcs=9):
    """One 1.4 MHz single-port subframe with a format-1 grant (HARQ
    process 1, NDI 1) at the largest aggregation of the search space,
    made by the JAX transmitter -> (samples complex64 [sf_len], tb, cell).
    """
    jcell = JCell(nof_prb=NOF_PRB, nof_ports=1, id=1)
    l, cce = max(ue_search_candidates(RNTI, SF_IDX,
                                      pdcch_nof_cces(jcell, CFI)))
    dci_bits = jdci.pack_format1(NOF_PRB, (1 << 6) - 1, mcs, harq_pid=1,
                                 ndi=1, rv=0)
    mod, tbs = jra.mcs_to_tbs(mcs, NOF_PRB)
    cfg = PdschConfig(cell=jcell, sf_idx=SF_IDX, cfi=CFI, rnti=RNTI,
                      mod=mod, prb_mask=(True,) * NOF_PRB)
    if tb is None:
        tb = rng.integers(0, 2, size=(tbs,)).astype(np.int8)
    grid = enb_dl_base_grid(jcell, SF_IDX)
    grid = pcfich_put(grid, CFI, jcell, SF_IDX)
    grid = grid + pdcch_encode(jnp.asarray(dci_bits), RNTI, cce, l, jcell,
                               CFI, SF_IDX)
    grid = grid + pdsch_encode(jnp.asarray(tb), cfg, cfg.plan(tbs))
    x = np.asarray(enb_dl_gen_signal(grid, jcell))[0]
    sigma = np.sqrt(np.mean(np.abs(x) ** 2) * 10 ** (-snr_db / 10) / 2)
    n = rng.normal(size=(2, x.size)).astype(np.float32)
    return (x + sigma * (n[0] + 1j * n[1])).astype(np.complex64), tb, jcell


def test_ue_dl_decode_matches_jax(rng):
    samples, tb, jcell = _single_port_subframe(rng, snr_db=25.0)
    cell = cell_from_fields(vars(jcell))
    ref = jax_ue_dl_decode(samples, jcell, SF_IDX, RNTI, harq_state={})
    got = ue_dl_decode(torch.as_tensor(samples), cell, SF_IDX, RNTI,
                       harq_state={})
    assert len(got) == len(ref) == 1
    g, r = got[0], ref[0]
    assert (g.cfi, g.cce, g.crc_ok) == (r.cfi, r.cce, r.crc_ok)
    assert g.crc_ok
    assert vars(g.dci) == vars(r.dci)
    np.testing.assert_array_equal(g.tb_bits, r.tb_bits)
    np.testing.assert_array_equal(g.tb_bits, tb)
    assert abs(g.noise_est - r.noise_est) <= 1e-4 * max(r.noise_est, 1e-9)


def test_ue_dl_decode_harq_combining(rng):
    """Two transmissions of one TB, each too noisy to decode alone: the
    first leaves its softbuffers in the HARQ state, the second (same NDI)
    combines with them and decodes."""
    samples, tb, jcell = _single_port_subframe(rng, snr_db=SNR_HARQ)
    retx, _, _ = _single_port_subframe(rng, snr_db=SNR_HARQ, tb=tb)
    cell = cell_from_fields(vars(jcell))
    alone = ue_dl_decode(torch.as_tensor(retx), cell, SF_IDX, RNTI)
    assert alone[0].dci is not None and not alone[0].crc_ok
    harq: dict = {}
    first = ue_dl_decode(torch.as_tensor(samples), cell, SF_IDX, RNTI,
                         harq_state=harq)
    assert first[0].dci is not None and not first[0].crc_ok
    assert harq[1]["soft"] is not None
    second = ue_dl_decode(torch.as_tensor(retx), cell, SF_IDX, RNTI,
                          harq_state=harq)
    assert second[0].crc_ok
    np.testing.assert_array_equal(second[0].tb_bits, tb)
    assert harq[1]["soft"] is None
