"""Port vs JAX reference: the format-2 (TM4) grant at a one-antenna UE,
and cold acquisition from raw IQ (``sync_and_align`` -> ``ue_mib_acquire``
-> ``ue_dl_decode`` of a format-1 grant) on captures made by the JAX
package's transmitter; then the 20 MHz cold-boot capture that
chip_smoke.py's ``cold_boot`` phase acquires on the card, built here at
6 PRB by the port's transmitter and acquired with the plain twins.

The JAX ``ue_dl_decode`` decodes with its XLA turbo decoder on the CPU,
the port with its NII twin. Cell IDs, offsets, MIB dicts, DCIs, codeword
indices and CRC flags are equal, and so are the bits of every decode
whose CRC passes (a failed decode's bits are each decoder's own). CFO
estimates agree to 1e-4 subcarrier; the two transmitters' samples to
1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from empower_srslte_tpu.models import dci as jdci
from empower_srslte_tpu.models import pbch as jpbch
from empower_srslte_tpu.models import ra as jra
from empower_srslte_tpu.models import ue_dl as jue_dl
from empower_srslte_tpu.models import ue_sync as jue_sync
from empower_srslte_tpu.models.enb_dl import (enb_dl_base_grid,
                                              enb_dl_gen_signal,
                                              put_sync_signals)
from empower_srslte_tpu.models.pcfich import pcfich_put
from empower_srslte_tpu.models.pdcch import pdcch_encode
from empower_srslte_tpu.models.pdsch import PdschConfig as JPdschConfig
from empower_srslte_tpu.models.pdsch import pdsch_encode
from empower_srslte_tpu.ops.equalizer import MimoType as JMimo
from empower_srslte_tpu.ops.modem import Mod as JMod
from empower_srslte_tpu.utils.cell import Cell as JCell

from empower_srslte_tpu_torch import convert
from empower_srslte_tpu_torch.models import enb_dl, ue_dl, ue_sync
from empower_srslte_tpu_torch.models.pdcch import ue_search_candidates
from empower_srslte_tpu_torch.models.regs import pdcch_nof_cces
from empower_srslte_tpu_torch.utils.cell import Cell


def _jax_cfg(cfg, jcell):
    """The port's PdschConfig as the JAX package's."""
    return JPdschConfig(cell=jcell, sf_idx=cfg.sf_idx, cfi=cfg.cfi,
                        rnti=cfg.rnti, mod=JMod(cfg.mod.value),
                        mimo=JMimo(cfg.mimo.value),
                        nof_layers=cfg.nof_layers,
                        nof_codewords=cfg.nof_codewords, pmi=cfg.pmi,
                        prb_mask=cfg.prb_mask)


def _same_results(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g.cfi, g.cce, g.cw, g.crc_ok) == (r.cfi, r.cce, r.cw,
                                                  r.crc_ok)
        assert type(g.dci).__name__ == type(r.dci).__name__
        assert vars(g.dci) == vars(r.dci)
        if r.crc_ok:
            np.testing.assert_array_equal(g.tb_bits, r.tb_bits)


def test_format2_at_one_rx_antenna_matches_jax():
    """A format-2 grant (MCS 4 on both codewords, PMI 0) on a 15-PRB
    2-port cell, received by one antenna through port gains (1,
    0.45-0.62j): the 2x2 solve reads rx row 0 for both rows, as JAX's
    clamped index does. JAX decodes codeword 0 and fails codeword 1."""
    cell, rnti, bits, (l, cce), cfg, plan = enb_dl.one_rx_tm4_grant()
    jcell = JCell(nof_prb=cell.nof_prb, nof_ports=2, id=cell.id)
    d = enb_dl.one_rx_tm4_draws(plan.tbs, cell.sf_sample_len)
    sf, cfi = cfg.sf_idx, cfg.cfi
    jcfg = _jax_cfg(cfg, jcell)
    jplan = jcfg.plan(plan.tbs)
    grid = pcfich_put(enb_dl_base_grid(jcell, sf), cfi, jcell, sf)
    grid = grid + pdcch_encode(jnp.asarray(bits), rnti, cce, l, jcell, cfi,
                               sf)
    grid = grid + pdsch_encode(jnp.asarray(d["tb"][:1]), jcfg, jplan,
                               jnp.asarray(d["tb"][1:]), jplan)[0]
    x = np.einsum("p,pt->t", np.asarray(enb_dl.ONE_RX_GAINS, np.complex64),
                  np.asarray(enb_dl_gen_signal(grid, jcell)))
    y = (x + enb_dl.ONE_RX_NOISE * (d["nz"][0] + 1j * d["nz"][1])).astype(
        np.complex64)
    # the port's transmitter builds the same samples (chip_smoke.py
    # decodes its copy on the card)
    _, _, y_port, tb_port = enb_dl.one_rx_tm4_stimulus(device="cpu")
    np.testing.assert_allclose(y_port.numpy(), y, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tb_port.numpy(), d["tb"])

    ref = jue_dl.ue_dl_decode(y, jcell, sf, rnti)
    got = ue_dl.ue_dl_decode(torch.as_tensor(y), cell, sf, rnti)
    _same_results(got, ref)
    assert [type(g.dci).__name__ for g in got] == ["DciDl2"] * 2
    assert [(g.cw, g.crc_ok) for g in got] == [(0, True), (1, False)]
    np.testing.assert_array_equal(got[0].tb_bits, d["tb"][0])


CAP_ID, CAP_SFN, CAP_RNTI, CAP_MCS, CAP_CFI = 31, 52, 0x4601, 9, 2


def _capture(rng, cfo=0.1, offset=777, snr_db=25.0, nof_sf=22):
    """A 6-PRB 1-port capture from SFN CAP_SFN sf 0: CRS and PCFICH in
    every subframe, PSS/SSS, the MIB in every sf 0, a format 1 grant with
    its PDSCH in every sf 3; a CFO, a noise lead-in of ``offset``
    samples and AWGN (``tests/test_sync.py``'s construction)."""
    jcell = JCell(nof_prb=6, id=CAP_ID)
    mod, tbs = jra.mcs_to_tbs(CAP_MCS, 6)
    cfg = JPdschConfig(cell=jcell, sf_idx=3, cfi=CAP_CFI, rnti=CAP_RNTI,
                       mod=mod, prb_mask=(True,) * 6)
    tb = rng.integers(0, 2, tbs).astype(np.int8)
    dci_bits = jdci.pack_format1(6, (1 << 6) - 1, CAP_MCS)
    pdsch = pdsch_encode(jnp.asarray(tb)[None], cfg, cfg.plan(tbs))[0]
    l, cce = max(ue_search_candidates(CAP_RNTI, 3, pdcch_nof_cces(
        convert.cell_from_fields(vars(jcell)), CAP_CFI)))
    sfs = []
    for i in range(nof_sf):
        sfn, sf = divmod(CAP_SFN * 10 + i, 10)
        grid = put_sync_signals(pcfich_put(enb_dl_base_grid(jcell, sf),
                                           CAP_CFI, jcell, sf), jcell, sf)
        if sf == 0:
            grid = jpbch.pbch_put(grid, jnp.asarray(jpbch.mib_pack(
                6, 0, 1, sfn)), jcell, sfn)
        if sf == 3:
            grid = grid + pdcch_encode(jnp.asarray(dci_bits), CAP_RNTI, cce,
                                       l, jcell, CAP_CFI, sf) + pdsch
        sfs.append(np.asarray(enb_dl_gen_signal(grid, jcell))[0])
    sig = np.concatenate(sfs)
    sig = sig * np.exp(2j * np.pi * cfo * np.arange(len(sig)) / 128)
    lead = 0.01 * (rng.normal(size=offset) + 1j * rng.normal(size=offset))
    sig = np.concatenate([lead, sig])
    n0 = np.mean(np.abs(sig) ** 2) / 10 ** (snr_db / 10)
    sig = sig + np.sqrt(n0 / 2) * (rng.normal(size=len(sig))
                                   + 1j * rng.normal(size=len(sig)))
    return sig.astype(np.complex64), tb


def test_capture_to_pdsch_matches_jax(rng):
    sig, tb = _capture(rng)
    got = ue_sync.sync_and_align(sig, 6, device="cpu")
    want = jue_sync.sync_and_align(sig, 6)
    assert (got.cell_id, got.n_id_2, got.sf0_offset) == \
        (want.cell_id, want.n_id_2, want.sf0_offset) == (CAP_ID, 1, 777)
    assert abs(got.cfo - want.cfo) < 1e-4 and abs(got.cfo - 0.1) < 0.03

    geom = Cell(nof_prb=6, id=0)
    mib = ue_dl.ue_mib_acquire(got.subframes[0], geom, got.cell_id)
    mib_j = jue_dl.ue_mib_acquire(np.asarray(want.subframes[0]),
                                  JCell(nof_prb=6, id=0), want.cell_id)
    assert mib == mib_j
    assert (mib["nof_prb"], mib["sfn"], mib["nof_ports"]) == (6, CAP_SFN, 1)

    cell = Cell(nof_prb=mib["nof_prb"], nof_ports=mib["nof_ports"],
                id=got.cell_id)
    jcell = JCell(nof_prb=mib["nof_prb"], nof_ports=mib["nof_ports"],
                  id=want.cell_id)
    res = ue_dl.ue_dl_decode(got.subframes[3], cell, 3, CAP_RNTI)
    ref = jue_dl.ue_dl_decode(np.asarray(want.subframes[3]), jcell, 3,
                              CAP_RNTI)
    _same_results(res, ref)
    assert len(res) == 1 and res[0].crc_ok and res[0].dci.format == "1"
    np.testing.assert_array_equal(res[0].tb_bits, tb)


def test_cold_boot_stimulus_acquires():
    """chip_smoke.py's ``cold_boot`` sequence on its capture, cut to 6
    PRB: the vote, the cell, the frame timing modulo a frame, the CFO, no
    SFO, the MIB of the first whole frame, and its sf-3 data TB."""
    cap = enb_dl.cold_boot_stimulus(nof_prb=6, device="cpu")
    frame = 10 * cap.cell.sf_sample_len
    n_id_2, votes, _ = ue_sync.cell_search_vote(cap.samples, 6, max_frames=2)
    assert n_id_2 == cap.cell.n_id_2 == 1 and votes[1] == 2
    res = ue_sync.sync_and_align(cap.samples, 6)
    assert res.cell_id == enb_dl.COLD_CELL_ID
    assert res.sf0_offset % frame == cap.sf0_offset % frame
    assert abs(res.cfo - enb_dl.COLD_CFO) < 0.03
    sfo = ue_sync.sfo_estimate(res.subframes.reshape(-1), res.n_id_2, 6)
    assert abs(sfo["drift_samples_per_frame"]) < 0.5
    mib = ue_dl.ue_mib_acquire(res.subframes[0], Cell(nof_prb=6, id=0),
                               res.cell_id)
    assert mib == dict(nof_prb=6, phich_dur=enb_dl.COLD_PHICH[0],
                       phich_res=enb_dl.COLD_PHICH[1],
                       sfn_msb=cap.first_sfn >> 2,
                       sfn_mod4=cap.first_sfn % 4, nof_ports=1,
                       sfn=cap.first_sfn)
    sf = enb_dl.COLD_DATA_SF
    out = ue_dl.ue_dl_decode(
        res.subframes[(enb_dl.COLD_DATA_SFN - cap.first_sfn) * 10 + sf],
        Cell(nof_prb=mib["nof_prb"], nof_ports=mib["nof_ports"],
             id=res.cell_id), sf, cap.rnti)
    hits = [r for r in out if r.dci is not None]
    assert len(hits) == 1 and hits[0].crc_ok
    np.testing.assert_array_equal(hits[0].tb_bits, cap.tb.numpy())


def test_acquisition_stimuli_refuse_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        enb_dl.cold_boot_stimulus(nof_prb=6)
    with pytest.raises(RuntimeError, match="CUDA"):
        enb_dl.one_rx_tm4_stimulus()
    assert convert.cell_from_fields(vars(JCell(nof_prb=6, id=3))) == \
        Cell(nof_prb=6, id=3)
