"""Port vs JAX reference: PHICH at 1, 2 and 4 ports, the eNB subframe
composer, and ``ue_dl_decode`` on a 4-port cell (Cell(6 PRB, 4 ports))
with a PHICH, with an SI-RNTI format 1C grant in the common search space,
with a TM2 (SFBC-FSTD) grant, and with an int8-lane HARQ retransmission
pair.

Both receivers decode the same time samples, made by the JAX package's
transmitter; the port's composer must build the same grids (to 1e-6).
The port's PHICH follows TS 36.211 6.9, its 4-port PDCCH 6.8.4 and its
DL-SCH's E split 36.212 5.1.4.1.2, where the JAX package's depart from
them, so JAX's ``phich_put``, ``phich_decode``, 4-port ``pdcch_encode``
and ``pdcch_extract_llr`` and its plans' N_L are replaced by the
specification's (``tests/jax_dl_spec.py``) in every test here; every other
JAX stage is compared as it is.
The JAX ``ue_dl_decode`` decodes with its XLA turbo decoder on the CPU,
the port with its NII twin. Result fields (CFI, DCI, CCE, CRC, PHICH bit,
the bits of a passing decode) must be equal, and equal to what was sent.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from empower_srslte_tpu.models import dci as jdci
from empower_srslte_tpu.models import pdcch as jpdcch
from empower_srslte_tpu.models import phich as jphich
from empower_srslte_tpu.models import ra as jra
from empower_srslte_tpu.models.enb_dl import (enb_dl_base_grid,
                                              enb_dl_gen_signal)
from empower_srslte_tpu.models.pcfich import pcfich_put
from empower_srslte_tpu.models.pdsch import PdschConfig, pdsch_encode
from empower_srslte_tpu.models.ue_dl import ue_dl_decode as jax_ue_dl_decode
from empower_srslte_tpu.ops.equalizer import MimoType as JMimo
from empower_srslte_tpu.ops.modem import Mod as JMod
from empower_srslte_tpu.utils.cell import Cell as JCell

from empower_srslte_tpu_torch import convert
from empower_srslte_tpu_torch.models import enb_dl, phich
from empower_srslte_tpu_torch.models.ue_dl import ue_dl_decode
from empower_srslte_tpu_torch.ops.equalizer import MimoType

from tests.jax_dl_spec import spec_downlink

SF_IDX, CFI, RNTI, SI_RNTI, MCS = 1, 3, 0x1234, 0xFFFF, 9
#: flat per-port gains of the one rx antenna's channel
GAINS = np.array([0.9 + 0.3j, -0.4 + 0.8j, 0.7 - 0.6j, 0.2 + 0.9j],
                 np.complex64)
#: per-transmission SNR of the HARQ pair: MCS 9 on SFBC-FSTD fails alone
#: and decodes combined, on both packages' decoders
SNR_HARQ = 1.5


@pytest.fixture(scope="module", autouse=True)
def _spec_downlink():
    """The JAX package's PHICH, 4-port PDCCH and E split held to TS
    36.211/36.212."""
    with spec_downlink():
        yield


def _cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64) / np.float32(np.sqrt(2))


@pytest.mark.parametrize("ports", [1, 2, 4])
def test_phich_matches_jax(rng, ports):
    jcell = JCell(nof_prb=15, nof_ports=ports, id=7)
    cell = convert.cell_from_fields(vars(jcell))
    group, seq = phich.phich_resource(cell, 9, n_dmrs=1)
    assert (group, seq) == jphich.phich_resource(jcell, 9, n_dmrs=1)
    base = _cplx(rng, ports, 14, jcell.nof_re)
    for ack in (0, 1):
        got = phich.phich_put(torch.as_tensor(base), ack, cell, SF_IDX,
                              group, seq)
        want = np.asarray(jphich.phich_put(jnp.asarray(base), ack, jcell,
                                           SF_IDX, group, seq))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        g = _cplx(rng, ports, 1, 1)
        y = (np.sum(g * want, axis=0)
             + 0.2 * _cplx(rng, 14, jcell.nof_re))[None]
        h = np.broadcast_to(g, (ports, 14, jcell.nof_re))[None]
        h = (h if ports > 1 else h[:, 0]).astype(np.complex64)
        a, m = phich.phich_decode(torch.as_tensor(y), torch.as_tensor(h),
                                  cell, SF_IDX, group, seq, noise_est=0.04)
        a_j, m_j = jphich.phich_decode(jnp.asarray(y), jnp.asarray(h), jcell,
                                       SF_IDX, group, seq, noise_est=0.04)
        np.testing.assert_array_equal(a.numpy(), np.asarray(a_j))
        assert bool(a[0]) == bool(ack)
        np.testing.assert_allclose(m.numpy(), np.asarray(m_j), atol=1e-5)


def _jax_subframe(jcell, *, dcis, pdschs, phichs=()):
    """The JAX package's composition of one subframe [P, nsymb, nre]."""
    grid = pcfich_put(enb_dl_base_grid(jcell, SF_IDX), CFI, jcell, SF_IDX)
    for bits, rnti, cce, l in dcis:
        grid = grid + jpdcch.pdcch_encode(jnp.asarray(bits), rnti, cce, l,
                                          jcell, CFI, SF_IDX)
    for ack, group, seq in phichs:
        grid = jphich.phich_put(grid, ack, jcell, SF_IDX, group, seq)
    for tb, cfg, plan in pdschs:
        ports = pdsch_encode(jnp.asarray(tb)[None], cfg, plan)[0]
        grid = grid.at[:ports.shape[0]].add(ports)
    return np.asarray(grid)


def _case(rng, name, rv=0, tb=None):
    """(samples, what was sent, decode kwargs) for one subframe."""
    jcell = JCell(nof_prb=6, nof_ports=4, id=1)
    cell = convert.cell_from_fields(vars(jcell))
    mimo = JMimo.DIVERSITY if name in ("diversity", "int8_harq") \
        else JMimo.SINGLE
    layers = 4 if mimo is JMimo.DIVERSITY else 1
    phichs = []
    if name == "si_1c":
        rnti = SI_RNTI
        bits = jdci.pack_format1c(6, 0, 4, 5)
        d = jdci.unpack_format1c(bits, 6)
        tbs = int(jra.tbs_format1c_table()[5])
        cfg = PdschConfig(cell=jcell, sf_idx=SF_IDX, cfi=CFI, rnti=rnti,
                          mod=JMod.QPSK, mimo=mimo,
                          prb_mask=d.prb_mask,
                          prb_mask_slot1=d.prb_mask_slot1)
    else:
        rnti = RNTI
        bits = jdci.pack_format1(6, (1 << 6) - 1, MCS, harq_pid=1, ndi=1,
                                 rv=rv)
        mod, tbs = jra.mcs_to_tbs(MCS, 6)
        cfg = PdschConfig(cell=jcell, sf_idx=SF_IDX, cfi=CFI, rnti=rnti,
                          mod=mod, mimo=mimo, nof_layers=layers,
                          prb_mask=(True,) * 6)
        if name == "phich":
            phichs = [(1, *jphich.phich_resource(jcell, 3))]
    if tb is None:
        tb = rng.integers(0, 2, tbs).astype(np.int8)
    dcis = [(bits, rnti, 0, 4)]
    pdschs = [(tb, cfg, cfg.plan(tbs, rv=rv))]
    grid = _jax_subframe(jcell, dcis=dcis, pdschs=pdschs, phichs=phichs)
    port_cfg = convert.pdsch_config_from_fields(vars(cfg))
    got = enb_dl.enb_dl_subframe(
        cell, SF_IDX, CFI, dcis=dcis, phichs=phichs,
        pdschs=[(torch.as_tensor(tb), port_cfg, port_cfg.plan(tbs, rv=rv))],
        device="cpu")
    np.testing.assert_allclose(got.numpy(), grid, rtol=1e-6, atol=1e-6)

    x = np.einsum("p,pt->t", GAINS, np.asarray(enb_dl_gen_signal(
        jnp.asarray(grid), jcell)))
    snr_db = SNR_HARQ if name == "int8_harq" else 20.0
    sigma = np.sqrt(np.mean(np.abs(x) ** 2) * 10 ** (-snr_db / 10))
    y = (x + sigma * _cplx(rng, x.size)).astype(np.complex64)
    kw = dict(rnti=rnti, llr_int8=name == "int8_harq",
              phich=phichs[0][1:] if phichs else None)
    sent = dict(tb=tb, ack=bool(phichs[0][0]) if phichs else None)
    return jcell, cell, mimo, y, sent, kw


def _decode_both(jcell, cell, mimo, y, kw, harq=None, harq_j=None):
    ref = jax_ue_dl_decode(y, jcell, SF_IDX, mimo=mimo, harq_state=harq_j,
                           **kw)
    got = ue_dl_decode(torch.as_tensor(y), cell, SF_IDX,
                       mimo=MimoType(mimo.value), harq_state=harq, **kw)
    assert len(got) == len(ref) == 1
    g, r = got[0], ref[0]
    assert (g.cfi, g.cce, g.crc_ok, g.phich_ack) == \
        (r.cfi, r.cce, r.crc_ok, r.phich_ack)
    assert type(g.dci).__name__ == type(r.dci).__name__
    assert vars(g.dci) == vars(r.dci)
    if r.crc_ok:     # a failed decode's bits are each decoder's own
        np.testing.assert_array_equal(g.tb_bits, r.tb_bits)
    assert abs(g.noise_est - r.noise_est) <= 1e-4 * max(r.noise_est, 1e-9)
    return g


@pytest.mark.parametrize("name", ["phich", "si_1c", "diversity"])
def test_ue_dl_decode_matches_jax(rng, name):
    jcell, cell, mimo, y, sent, kw = _case(rng, name)
    g = _decode_both(jcell, cell, mimo, y, kw, harq={}, harq_j={})
    assert g.cfi == CFI and g.crc_ok
    np.testing.assert_array_equal(g.tb_bits, sent["tb"])
    assert g.phich_ack == sent["ack"]
    if name == "si_1c":
        assert type(g.dci).__name__ == "DciDl1C"


def test_ue_dl_decode_int8_harq_pair_matches_jax(rng):
    """rv 0 then rv 2 of one TB under one HARQ process and NDI, on the
    int8 lane: the first copy fails and leaves int8 softbuffers, the
    retransmission combines with them and decodes."""
    jcell, cell, mimo, y0, sent, kw = _case(rng, "int8_harq", rv=0)
    *_, y2, _, _ = _case(rng, "int8_harq", rv=2, tb=sent["tb"])
    harq, harq_j = {}, {}
    first = _decode_both(jcell, cell, mimo, y0, kw, harq, harq_j)
    assert first.dci is not None and not first.crc_ok
    assert all(s.dtype == torch.int8 for s in harq[1]["soft"])
    assert all(np.asarray(s).dtype == np.int8 for s in harq_j[1]["soft"])
    second = _decode_both(jcell, cell, mimo, y2, kw, harq, harq_j)
    assert second.crc_ok and harq[1]["soft"] is None
    np.testing.assert_array_equal(second.tb_bits, sent["tb"])


def test_tm2_frame_stimulus_calibration():
    """The 20 MHz 4-port frame that chip_smoke.py's ``ue_dl_frame`` phase
    decodes on the card, checked here with the plain twins: the HARQ pair's
    rv 0 copy fails alone on the int8 lane and the retransmission decodes
    combined; sf 5's SI-RNTI format 1C grant decodes; the PHICH bits and
    CFI are right."""
    fr = enb_dl.tm2_frame_stimulus(device="cpu")
    harq: dict = {}
    sf0, sf1 = enb_dl.FRAME_HARQ_SFS
    for sf in (sf0, sf1):
        r = ue_dl_decode(fr.samples[sf], fr.cell, sf, fr.rnti,
                         mimo=MimoType.DIVERSITY, harq_state=harq,
                         phich=fr.phich, llr_int8=True)
        assert len(r) == 1 and r[0].cfi == enb_dl.FRAME_CFI
        assert r[0].crc_ok == (sf == sf1)
        assert r[0].phich_ack == bool(fr.acks[sf])
    np.testing.assert_array_equal(r[0].tb_bits, fr.tb[sf1].numpy())
    sf = enb_dl.FRAME_SI_SF
    r = ue_dl_decode(fr.samples[sf], fr.cell, sf, 0xFFFF,
                     mimo=MimoType.DIVERSITY)
    assert len(r) == 1 and type(r[0].dci).__name__ == "DciDl1C"
    assert r[0].crc_ok
    np.testing.assert_array_equal(r[0].tb_bits, fr.si_tb.numpy())


def test_new_entry_points_refuse_to_fall_back(monkeypatch):
    from empower_srslte_tpu_torch.models.pdsch import PdschConfig as Cfg
    from empower_srslte_tpu_torch.utils.cell import Cell

    cell = Cell(nof_prb=6, nof_ports=4, id=1)
    cfg = Cfg(cell=cell, mimo=MimoType.DIVERSITY, nof_layers=4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        enb_dl.enb_dl_subframe(cell, SF_IDX, CFI)
    with pytest.raises(RuntimeError, match="CUDA"):
        enb_dl.tm2_frame_stimulus()
    with pytest.raises(RuntimeError, match="CUDA"):
        enb_dl.genie_stimulus(cfg, cfg.plan(120), 1, 1e-3)
    grid = enb_dl.enb_dl_subframe(cell, SF_IDX, CFI, device="cpu")
    assert grid.device.type == "cpu" and grid.shape == (4, 14, 72)
    st = enb_dl.genie_stimulus(cfg, cfg.plan(120), 2, 1e-3, device="cpu")
    assert st.y.shape == (2, 2, 14, 72) and st.h.shape == (2, 2, 4, 14, 72)
