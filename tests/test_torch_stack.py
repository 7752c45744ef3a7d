"""The port's eNB/UE/EPC stack over the IQ air, on the CPU.

The JAX package's stack scenarios with their asserts (``tests/
test_stack.py``, ``tests/test_mimo_stack.py``), run on the port's stack
with ``device="cpu"``: attach and the user plane both ways, the noisy air
with S1AP through the port's ``lte_attach`` entry point, timing advance
over a delayed uplink, the spec-timed Msg3 at n+6, the SR decision on a
subframe without an SR, TM4's two codewords on a 2-port cell, a cold
boot (``tests/test_cold_boot.py``) and eMBMS beside unicast
(``tests/test_mbms_ota.py``); and the eNB's cached PUSCH decoders.
"""

import numpy as np
import pytest
import torch

from empower_srslte_tpu_torch.apps.lte_attach import epc as _epc
from empower_srslte_tpu_torch.stack import Air, EnbStack, UeStack
from empower_srslte_tpu_torch.upper.gtpu import gtpu_unpack
from empower_srslte_tpu_torch.utils.cell import Cell


def _pair(cell, **kw):
    mme, nas = _epc()
    enb = EnbStack(cell, mme, device="cpu", **kw)
    ue = UeStack(cell, nas, device="cpu", **kw)
    return mme, enb, ue


def _run(enb, ue, air, max_tti=80):
    ul_iq = None
    for tti in range(max_tti):
        dl_iq = enb.tti(tti, air.ul(ul_iq) if ul_iq is not None else None)
        ul_iq = ue.tti(tti, air.dl(dl_iq))
        if ue.rrc.nas.attached and ue.rrc.drbs:
            return tti
    return -1


def test_attach_and_user_plane_both_directions():
    """Attach over the ideal air, then IP packets over DRB1: UE ->
    PDCP/RLC-UM/MAC -> PUSCH -> eNB -> GTP-U -> SP-GW, and SP-GW ->
    GTP-U -> eNB -> PDSCH -> UE."""
    cell = Cell(nof_prb=25, id=1)
    mme, enb, ue = _pair(cell)
    air = Air(cell.sf_sample_len)
    ping = b"\x45\x00" + bytes(18) + b"PING-FROM-UE-01"
    ul_iq, attached_at = None, None
    for tti in range(100):
        dl_iq = enb.tti(tti, air.ul(ul_iq) if ul_iq is not None else None)
        ul_iq = ue.tti(tti, air.dl(dl_iq))
        if attached_at is None and ue.rrc.nas.attached and ue.rrc.drbs:
            attached_at = tti
            ue.send_ip(ping)
            pong = (b"\x45\x00" + bytes(14)
                    + bytes(map(int, ue.rrc.nas.ue_ip.split(".")))
                    + b"PONG-TO-THE-UE!")
            fwd = mme.spgw.downlink(pong)
            assert fwd is not None
            enb.deliver_gtpu(fwd[1])
        if enb.ul_gtpu and ue.rx_ip:
            break
    assert attached_at is not None, "attach did not complete"
    assert "contention_resolved" in ue.events
    assert any(e.startswith("prach_rapid7_") for e in enb.events)
    assert ue.rrc.nas.ue_ip.startswith("172.16.0.")
    assert ue.rrc.drbs == [1]
    assert ue.rrc.security_activated
    assert enb.ul_gtpu and ue.rx_ip, "user plane did not flow"
    assert gtpu_unpack(enb.ul_gtpu[0])[1].endswith(b"PING-FROM-UE-01")
    assert ue.rx_ip[0].endswith(b"PONG-TO-THE-UE!")
    # the SP-GW forwards the uplink out of its SGi side
    assert mme.spgw.uplink(enb.ul_gtpu[0]).endswith(b"PING-FROM-UE-01")


def test_noisy_air_with_s1ap_through_the_entry_point(caplog):
    """``lte_attach`` on the CPU: S1AP over the local socket, 15 dB air
    with the JAX test's channel gains, attach, then one ping and one
    pong."""
    from empower_srslte_tpu_torch.apps import lte_attach

    assert lte_attach.main(["--cpu", "--snr", "15"]) == 0
    log = caplog.text
    assert "[MME] initial_ctx_setup_complete" in log
    assert "ATTACH COMPLETE" in log and "DRBs [1]" in log
    assert "USER PLANE" in log and "PING-FROM-UE-01" in log \
        and "PONG-TO-THE-UE!" in log


def test_attach_over_delayed_air():
    """A 120-sample uplink delay: the eNB measures it on the PRACH,
    commands a timing advance in the RAR, and the UE's timed-TX advance
    aligns Msg3 and everything after it."""
    cell = Cell(nof_prb=25, id=1)
    _mme, enb, ue = _pair(cell)
    air = Air(cell.sf_sample_len, delay_samples=120)
    ul_iq = None
    for tti in range(100):
        dl_iq = enb.tti(tti, air.ul(ul_iq, advance=ue.timing_advance)
                        if ul_iq is not None else None)
        ul_iq = ue.tti(tti, air.dl(dl_iq))
        if ue.rrc.nas.attached and ue.rrc.drbs:
            break
    ta_unit = 16 * cell.fft_size // 2048
    tas = [int(e.rsplit("ta", 1)[1]) for e in enb.events
           if e.startswith("prach_rapid7_ta")]
    assert tas and abs(tas[0] * ta_unit - 120) <= 8, enb.events[:4]
    assert f"ta_applied_{tas[0]}" in ue.events, ue.events[:6]
    assert ue.timing_advance == tas[0] * ta_unit
    assert ue.rrc.nas.attached and ue.rrc.drbs, ue.events[-10:]


def test_attach_with_spec_n_plus_6_msg3():
    cell = Cell(nof_prb=25, id=1)
    _mme, enb, ue = _pair(cell, msg3_delay=6)
    tti = _run(enb, ue, Air(cell.sf_sample_len))
    assert tti > 0, "attach did not complete with n+6 msg3"
    assert ue.rrc.nas.attached and ue.rrc.drbs == [1]


def test_no_sr_decided_on_a_subframe_without_an_sr():
    """On the attached UE's SR occasion, noise alone (where the format-1
    bit |d| > 0.5 reads 1 about half the time) decides no SR: the eNB
    keeps the JAX stack's energy rule. The UE's SR on the same occasion
    is detected."""
    from empower_srslte_tpu_torch.models.pucch import (PucchConfig,
                                                       pucch_f1_bits,
                                                       pucch_f1_decode)
    from empower_srslte_tpu_torch.models.ue_ul import (enb_ul_receive_grid,
                                                       ue_ul_generate)
    from empower_srslte_tpu_torch.stack.enb import SR_SUBFRAME
    from empower_srslte_tpu_torch.stack.params import PUCCH_N_RB_2

    cell = Cell(nof_prb=25, id=1)
    _mme, enb, ue = _pair(cell)
    last = _run(enb, ue, Air(cell.sf_sample_len))
    assert last > 0
    rnti = ue.c_rnti
    ctx = enb.rrc.ues[rnti]
    sr_sf = ctx.get("sr_subframe", SR_SUBFRAME)
    pcfg = lambda: PucchConfig(cell=cell, sf_idx=sr_sf,
                               n_pucch=ctx.get("sr_n_pucch", 0),
                               format="1", n_rb_2=PUCCH_N_RB_2)
    sr = ue_ul_generate(cell, pucch=(pcfg(), (1,)), device="cpu").numpy()
    sigma = np.sqrt(np.mean(np.abs(sr) ** 2) / 2)      # 0 dB of the SR
    rng = np.random.default_rng(3)
    tti = last + 1 + (sr_sf + 1 - (last + 1)) % 10    # (tti - 1) % 10 == sr_sf
    naive_sr = []
    for n in range(9):
        noise = (sigma * (rng.normal(size=sr.shape)
                          + 1j * rng.normal(size=sr.shape))).astype(
                              np.complex64)
        with_sr = n == 8
        rx = 0.85 * np.exp(-0.3j) * sr + noise if with_sr else noise
        # an SR occasion with no PUSCH or HARQ-ACK due and no UL grant open
        enb.active_ues[rnti]["want_ul"] = False
        enb.ul_pending.pop(tti - 1, None)
        enb.ack_pending.pop(tti - 1, None)
        n_ev = len(enb.events)
        enb.tti(tti, rx.astype(np.complex64))
        detected = f"sr_detected_rnti{rnti:#x}" in enb.events[n_ev:]
        assert detected == with_sr, (n, enb.events[n_ev:])
        if not with_sr:
            d, _ = pucch_f1_decode(enb_ul_receive_grid(
                torch.as_tensor(rx), cell), pcfg())
            naive_sr.append(bool(pucch_f1_bits(d, "1")[0]))
        tti += 10
    assert any(naive_sr), "the noise never fooled the |d| > 0.5 bit"


def test_tm4_two_codewords():
    """Two queued downlink packets ride one spatially multiplexed
    format-2 grant (TM4, 2 layers, 2 codewords) on a 2-port cell; the
    one-antenna UE blind-decodes the format-2 DCI and both transport
    blocks."""
    cell = Cell(nof_prb=25, id=1, nof_ports=2)
    mme, enb, ue = _pair(cell)
    air = Air(cell.sf_sample_len, h_dl=(1.0, 0.45 - 0.62j))
    ul_iq, attached_at, pushed = None, None, False
    for tti in range(140):
        dl_iq = enb.tti(tti, air.ul(ul_iq) if ul_iq is not None else None)
        ul_iq = ue.tti(tti, air.dl(dl_iq))
        if attached_at is None and ue.rrc.nas.attached and ue.rrc.drbs:
            attached_at = tti
        if attached_at is not None and not pushed \
                and tti == attached_at + 12:
            pushed = True
            # sized so that RLC cannot concatenate both into one PDU
            for tag in (b"TB0-OVER-LAYER0" + b"0" * 140,
                        b"TB1-OVER-LAYER1" + b"1" * 140):
                pong = (b"\x45\x00" + bytes(14)
                        + bytes(map(int, ue.rrc.nas.ue_ip.split(".")))
                        + tag)
                fwd = mme.spgw.downlink(pong)
                enb.deliver_gtpu(fwd[1])
        if pushed and len(ue.rx_ip) >= 2:
            break
    assert any(e.startswith("tm4_tx") for e in enb.events), \
        [e for e in enb.events if "tm4" in e][-4:] or enb.events[-8:]
    assert len(ue.rx_ip) >= 2, (ue.events[-10:], enb.events[-10:])
    tags = {p[20:35] for p in ue.rx_ip}
    assert tags == {b"TB0-OVER-LAYER0", b"TB1-OVER-LAYER1"}


def test_cold_boot_search_mib_sib_attach():
    """A UE that knows only the RF geometry (PCI 0, root 0) finds the
    broadcasting PCI-77 cell, reads the MIB on the PBCH and SIB1/SIB2 on
    the SI-RNTI, camps, and attaches with the acquired PRACH root."""
    cell = Cell(nof_prb=25, id=77)
    mme, nas = _epc()
    enb = EnbStack(cell, mme, rsi=384, broadcast=True, device="cpu")
    ue = UeStack(Cell(nof_prb=25, id=0), nas, rsi=0, cold_start=True,
                 device="cpu")
    _run(enb, ue, Air(cell.sf_sample_len), max_tti=260)
    assert any(e.startswith("cell_found_id77") for e in ue.events), \
        ue.events[:6]
    assert any(e.startswith("mib_prb25") for e in ue.events), ue.events[:8]
    assert "sib1_acquired" in ue.events
    assert any(e.startswith("sib2_acquired_rsi384")
               for e in ue.events), ue.events[:12]
    assert "camped" in ue.events
    assert ue.cell.id == 77 and ue.cell.nof_prb == 25
    assert ue.rsi == 384
    assert ue.rrc.nas.attached and ue.rrc.drbs, ue.events[-12:]


def test_mbms_mcch_then_mtch_with_unicast():
    """eMBMS on the attach's cell (``tests/test_mbms_ota.py``): subframe
    3 of every frame is an MBSFN subframe; the UE reads the MCCH at the
    signalling MCS, learns the data MCS, then receives three MTCH packets
    from the MBMS-GW in order, while the unicast attach completes."""
    from empower_srslte_tpu_torch.epc.mbms_gw import MbmsGw

    cell = Cell(nof_prb=25, id=1)
    _mme, enb, ue = _pair(cell)
    enb.enable_mbms(area_id=1, data_mcs=9)
    ue.enable_mbms(area_id=1)
    air = Air(cell.sf_sample_len)
    gw = MbmsGw()
    gw.add_enb(enb.deliver_m1)
    ul, pushed, attached_at = None, 0, None
    for tti in range(180):
        dl = enb.tti(tti, air.ul(ul) if ul is not None else None)
        ul = ue.tti(tti, air.dl(dl))
        if attached_at is None and ue.rrc.nas.attached and ue.rrc.drbs:
            attached_at = tti
        if (any(e.startswith("mcch_acquired") for e in ue.events)
                and pushed < 3):
            pushed += 1
            gw.forward(b"\x45\x00" + bytes(18)
                       + b"MBMS-PACKET-%03d" % pushed)
        if len(ue.rx_mbms) >= 3 and attached_at is not None:
            break
    assert any(e.startswith("mcch_acquired_mcs9") for e in ue.events), \
        [e for e in ue.events if "mcch" in e or "mtch" in e]
    assert len(ue.rx_mbms) >= 3, ue.events[-10:]
    assert ue.rx_mbms[0].endswith(b"MBMS-PACKET-001")
    assert ue.rx_mbms[2].endswith(b"MBMS-PACKET-003")
    assert attached_at is not None and ue.rrc.nas.attached
    assert gw.stats_tx == 3


@pytest.mark.parametrize("with_soft", [False, True])
@pytest.mark.parametrize("uci", [False, True])
def test_pusch_decode_jit_caches_per_key(uci, with_soft):
    """The eNB's cached PUSCH decoders (the JAX package's signatures and
    cache keys): one closure per key, and the same results as an uncached
    ``pusch_decode`` / ``pusch_decode_uci`` on a Msg3-shaped grant."""
    from empower_srslte_tpu_torch.models import ra
    from empower_srslte_tpu_torch.models.pusch import (
        PuschConfig, UciData, UciPlan, pusch_decode, pusch_decode_jit,
        pusch_decode_uci, pusch_decode_uci_jit, pusch_encode,
        pusch_encode_uci)
    from empower_srslte_tpu_torch.models.ue_ul import enb_ul_receive_grid
    from empower_srslte_tpu_torch.runtime import trace

    cell = Cell(nof_prb=25, id=1)
    mod, tbs = ra.mcs_to_tbs(4, 4, dl=False)
    cfg = PuschConfig(cell=cell, sf_idx=7, rnti=0x46, mod=mod, prb_start=10,
                      n_prb=4)
    rng = np.random.default_rng(11)
    tb = torch.as_tensor(rng.integers(0, 2, tbs).astype(np.int8))
    if uci:
        plan = UciPlan(cfg, tbs, UciData(ack=(1, 0)))
        grid = pusch_encode_uci(tb, cfg, plan)
        fn = pusch_decode_uci_jit(cfg, plan, with_soft)
        assert pusch_decode_uci_jit(cfg, plan, with_soft) is fn
        assert pusch_decode_uci_jit(cfg, plan, not with_soft) is not fn
    else:
        plan = cfg.plan(tbs)
        grid = pusch_encode(tb, cfg, plan)
        fn = pusch_decode_jit(cfg, tbs, 0, with_soft)
        assert pusch_decode_jit(cfg, tbs, 0, with_soft) is fn
        assert pusch_decode_jit(cfg, tbs, 1, with_soft) is not fn
    grid = grid + 0.05 * torch.as_tensor(
        (rng.normal(size=grid.shape) + 1j * rng.normal(size=grid.shape))
        .astype(np.complex64))
    soft = None
    if with_soft:
        # a first, failed copy's softbuffers, as a HARQ retransmission has
        decode = pusch_decode_uci if uci else pusch_decode
        first = decode(0.02 * grid, cfg, plan, noise_est=1e-3)
        soft = first["softbuffers"] if uci else first[2]
    args = (grid, 1e-3) + ((soft,) if with_soft else ())
    got = fn(*args)
    if uci:
        ref = pusch_decode_uci(grid, cfg, plan, noise_est=1e-3,
                               softbuffers=soft)
        assert [int(a) for a in got["ack"]] == [1, 0]
        assert [int(a) for a in ref["ack"]] == [1, 0]
        got = (got["tb"], got["crc_ok"], got["softbuffers"])
        ref = (ref["tb"], ref["crc_ok"], ref["softbuffers"])
    else:
        ref = pusch_decode(grid, cfg, plan, noise_est=1e-3,
                           softbuffers=soft)
    assert bool(got[1]) and bool(ref[1])
    assert torch.equal(got[0], tb) and torch.equal(ref[0], tb)
    for a, b in zip(got[2], ref[2]):
        assert torch.equal(a, b)
    assert "turbo_nii" not in trace.launch_counts()
    assert not trace.launch_shapes("turbo_nii")
