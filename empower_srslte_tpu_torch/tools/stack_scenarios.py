"""The stack's over-the-air scenarios, with the JAX tests' asserts as
checks.

Each scenario is one test of the JAX package's stack tests run on the
port's eNB/UE/EPC stacks, through ``StackDrive`` (``stack_drive.py``), at
that test's size and horizon. It takes a ``ScenarioRun`` (the device
every stack runs on, and the drives it made) and returns ``(checks,
info)``: ``checks`` maps a name to the truth of one of the JAX test's
asserts, ``info`` holds what a report shows beside them (the TTI of each
step the scenario took). The card's smoke run (``chip_smoke.py``) runs
them with ``device="cuda"`` as its ``stack_*`` phases, the CPU tests
(``tests/test_torch_stack_*.py``) with ``device="cpu"``; both require
every check to hold.

    bad, info = failures(periodic_cqi, "cpu")   # bad: the failing checks
"""

from __future__ import annotations

import numpy as np

from .stack_drive import StackDrive

#: every stack test's cell width (srsENB's default n_prb)
NOF_PRB = 25


class ScenarioRun:
    """The device a scenario's stacks run on, ``sync`` for its drives
    (``torch.cuda.synchronize`` on the card, so that each stack's TTI is
    timed to its end), and every ``StackDrive`` it made, in order."""

    def __init__(self, device: str, sync=None):
        self.device, self.sync = device, sync
        self.drives: list = []

    def drive(self, enbs, ues, **kw) -> StackDrive:
        d = StackDrive(enbs, ues, sync=self.sync, **kw)
        self.drives.append(d)
        return d

    def tail(self, n: int = 8) -> list:
        """The last ``n`` events of every stack of every drive (for a
        failure's message)."""
        return [list(s.events[-n:]) for d in self.drives
                for s in d.enbs + d.ues]


def failures(scenario, device: str, **kw):
    """``scenario(ScenarioRun(device), **kw)``. -> (the names of its checks
    that do not hold, its info with the stacks' last events: a failure's
    message)."""
    r = ScenarioRun(device)
    checks, info = scenario(r, **kw)
    return (sorted(k for k, v in checks.items() if not v),
            {**info, "last_events": r.tail()})


def has(log: list, prefix: str) -> bool:
    return any(e.startswith(prefix) for e in log)


def logged(log, prefix: str):
    """A watch condition: an event of ``log()`` starts with ``prefix``."""
    return lambda: has(log(), prefix)


def up(ue):
    """A watch condition: ``ue`` is attached with a DRB."""
    return lambda: bool(ue.rrc.nas.attached and ue.rrc.drbs)


def pong(ip: str, tag: bytes) -> bytes:
    """An IP packet for ``ip`` that ends in ``tag``."""
    return b"\x45\x00" + bytes(14) + bytes(map(int, ip.split("."))) + tag


def epc_two():
    """An MME whose HSS knows ``tests/test_multi_ue.py``'s two
    subscribers, and their UE-side NAS."""
    from ..epc import Hss, Subscriber
    from ..epc.mme import Mme, UeNas
    from ..upper import security

    hss, subs = Hss(), []
    for i, imsi in enumerate(("001010123456789", "001010123456790")):
        k = bytes([0x46 + i]) + bytes.fromhex(
            "5b5ce8b199b49faa5f0a2ee238a6bc")
        opc = security.milenage_opc(
            k, bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318"))
        hss.add_subscriber(Subscriber(name=f"u{i}", auth_algo="mil",
                                      imsi=imsi, key=k, opc=opc))
        subs.append(UeNas(imsi=imsi, key=k, opc=opc))
    return Mme(hss), subs


def pair(run: ScenarioRun, enb_kw=None, ue_kw=None):
    """An eNB/UE pair on the stack tests' Cell(25 PRB, id 1), over the
    demo subscriber's EPC, and an ideal air: (mme, nas, enb, ue, air)."""
    from ..apps import lte_attach
    from ..stack import Air, EnbStack, UeStack
    from ..utils.cell import Cell

    mme, nas = lte_attach.epc()
    cell = Cell(nof_prb=NOF_PRB, id=1)
    enb = EnbStack(cell, mme, device=run.device, **(enb_kw or {}))
    ue = UeStack(cell, nas, device=run.device, **(ue_kw or {}))
    return mme, nas, enb, ue, Air(cell.sf_sample_len)


def run_pong(drive, mme, enb, ue, ip: str, tag: bytes) -> dict:
    """A packet for ``ue``'s ``ip`` from the SP-GW through ``enb``, then
    up to 39 more TTIs until the UE has it (the JAX tests' closing
    loops). -> its checks."""
    fwd = mme.spgw.downlink(pong(ip, tag))
    if fwd is not None:
        enb.deliver_gtpu(fwd[1])
        drive.run(drive.tti + 39, lambda tti: bool(ue.rx_ip))
    return {"pong_forwarded": fwd is not None,
            "pong_at_ue": bool(ue.rx_ip) and ue.rx_ip[0].endswith(tag)}


def _two_ue_drive(run: ScenarioRun, nof_prb: int, **enb_kw):
    """``tests/test_multi_ue.py``'s cell at ``nof_prb``: one eNB, UEs on
    preambles 7 and 23 (the second two frames late), one air whose
    uplink is the sum of both. -> (mme, enb, (ue1, ue2), drive)."""
    from ..stack import Air, EnbStack, UeStack
    from ..utils.cell import Cell

    mme, (nas1, nas2) = epc_two()
    cell = Cell(nof_prb=nof_prb, id=1)
    enb = EnbStack(cell, mme, device=run.device, **enb_kw)
    ues = (UeStack(cell, nas1, preamble=7, ra_delay_frames=0,
                   device=run.device),
           UeStack(cell, nas2, preamble=23, ra_delay_frames=2,
                   device=run.device))
    drive = run.drive([enb], ues, air=Air(cell.sf_sample_len),
                      watch={"attach_ue1": up(ues[0]),
                             "attach_ue2": up(ues[1]),
                             "dl_multiuser": logged(lambda: enb.events,
                                                    "dl_multiuser")})
    return mme, enb, ues, drive


def two_ues_ping(run: ScenarioRun, nof_prb: int = NOF_PRB):
    """``tests/test_multi_ue.py::TestTwoUes``: both UEs attach (distinct
    C-RNTIs, IPs and dedicated PUCCH resources) and ping up through the
    summed uplink; the EmPOWER agent saw both UEs' grants."""
    from ..mac.agent import EmpowerAgent
    from ..upper.gtpu import gtpu_unpack

    _mme, enb, (ue1, ue2), drive = _two_ue_drive(run, nof_prb,
                                                 agent=EmpowerAgent())
    pinged = set()

    def until(tti):
        for i, ue in enumerate((ue1, ue2)):
            if i not in pinged and ue.rrc.nas.attached and ue.rrc.drbs:
                pinged.add(i)
                ue.send_ip(b"\x45\x00" + bytes(18)
                           + b"PING-FROM-UE-%d!" % i)
        return len(enb.ul_gtpu) >= 2

    drive.run(200, until)
    sr = [ue.rrc.sr_cfg for ue in (ue1, ue2)]
    payloads = {gtpu_unpack(p)[1][-15:] for p in enb.ul_gtpu}
    report = enb.agent.emit_reports()
    return {"ue1_attached": ue1.rrc.nas.attached,
            "ue2_attached": ue2.rrc.nas.attached,
            "distinct_c_rnti": ue1.c_rnti != ue2.c_rnti,
            "distinct_ip": ue1.rrc.nas.ue_ip != ue2.rrc.nas.ue_ip,
            "distinct_pucch": None not in sr
            and (sr[0]["n_pucch"], sr[0]["subframe"])
            != (sr[1]["n_pucch"], sr[1]["subframe"]),
            "ping_ue0_at_gw": b"PING-FROM-UE-0!" in payloads,
            "ping_ue1_at_gw": b"PING-FROM-UE-1!" in payloads,
            "agent_saw_both": {u["rnti"] for u in report["ues"]}
            >= {ue1.c_rnti, ue2.c_rnti},
            "agent_dl_prb_used": report["prb"]["dl_prb_used"] > 0,
            "agent_ul_prb_used": report["prb"]["ul_prb_used"] > 0}, {
        "c_rnti": [ue1.c_rnti, ue2.c_rnti], "sr_cfg": sr}


def two_ues_dl(run: ScenarioRun, nof_prb: int = NOF_PRB):
    """``tests/test_multi_ue.py::TestTwoUesDownlink``: once both UEs are
    up, a pong for each; the scheduler packs both PDSCHs into one
    subframe at least once."""
    mme, enb, (ue1, ue2), drive = _two_ue_drive(run, nof_prb)
    pushed, fwd_ok = [], []

    def until(tti):
        if not pushed and all(u.rrc.nas.attached and u.rrc.drbs
                              for u in (ue1, ue2)):
            pushed.append(tti)
            for ue, tag in ((ue1, b"PONG-TO-THE-UE1"),
                            (ue2, b"PONG-TO-THE-UE2")):
                fwd = mme.spgw.downlink(pong(ue.rrc.nas.ue_ip, tag))
                fwd_ok.append(fwd is not None)
                if fwd is not None:
                    enb.deliver_gtpu(fwd[1])
        return bool(pushed) and bool(ue1.rx_ip) and bool(ue2.rx_ip)

    drive.run(200, until)
    return {"pongs_forwarded": fwd_ok == [True, True],
            "pong_at_ue1": bool(ue1.rx_ip)
            and ue1.rx_ip[0].endswith(b"PONG-TO-THE-UE1"),
            "pong_at_ue2": bool(ue2.rx_ip)
            and ue2.rx_ip[0].endswith(b"PONG-TO-THE-UE2"),
            "dl_multiuser": has(enb.events, "dl_multiuser")}, {
        "pushed_at": pushed[0] if pushed else None,
        "dl_multiuser": [e for e in enb.events
                         if e.startswith("dl_multiuser")][:8]}


def sr_bsr(run: ScenarioRun):
    """``tests/test_mac_procs.py::TestSrOverTheAir``: 12 TTIs after
    attach (the standing grants drained by a zero BSR) data with no grant
    -> SR on PUCCH -> DCI 0 -> PUSCH with a BSR and the data."""
    _mme, _nas, enb, ue, air = pair(run)
    drive = run.drive([enb], [ue], air=air, watch={
        "attach": up(ue), "sr_tx": logged(lambda: ue.events, "sr_tx"),
        "sr_detected": logged(lambda: enb.events, "sr_detected")})
    st = {"at": None, "cleared": None}

    def until(tti):
        if st["at"] is None and ue.rrc.nas.attached and ue.rrc.drbs:
            st["at"] = tti
        if st["at"] is not None and tti == st["at"] + 12:
            st["cleared"] = not any(s.get("want_ul")
                                    for s in enb.active_ues.values())
            ue.send_ip(b"\x45\x00" + bytes(18) + b"DATA-AFTER-IDLE")
        return bool(enb.ul_gtpu)

    drive.run(120, until)
    return {"attached": st["at"] is not None,
            "standing_grant_cleared": st["cleared"] is True,
            "ul_data_after_sr": bool(enb.ul_gtpu),
            "sr_tx": has(ue.events, "sr_tx"),
            "sr_detected": has(enb.events, "sr_detected")}, {}


def periodic_cqi(run: ScenarioRun):
    """``tests/test_mac_procs.py::TestPeriodicCqi``: wideband CQI on
    PUCCH format 2 raises the DL MCS (CQI >= 12 on the ideal air), and a
    pong rides the adapted MCS."""
    mme, _nas, enb, ue, air = pair(run)
    drive = run.drive([enb], [ue], air=air, watch={
        "attach": up(ue), "cqi_rx": logged(lambda: enb.events, "cqi_rx")})
    st = {"at": None, "pushed": False}

    def until(tti):
        if st["at"] is None and ue.rrc.nas.attached and ue.rrc.drbs:
            st["at"] = tti
        got_cqi = any("cqi" in s for s in enb.active_ues.values())
        if st["at"] is not None and got_cqi and not st["pushed"]:
            st["pushed"] = True
            fwd = mme.spgw.downlink(pong(ue.rrc.nas.ue_ip,
                                         b"ADAPTED-MCS-DATA"))
            enb.deliver_gtpu(fwd[1])
        return st["pushed"] and bool(ue.rx_ip)

    drive.run(120, until)
    cqis = [s["cqi"] for s in enb.active_ues.values() if "cqi" in s]
    return {"attached": st["at"] is not None,
            "cqi_tx": has(ue.events, "cqi_tx"),
            "cqi_rx": has(enb.events, "cqi_rx"),
            "cqi_at_least_12": bool(cqis) and max(cqis) >= 12,
            "pong_at_adapted_mcs": bool(ue.rx_ip)
            and ue.rx_ip[0].endswith(b"ADAPTED-MCS-DATA")}, {"cqi": cqis}


def dl_harq(run: ScenarioRun):
    """``tests/test_mac_procs.py::TestDlHarqOverTheAir``: the pong's first
    transmission through a -12 dB subframe; the UE NACKs, the eNB sends
    the next rv, the UE combines it with its softbuffer and delivers the
    packet once."""
    mme, _nas, enb, ue, air = pair(run)
    drive = run.drive([enb], [ue], air=air, watch={
        "attach": up(ue), "harq_nack": lambda: has(ue.events, "harq_nack")
        or has(enb.events, "harq_nack"),
        "harq_retx": logged(lambda: enb.events, "harq_retx"),
        "delivered": lambda: bool(ue.rx_ip)})
    st = {"at": None, "sent_at": None}

    def before(tti):
        air.snr_db = -12.0 if tti == st["sent_at"] else None

    def until(tti):
        if st["at"] is None and ue.rrc.nas.attached and ue.rrc.drbs:
            st["at"] = tti
        if (st["at"] is not None and tti == st["at"] + 14
                and st["sent_at"] is None):
            fwd = mme.spgw.downlink(pong(ue.rrc.nas.ue_ip,
                                         b"HARQ-COMBINED!!!"))
            enb.deliver_gtpu(fwd[1])
            st["sent_at"] = tti + 1
        return st["sent_at"] is not None and bool(ue.rx_ip)

    drive.run(140, until, before)
    return {"attached": st["at"] is not None,
            "harq_retx": has(enb.events, "harq_retx"),
            "harq_nack": has(ue.events, "harq_nack")
            or has(enb.events, "harq_nack"),
            "delivered": bool(ue.rx_ip)
            and ue.rx_ip[0].endswith(b"HARQ-COMBINED!!!"),
            "delivered_once": len(ue.rx_ip) == 1,
            "harq_ack": has(enb.events, "harq_ack_")}, {
        "faded_tti": st["sent_at"]}


def ul_harq(run: ScenarioRun):
    """``tests/test_mac_procs.py::TestUlHarqOverTheAir``: the PUSCH that
    carries the ping arrives in a -12 dB subframe; the eNB's CRC fails, a
    PHICH NACK, the UE's rv retransmission at n+8 combines and the ping
    reaches the gateway exactly once."""
    from ..upper.gtpu import gtpu_unpack

    _mme, _nas, enb, ue, air = pair(run)
    drive = run.drive([enb], [ue], air=air, watch={
        "attach": up(ue),
        "pusch_crc_fail": logged(lambda: enb.events, "pusch_crc_fail"),
        "phich_nack": logged(lambda: ue.events, "phich_nack"),
        "delivered": lambda: bool(enb.ul_gtpu)})
    st = {"at": None, "fade_at": None, "pre": set()}

    def before(tti):
        air.snr_db = -12.0 if tti == st["fade_at"] else None

    def until(tti):
        if st["at"] is None and ue.rrc.nas.attached and ue.rrc.drbs:
            st["at"] = tti
            st["pre"] = set(ue.pusch_plan)
            ue.send_ip(b"\x45\x00" + bytes(18) + b"UL-HARQ-PAYLOAD")
        if st["at"] is not None and st["fade_at"] is None:
            # the first PUSCH planned after the ping was queued carries
            # it: fade the subframe in which the eNB receives it
            new = set(ue.pusch_plan) - st["pre"]
            if new:
                st["fade_at"] = min(new) + 1
        return bool(enb.ul_gtpu) and has(ue.events, "phich_nack")

    drive.run(160, until, before)
    payloads = [gtpu_unpack(p)[1][-15:] for p in enb.ul_gtpu]
    return {"attached_and_faded": st["at"] is not None
            and st["fade_at"] is not None,
            "pusch_crc_fail": has(enb.events, "pusch_crc_fail"),
            "phich_nack": has(ue.events, "phich_nack"),
            "phich_ack": has(ue.events, "phich_ack"),
            "delivered_once": payloads.count(b"UL-HARQ-PAYLOAD") == 1}, {
        "faded_tti": st["fade_at"]}


def srb1_rlc_am(run: ScenarioRun):
    """``tests/test_stack.py::TestSrb1RlcAm``: a UE capability enquiry
    queued 10 TTIs after attach, then a 30-TTI blackout at -20 dB that DL
    HARQ cannot bridge; RLC AM's poll/status recovers it."""
    _mme, _nas, enb, ue, air = pair(run)
    drive = run.drive([enb], [ue], air=air, watch={
        "attach": up(ue),
        "capability_sent": lambda: "capability_sent" in ue.rrc.events,
        "ue_cat": logged(lambda: enb.rrc.events, "ue_cat")})
    st = {"at": None, "sent_at": None}

    def before(tti):
        s = st["sent_at"]
        air.snr_db = -20.0 if s is not None and s <= tti < s + 30 else None

    def until(tti):
        if st["at"] is None and ue.rrc.nas.attached and ue.rrc.drbs:
            st["at"] = tti
        if (st["at"] is not None and st["sent_at"] is None
                and tti == st["at"] + 10):
            enb.send_dl(*enb.rrc.send_capability_enquiry(ue.c_rnti))
            st["sent_at"] = tti + 1
        return st["sent_at"] is not None and has(enb.rrc.events, "ue_cat")

    drive.run(220, until, before)
    return {"attached_and_sent": st["at"] is not None
            and st["sent_at"] is not None,
            "lost_at_the_mac": has(enb.events, "ul_harq_max_retx")
            or has(enb.events, "harq_nack"),
            "capability_sent": "capability_sent" in ue.rrc.events,
            "ue_cat": has(enb.rrc.events, "ue_cat")}, {
        "blackout_from": st["sent_at"]}


def rlf(run: ScenarioRun):
    """``tests/test_stack.py::TestRadioLinkFailure``: from 5 TTIs after
    attach the PUSCH is faded (-12 dB uplink; SR still lands, so grants
    keep flowing) until SRB1's AM retransmissions run out (max 2): RLF,
    then re-establishment over random access on a fresh C-RNTI, NAS
    still attached."""
    _mme, _nas, enb, ue, air = pair(
        run, ue_kw=dict(srb1_max_retx=2, srb1_poll_retx=8))
    drive = run.drive([enb], [ue], air=air, watch={
        "attach": up(ue), "rlf_max_retx": lambda: "rlf_max_retx" in ue.events,
        "reestablished": logged(lambda: ue.rrc.events, "reestablished_ncc")})
    st = {"at": None, "fade_from": None, "rlf_at": None, "reest_at": None}

    def before(tti):
        air.snr_db_ul = (-12.0 if st["fade_from"] is not None
                         and st["rlf_at"] is None else None)

    def until(tti):
        if st["at"] is None and ue.rrc.nas.attached and ue.rrc.drbs:
            st["at"] = tti
        if (st["at"] is not None and st["fade_from"] is None
                and tti == st["at"] + 5):
            # UE-originated SRB1 traffic that will never be ACKed
            _srb, mr = ue.rrc.send_measurement_report(50, 20, [])
            ue.srb1_rlc.write_sdu(mr)
            st["fade_from"] = tti
        if st["rlf_at"] is None and "rlf_max_retx" in ue.events:
            st["rlf_at"] = tti
        if st["rlf_at"] is not None and has(ue.rrc.events,
                                            "reestablished_ncc"):
            st["reest_at"] = tti
            return True
        return False

    drive.run(500, until, before)
    return {"attached": st["at"] is not None,
            "rlf_declared": st["rlf_at"] is not None,
            "reestablishment_ok": "reestablishment_ok" in enb.rrc.events,
            "reestablished": st["reest_at"] is not None,
            "one_context": len(enb.rrc.ues) == 1,
            "context_on_new_c_rnti": ue.c_rnti in enb.rrc.ues,
            "nas_attached": ue.rrc.nas.attached}, {
        "fade_from": st["fade_from"]}


def paging(run: ScenarioRun):
    """``tests/test_idle_paging.py``: released 10 TTIs after attach, paged
    (paging cycle 8) 25 TTIs later, back through a Service Request on the
    same IP and MME context, and a pong over the modified bearer."""
    mme, nas, enb, ue, air = pair(run, enb_kw=dict(paging_cycle=8))
    drive = run.drive([enb], [ue], air=air, watch={
        "attach": up(ue), "went_idle": lambda: "went_idle" in ue.events,
        "paged": lambda: "paged" in ue.events})
    st = {"at": None, "released_at": None, "paged_at": None, "ip": None,
          "reconnected_at": None}

    def until(tti):
        if st["at"] is None and ue.rrc.nas.attached and ue.rrc.drbs:
            st["at"], st["ip"] = tti, ue.rrc.nas.ue_ip
        if (st["at"] is not None and st["released_at"] is None
                and tti == st["at"] + 10):
            enb.release_ue(ue.c_rnti)
            st["released_at"] = tti
        if (st["released_at"] is not None and st["paged_at"] is None
                and ue.state == "idle" and tti >= st["released_at"] + 25):
            enb.page(nas.imsi, m_tmsi=nas.guti.m_tmsi)
            st["paged_at"] = tti
        if (st["paged_at"] is not None and ue.rrc.drbs
                and ue.state == "connected"):
            st["reconnected_at"] = tti
            return True
        return False

    drive.run(260, until)
    ctx = mme.context(nas.imsi)
    checks = {"attached_and_released": st["at"] is not None
              and st["released_at"] is not None,
              "went_idle": "went_idle" in ue.events,
              "page_sent": st["paged_at"] is not None,
              "paged": "paged" in ue.events,
              "reconnected": ue.state == "connected" and bool(ue.rrc.drbs),
              "same_ip": nas.attached and nas.ue_ip == st["ip"],
              "one_mme_context": ctx is not None and ctx.state == "attached"
              and ctx.ue_ip == st["ip"]}
    if st["ip"] is not None:
        checks.update(run_pong(drive, mme, enb, ue, st["ip"],
                               b"PAGED-AND-ALIVE!"))
    else:
        checks["pong_at_ue"] = False
    return checks, {k: st[k] for k in ("released_at", "paged_at",
                                       "reconnected_at")}


def periodic_tau(run: ScenarioRun):
    """``tests/test_tau_ota.py::TestPeriodicTau``: T3412 (scaled by 3e-6)
    expires in idle, the UE wakes for a TAU that reallocates its GUTI, is
    released again and paged with the new M-TMSI; the bearer still
    carries a pong."""
    mme, nas, enb, ue, air = pair(run, enb_kw=dict(paging_cycle=8))
    nas.t3412_scale = 3e-6
    drive = run.drive([enb], [ue], air=air, watch={
        "attach": up(ue),
        "t3412_expired": lambda: "t3412_expired" in nas.events,
        "tau_ra": lambda: "tau_ra" in ue.events,
        "tau_accept": lambda: "tau_accept" in nas.events,
        "paged": lambda: "paged" in ue.events})
    st = dict(at=None, released_at=None, guti=None, ip=None, tau_done_at=None,
              re_released_at=None, paged_at=None, armed=None, rearmed=False)

    def until(tti):
        if st["at"] is None and nas.attached and ue.rrc.drbs:
            st["at"], st["guti"], st["ip"] = tti, nas.guti, nas.ue_ip
            st["armed"] = nas.t3412_ms > 0
        if (st["at"] is not None and st["released_at"] is None
                and tti == st["at"] + 6):
            enb.release_ue(ue.c_rnti)
            st["released_at"] = tti
        if (st["tau_done_at"] is None and "tau_accept" in nas.events
                and nas.state == "attached" and ue.state == "connected"):
            st["tau_done_at"] = tti
            st["rearmed"] = nas.t3412_ms > 0
            # the next (scaled) expiry past the horizon: the paged
            # reconnect below is a plain service request
            nas.t3412_ms = 10 ** 9
        if (st["tau_done_at"] is not None and st["re_released_at"] is None
                and mme.context(nas.imsi).state == "attached"):
            enb.release_ue(ue.c_rnti)
            st["re_released_at"] = tti
        if (st["re_released_at"] is not None and st["paged_at"] is None
                and ue.state == "idle" and tti >= st["re_released_at"] + 20):
            enb.page(nas.imsi, m_tmsi=nas.guti.m_tmsi)
            st["paged_at"] = tti
        return (st["paged_at"] is not None and ue.state == "connected"
                and bool(ue.rrc.drbs))

    drive.run(420, until)
    ctx = mme.context(nas.imsi)
    checks = {"attached_and_released": st["at"] is not None
              and st["released_at"] is not None,
              "t3412_armed": st["armed"] is True,
              "t3412_expired": "t3412_expired" in nas.events,
              "tau_ra": "tau_ra" in ue.events,
              "tau_done": st["tau_done_at"] is not None,
              "guti_reallocated": nas.guti is not None
              and nas.guti != st["guti"],
              "t3412_rearmed": st["rearmed"],
              "mme_context_attached": ctx is not None
              and ctx.state == "attached",
              "page_sent": st["paged_at"] is not None,
              "reconnected_same_ip": ue.state == "connected"
              and nas.ue_ip == st["ip"]}
    if st["ip"] is not None:
        checks.update(run_pong(drive, mme, enb, ue, st["ip"],
                               b"ALIVE-AFTER-TAU!"))
    else:
        checks["pong_at_ue"] = False
    return checks, {k: st[k] for k in ("released_at", "tau_done_at",
                                       "re_released_at", "paged_at")}


def tac_change_arms_tau(run: ScenarioRun):
    """``tests/test_tau_ota.py::TestTauOnTacChange::test_camp_outside_
    tai_list_arms_tau``: camping on TAC 9 outside the registered TAI list
    arms a TAU (24.301 5.5.3.2.2); the same TA listed does not (no
    air)."""
    from ..apps import lte_attach
    from ..epc.mme import PLMN
    from ..stack import UeStack
    from ..utils.cell import Cell

    mme, nas = lte_attach.epc()
    mme.extra_tacs = [9]
    ue = UeStack(Cell(nof_prb=NOF_PRB, id=1), nas, device=run.device)
    nas.attached, nas.state, nas.tai_list = True, "attached", [(PLMN, 7)]
    ue.access_info = {"tac": 9, "plmns": [PLMN], "barred": False,
                      "q_rx_lev_min_db": -130}
    ue._check_tac_tau()
    armed = nas.pending_tau
    event = has(ue.events, "tau_on_tac_change_9")
    nas.pending_tau = False
    nas.tai_list = [(PLMN, 7), (PLMN, 9)]
    ue._check_tac_tau()
    return {"tac_change_arms_tau": armed, "tau_on_tac_change_9": event,
            "listed_tac_no_tau": not nas.pending_tau}, {}


def tau_accept_lists_every_tac(run: ScenarioRun):
    """``tests/test_tau_ota.py::TestTauOnTacChange::test_tau_accept_
    updates_tai_list``: an attach accept's TAI list holds every TAC the
    MME serves (NAS only, no air)."""
    from ..apps import lte_attach
    from ..epc.mme import PLMN, TAC

    mme, nas = lte_attach.epc()
    mme.extra_tacs = [9]
    pdu = nas.attach_request()
    while pdu is not None:
        down = mme.handle_ul_nas(pdu, enb_teid=0x10)
        if down is None:
            break
        pdu = nas.handle_dl_nas(down)
    return {"attached": nas.attached,
            "accept_lists_every_tac": (PLMN, TAC) in nas.tai_list
            and (PLMN, 9) in nas.tai_list}, {}


def handover(run: ScenarioRun):
    """``tests/test_handover_ota.py``: source PCI 1 (S1AP to the MME) and
    target PCI 2 on one channel, the UE hearing them at gains 1.0 / 0.1;
    15 TTIs after attach the gains become 0.5 / 1.3, the UE's A3 report
    drives an S1 handover, the target admits it with a dedicated preamble
    and verifies its reconfiguration complete under the new keys."""
    from ..apps import lte_attach
    from ..s1ap.procedures import EnbS1ap, EnbS1apTarget, MmeS1ap
    from ..stack import EnbStack, UeStack
    from ..utils.cell import Cell

    mme, nas = lte_attach.epc()
    mme_s1 = MmeS1ap(mme=mme)
    src_s1 = EnbS1ap(send=mme_s1.handle, enb_id=0x19B)
    src = EnbStack(Cell(nof_prb=NOF_PRB, id=1), src_s1, rsi=128,
                   device=run.device)
    src.rrc.pci = 1
    src.rrc.neighbor_enbs = {2: 0x2AA}
    tgt = EnbStack(Cell(nof_prb=NOF_PRB, id=2), mme, rsi=384,
                   device=run.device)
    tgt.rrc.pci = 2
    tgt.rrc.next_c_rnti = 0x60
    tgt_s1 = EnbS1apTarget(prepare=tgt.admit_handover)
    mme_s1.attach_enb_link(0x19B, lambda pdu: (src_s1.deliver(pdu), [])[1])
    mme_s1.attach_enb_link(0x2AA, tgt_s1.handle)
    ue = UeStack(Cell(nof_prb=NOF_PRB, id=1), nas, rsi=128,
                 neighbor_pcis=(2,), device=run.device)
    drive = run.drive([src, tgt], [ue], gains=[1.0, 0.1], watch={
        "attach": up(ue), "meas_report_2": logged(lambda: ue.events,
                                                  "meas_report_2"),
        "ho_exec_pci2": logged(lambda: ue.events, "ho_exec_pci2"),
        "ho_ra_complete": lambda: "ho_ra_complete" in ue.events,
        "handover_complete": lambda: "reconfig_complete" in tgt.rrc.events})
    st = {"at": None, "flipped_at": None}

    def until(tti):
        if st["at"] is None and ue.rrc.nas.attached and ue.rrc.drbs:
            st["at"] = tti
        if (st["at"] is not None and st["flipped_at"] is None
                and tti == st["at"] + 15):
            # the UE moves: the neighbour becomes ~8 dB stronger
            drive.gains[:] = [0.5, 1.3]
            st["flipped_at"] = tti
        return (st["flipped_at"] is not None
                and "reconfig_complete" in tgt.rrc.events)

    drive.run(260, until)
    return {"attached_and_moved": st["at"] is not None
            and st["flipped_at"] is not None,
            "meas_report_2": has(ue.events, "meas_report_2"),
            "handover_to_2": has(ue.rrc.events, "handover_to_2"),
            "ho_exec_pci2": has(ue.events, "ho_exec_pci2"),
            "ho_ra_complete": "ho_ra_complete" in ue.events,
            "s1_handover_cmd": "s1_handover_cmd" in src.rrc.events,
            "ho_admitted": has(tgt.rrc.events, "ho_admitted"),
            "reconfig_complete": "reconfig_complete" in tgt.rrc.events,
            "serving_pci2": ue.cell.id == 2 and ue.rrc.serving_pci == 2,
            "context_at_target": ue.c_rnti in tgt.rrc.ues
            and tgt.rrc.ues[ue.c_rnti]["state"] == "reconfigured"}, {
        "moved_at": st["flipped_at"]}


def reselect(run: ScenarioRun):
    """``tests/test_idle_reselect.py::TestIdleReselection``: two
    broadcasting eNBs (A: PCI 1 with SIB3/SIB4 naming PCI 2; B: PCI 2, root
    384) at gains 1.0 / 0.05; a cold-start UE camps on A, attaches, is
    released, and once it holds SIB3 and SIB4 the gains become 0.05 /
    1.2: it reselects to B (PBCH and SIBs again), camps, sends data from
    idle and comes back through B with a Service Request; then a pong
    through B."""
    from ..apps import lte_attach
    from ..stack import EnbStack, UeStack
    from ..utils.cell import Cell

    mme, nas = lte_attach.epc()
    enb_a = EnbStack(Cell(nof_prb=NOF_PRB, id=1), mme, rsi=128,
                     broadcast=True, device=run.device)
    enb_a.enable_mobility_si(neighbor_pcis=(2,), q_hyst_db=2,
                             s_intra_search=None, t_resel_s=0)
    enb_b = EnbStack(Cell(nof_prb=NOF_PRB, id=2), mme, rsi=384,
                     broadcast=True, device=run.device)
    ue = UeStack(Cell(nof_prb=NOF_PRB, id=1), nas, rsi=128, cold_start=True,
                 device=run.device)
    drive = run.drive([enb_a, enb_b], [ue], gains=[1.0, 0.05], watch={
        "camped": lambda: "camped" in ue.events, "attach": up(ue),
        "went_idle": lambda: "went_idle" in ue.events,
        "reselect_pci2": lambda: "reselect_pci2" in ue.events,
        "mo_data_ra": lambda: "mo_data_ra" in ue.events})
    st = dict(at=None, released_at=None, flipped_at=None, ip=None,
              reselected_at=None, recamped_at=None, back_at=None)

    def until(tti):
        if st["at"] is None and ue.rrc.nas.attached and ue.rrc.drbs:
            st["at"], st["ip"] = tti, ue.rrc.nas.ue_ip
        if (st["at"] is not None and st["released_at"] is None
                and tti == st["at"] + 10):
            enb_a.release_ue(ue.c_rnti)
            st["released_at"] = tti
        if (st["released_at"] is not None and st["flipped_at"] is None
                and ue.state == "idle" and "sib3_acquired" in ue.events
                and "sib4_acquired" in ue.events):
            drive.gains[:] = [0.05, 1.2]
            st["flipped_at"] = tti
        if st["reselected_at"] is None and "reselect_pci2" in ue.events:
            st["reselected_at"] = tti
        if (st["reselected_at"] is not None and st["recamped_at"] is None
                and ue.state == "idle" and ue.cell.id == 2):
            st["recamped_at"] = tti
            # MO data in idle: a Service Request at the new cell
            ue.send_ip(b"\x45" + bytes(19) + b"HELLO-FROM-CELL-B")
        if (st["recamped_at"] is not None and ue.state == "connected"
                and ue.rrc.drbs and ue.c_rnti in enb_b.rrc.ues):
            st["back_at"] = tti
            return True
        return False

    drive.run(700, until)
    ctx = mme.context(nas.imsi)
    checks = {"attached_and_released": st["at"] is not None
              and st["released_at"] is not None,
              "faded_after_sib3_sib4": st["flipped_at"] is not None,
              "reselected": st["reselected_at"] is not None,
              "recamped": st["recamped_at"] is not None,
              "on_b_with_its_root": ue.cell.id == 2 and ue.rsi == 384,
              "mo_data_ra": "mo_data_ra" in ue.events,
              "connected_at_b": ue.state == "connected"
              and ue.c_rnti in enb_b.rrc.ues,
              "same_registration": nas.attached and nas.ue_ip == st["ip"],
              "mme_context_attached": ctx is not None
              and ctx.state == "attached"}
    if st["ip"] is not None:
        checks.update(run_pong(drive, mme, enb_b, ue, st["ip"],
                               b"BACK-VIA-CELL-B!"))
    else:
        checks["pong_at_ue"] = False
    return checks, {k: st[k] for k in ("released_at", "flipped_at",
                                       "recamped_at", "back_at")}


def s_criterion(run: ScenarioRun):
    """``tests/test_idle_reselect.py::test_s_criterion_rejects_weak_cell``:
    SIB1's Qrxlevmin -48 dB, the cell at -50 dB: 36.304 5.2.3.2 fails and
    the cell is never camped on."""
    from ..apps import lte_attach
    from ..rrc import messages as M
    from ..stack import EnbStack, UeStack
    from ..stack import si as si_mod
    from ..utils.cell import Cell

    mme, nas = lte_attach.epc()
    cell = Cell(nof_prb=NOF_PRB, id=1)
    enb = EnbStack(cell, mme, rsi=128, broadcast=True, device=run.device)
    s = M.unpack_bcch_dlsch(si_mod.build_sib1(cell))[1]
    s["cell_selection_info"]["q_rx_lev_min"] = -24
    enb.sib_payloads[0] = M.pack_bcch_dlsch("systemInformationBlockType1", s)
    ue = UeStack(cell, nas, rsi=128, cold_start=True, device=run.device)
    drive = run.drive([enb], [ue], gains=[10 ** (-50 / 20)], watch={
        "s_criterion_fail": lambda: "s_criterion_fail_id1" in ue.events})
    drive.run(120, lambda tti: "s_criterion_fail_id1" in ue.events)
    return {"s_criterion_fail_id1": "s_criterion_fail_id1" in ue.events,
            "not_camped": "camped" not in ue.events,
            "still_searching": ue.state == "search"}, {}


def plmn_mismatch(run: ScenarioRun):
    """``tests/test_idle_reselect.py::test_plmn_mismatch_rejects_cell``: a
    cell broadcasting only PLMN 999-99 is rejected during selection."""
    from ..apps import lte_attach
    from ..mac.bcch import SibConfig
    from ..stack import EnbStack, UeStack
    from ..stack import si as si_mod
    from ..utils.cell import Cell

    mme, nas = lte_attach.epc()
    cell = Cell(nof_prb=NOF_PRB, id=1)
    enb = EnbStack(cell, mme, rsi=128, broadcast=True, device=run.device)
    sib1 = si_mod.build_sib1(cell, mcc=(9, 9, 9), mnc=(9, 9))
    enb.sib_payloads[0] = sib1
    enb.sib_sched.sibs[0] = SibConfig(payload_len=len(sib1), period_rf=8)
    ue = UeStack(cell, nas, rsi=128, cold_start=True, device=run.device)
    drive = run.drive([enb], [ue], watch={
        "plmn_reject": lambda: "plmn_reject_id1" in ue.events})
    drive.run(120, lambda tti: "plmn_reject_id1" in ue.events)
    return {"plmn_reject_id1": "plmn_reject_id1" in ue.events,
            "found_plmn_99999": bool(ue.found_plmns)
            and ue.found_plmns[0][0] == "99999",
            "not_camped": "camped" not in ue.events}, {}


def notch(x):
    """``tests/test_csi_feedback.py``'s two-tap echo (0.72 at 2 samples):
    on a 25-PRB cell it notches subbands 0 and 5/6 of seven."""
    y = np.asarray(x, np.complex64).copy()
    y[2:] += 0.72 * y[:-2]
    return y


def subband_cqi(run: ScenarioRun):
    """``tests/test_csi_feedback.py::test_subband_report_steers_
    allocation``: the UE's aperiodic subband CQI on PUSCH shows the notch
    of ``notch``, and every frequency-selective allocation lands in a
    window at or above the band's mean CQI."""
    from ..models import uci as uci_mod

    mme, _nas, enb, ue, air = pair(run, enb_kw=dict(aperiodic_cqi=True))
    drive = run.drive([enb], [ue], air=air, dl_filter=notch, watch={
        "attach": up(ue), "sbcqi_rx": logged(lambda: enb.events, "sbcqi_rx"),
        "fsel_alloc": logged(lambda: enb.events, "fsel_alloc")})
    st = {"at": None, "sb": None, "fwd": None, "fsel_at": None,
          "delivered": False}

    def until(tti):
        if st["at"] is None and ue.rrc.nas.attached and ue.rrc.drbs:
            st["at"] = tti
            # UL grants carry the CSI request; DL data exercises the
            # selective allocator
            ue.send_ip(b"\x45" + bytes(19) + b"UPLINK")
        s = enb.active_ues.get(ue.c_rnti) or {}
        if st["at"] is not None and st["sb"] is None and "sb_cqi" in s:
            st["sb"] = list(s["sb_cqi"])
            fwd = mme.spgw.downlink(pong(ue.rrc.nas.ue_ip,
                                         b"DOWNLINK-DATA-TO-STEER" * 3))
            st["fwd"] = fwd is not None
            if fwd is not None:
                enb.deliver_gtpu(fwd[1])
        if st["fsel_at"] is None and has(enb.events, "fsel_alloc"):
            st["fsel_at"] = tti
        if st["fsel_at"] is not None and ue.rx_ip:
            st["delivered"] = True
            return True
        return False

    drive.run(420, until)
    sb = st["sb"] or [0] * 7
    k = uci_mod.cqi_hl_subband_size(NOF_PRB)
    per_prb = [sb[min(i // k, len(sb) - 1)] for i in range(NOF_PRB)]
    band_mean = sum(per_prb) / len(per_prb)
    starts = [int(e.split("_prb")[1].split("_")[0])
              for e in enb.events if e.startswith("fsel_alloc")]
    return {"attached": st["at"] is not None,
            "subband_report": st["sb"] is not None,
            "pong_forwarded": st["fwd"] is True,
            "sbcqi_tx": has(ue.events, "sbcqi_tx"),
            "sbcqi_rx": has(enb.events, "sbcqi_rx"),
            "notch_low_sb0": sb[0] < max(sb[2:5]),
            "notch_low_sb56": min(sb[5:7]) < max(sb[2:5]),
            "fsel_alloc": st["fsel_at"] is not None,
            "windows_above_band_mean": all(
                sum(per_prb[s:s + 4]) / len(per_prb[s:s + 4]) >= band_mean
                for s in starts),
            "delivered": st["delivered"]}, {
        "sb_cqi": st["sb"], "fsel_starts": starts[:16]}


def periodic_ri(run: ScenarioRun):
    """``tests/test_csi_feedback.py::test_periodic_ri_reported``: the RI
    occasion (every 4th CQI occasion, I_ri 322) carries rank 1, stored
    per UE; CQI reports go on between."""
    _mme, _nas, enb, ue, air = pair(run)
    drive = run.drive([enb], [ue], air=air, watch={
        "attach": up(ue), "ri_tx1": logged(lambda: ue.events, "ri_tx1")})

    def until(tti):
        s = enb.active_ues.get(ue.c_rnti) or {}
        return "ri" in s and has(enb.events, "cqi_rx")

    drive.run(200, until)
    s = enb.active_ues.get(ue.c_rnti) or {}
    return {"ri_configured": "ri_configured" in ue.rrc.events,
            "ri_tx1": has(ue.events, "ri_tx1"),
            "ri_stored_1": s.get("ri") == 1,
            "cqi_rx": has(enb.events, "cqi_rx")}, {}


#: the card's stack phases, each its scenarios in the order they run
PHASES = {
    "stack_multi_ue": (two_ues_ping, two_ues_dl),
    "stack_mac_harq": (sr_bsr, periodic_cqi, dl_harq, ul_harq, srb1_rlc_am,
                       rlf),
    "stack_idle": (paging, periodic_tau, tac_change_arms_tau,
                   tau_accept_lists_every_tac),
    "stack_mobility": (handover, reselect, s_criterion, plmn_mismatch),
    "stack_csi": (subband_cqi, periodic_ri),
}
