"""eNB node: PRACH detection, RAR, MAC mux, RRC, per-TTI DL composition.

The port's counterpart of the JAX package's ``stack/enb.py``: every
protocol line is the same; the PHY runs on the port's torch modules on
the stack's device (the CUDA card unless ``device="cpu"``). The air stays
numpy, as an RF driver's buffers are host memory: ``tti()`` takes the UL
subframe and returns the DL subframe as numpy IQ.

Capability parity with the srsenb integration (txrx.cc TTI loop +
phch_worker + mac.cc + rrc.cc): each tti() consumes one UL IQ subframe
and produces one DL IQ subframe. Timing model: an uplink grant issued in
subframe n is transmitted by the UE in n+4 (HARQ_DELAY_MS, common.h:49);
the RAR UL grant defaults to the same +4 rule but is configurable via
``msg3_delay`` on both stacks — set 6 for the spec's n+6 (36.213 6.1.1)
so recorded UL timelines match the reference's.

Multi-UE: per-RNTI DRB PDCP/RLC entities (the reference keeps per-user
arrays in srsenb/src/upper/{pdcp,rlc}.cc), per-UE PUCCH resources from
PhysicalConfigDedicated, per-UE PUSCH PRB slices, HARQ-ACK resources
derived from the DL grant's first CCE (36.213 10.1).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..mac.pdu import (LCID_LONG_BSR, LCID_PHR, LCID_SHORT_BSR,
                       LCID_TRUNC_BSR, MacPdu, pack_rar_pdu, unpack_pdu)
from ..mac.procs import BSR_TABLE
from ..models import dci as dci_mod
from ..models import ra
from ..models.enb_dl import (enb_dl_base_grid, enb_dl_gen_signal,
                             put_sync_signals)
from ..models.pcfich import pcfich_put
from ..models.pdcch import pdcch_encode
from ..models.pdsch import PdschConfig, pdsch_encode
from ..models.prach import prach_detect, prach_seq_len
from ..models.pusch import PuschConfig, pusch_decode, pusch_decode_jit
from ..rrc.procedures import EnbRrc
from ..upper.gtpu import gtpu_pack, gtpu_unpack
from ..upper.pdcp import PdcpConfig, PdcpEntity
from ..upper.rlc import RlcAm, RlcUm
from ..utils.cell import Cell
from ..utils.device import resolve_device
from .params import (MSG3_MCS, MSG3_PRB, N1_PUCCH, PRACH_FREQ_OFFSET,
                     PRACH_SF, PRACH_ZCZ, PUCCH_N_RB_2, UL_GRANT_N_PRB,
                     UL_GRANT_PRB0)

UL_MCS = 4
DL_MCS = 5
SR_DETECT_THRESHOLD = 1.0   # coherent PUCCH f1 energy (|h|~1 -> ~8)
SR_SUBFRAME = 0             # default SR occasion when RRC did not assign
CQI_SUBFRAME = 4            # default CQI occasion
CQI_DETECT_THRESHOLD = 0.2  # coherent PUCCH f2 DMRS energy (|h|~1 -> 2)
ACK_DETECT_THRESHOLD = 1.0  # DTX vs ACK/NACK energy decision


def _dl_grant_for(nof_prb: int, payload_len: int, mcs: int = DL_MCS):
    """Smallest contiguous allocation whose TBS fits payload_len bytes."""
    for n in range(2, nof_prb + 1):
        mod, tbs = ra.mcs_to_tbs(mcs, n)
        if tbs >= 8 * payload_len:
            return n, mod, tbs
    raise ValueError(f"payload {payload_len}B exceeds cell capacity")


def _common_grant_for(payload_len: int):
    """(mcs, n_prb_1a, tpc, mod, tbs) for a common-search-space 1A grant:
    the TBS column is N_prb_1A in {2, 3} selected by the TPC LSB
    (36.212 5.3.3.1.3), independent of the RIV allocation."""
    for n1a, tpc in ((2, 0), (3, 1)):
        for mcs in range(10):              # QPSK I_MCS range
            mod, tbs = ra.mcs_to_tbs(mcs, n1a)
            if tbs >= 8 * payload_len:
                return mcs, n1a, tpc, mod, tbs
    raise ValueError(f"SI/RAR payload {payload_len}B exceeds 1A capacity")


@dataclass
class _PendingUl:
    rnti: int
    cfg: object
    tbs: int
    rv: int = 0
    n_tx: int = 1
    softbuffers: object = None    # carried across HARQ retransmissions
    cqi_req: bool = False         # aperiodic hl-subband CQI requested


P_RNTI = 0xFFFE
SI_RNTI = 0xFFFF


class EnbStack:
    def __init__(self, cell: Cell, mme, rsi: int = 128,
                 cfi: int = 2, agent=None, paging_cycle: int = 32,
                 broadcast: bool = False, msg3_delay: int = 4,
                 aperiodic_cqi: bool = False, tac: int = 7, device=None):
        #: where the PHY runs (None = the CUDA card; raises without one)
        self.device = resolve_device(device)
        #: request 36.213 7.2.1 aperiodic hl-subband CQI on UL grants
        #: when the stored report is stale, and use it for
        #: frequency-selective DL allocation + per-allocation MCS
        self.aperiodic_cqi = aperiodic_cqi
        self.cell = cell
        self.cfi = cfi
        self.rsi = rsi
        #: RAR-grant to msg3 delay in TTIs (spec n+6, 36.213 6.1.1;
        #: default matches the framework's +4 pipeline delay — must agree
        #: with the UE stack's msg3_delay)
        self.msg3_delay = msg3_delay
        #: optional EmPOWER agent (mac.cc calls process_DL_results per
        #: TTI with the issued grants; mac/agent.py analog)
        self.agent = agent
        self.rrc = EnbRrc(mme=mme)
        self.dl_queues: dict = {}     # rnti -> [(payload, meta)]
        self._rr_next = 0             # round-robin pointer (dl_metric_rr)
        self.ul_pending: dict = {}    # tti -> [_PendingUl]
        self.active_ues: dict = {}    # rnti -> {"want_ul": bool}
        self.events: list = []
        # DRB1 user plane towards the SP-GW, per UE (srsenb upper/
        # {pdcp,rlc}.cc keep per-user bearer arrays)
        self.drbs: dict = {}          # rnti -> {pdcp_rx/tx, rlc_rx/tx}
        self.ul_gtpu: list = []       # GTP-U PDUs towards the core
        # DL HARQ (scheduler_harq.cc): ACKs expected at tti -> list of
        # (rnti, pid, retx_record, n_pucch); retx_record re-encodes the
        # same transport block with the next redundancy version
        self.ack_pending: dict = {}
        # UL HARQ indicators to transmit: tti -> [(group, seq, ack)]
        self.phich_pending: dict = {}
        #: dedicated RA preambles reserved for incoming handovers:
        #: rapid -> pre-allocated C-RNTI (rach_config_dedicated)
        self.dedicated_preambles: dict = {}
        # paging scheduler (36.304 occasions; rrc.cc pending_paging)
        from ..mac.bcch import PagingScheduler

        self.paging = PagingScheduler(t=paging_cycle)
        # system information broadcast (rrc.cc generate_sibs +
        # scheduler.cc dl_sched_bc): MIB on PBCH, SIB1/SIB2 on SI-RNTI
        self.broadcast = broadcast
        self.mbms: dict | None = None
        if broadcast:
            from ..mac.bcch import SibConfig, SibScheduler
            from . import si as si_mod

            self.sib_payloads = [si_mod.build_sib1(cell, tac=tac),
                                 si_mod.build_sib2(rsi)]
            self.sib_sched = SibScheduler(sibs=[
                SibConfig(payload_len=len(self.sib_payloads[0]),
                          period_rf=8),
                SibConfig(payload_len=len(self.sib_payloads[1]),
                          period_rf=16)])

    def _t(self, a) -> torch.Tensor:
        """A host array as a tensor on the stack's device."""
        return torch.as_tensor(np.asarray(a), device=self.device)

    # --- user plane -----------------------------------------------------------

    def _srb1(self, rnti: int) -> RlcAm:
        """Per-UE SRB1 RLC AM entity (the reference's rlc.cc per-user
        bearer array; SRB1/2 are acknowledged mode)."""
        st = self.active_ues.setdefault(rnti, {})
        rlc = st.get("srb1_rlc")
        if rlc is None:
            rlc = st["srb1_rlc"] = RlcAm()
        return rlc

    def _drb(self, rnti: int) -> dict:
        d = self.drbs.get(rnti)
        if d is None:
            d = self.drbs[rnti] = {
                "pdcp_rx": PdcpEntity(PdcpConfig(bearer_id=5)),
                "pdcp_tx": PdcpEntity(PdcpConfig(bearer_id=5)),
                "rlc_rx": RlcUm(), "rlc_tx": RlcUm()}
        return d

    def deliver_gtpu(self, gtpu_pdu: bytes) -> None:
        """Downlink user plane from the SP-GW: unwrap and queue on the
        addressed UE's DRB1. The eNB-side S1-U TEID is the C-RNTI (the
        eNB allocates its own TEIDs, gtpu.cc add_bearer)."""
        teid, ip = gtpu_unpack(gtpu_pdu)
        rnti = teid if teid in self.rrc.ues else \
            next(iter(self.active_ues), 0)
        if not rnti:
            return
        d = self._drb(rnti)
        d["rlc_tx"].write_sdu(d["pdcp_tx"].write_sdu(ip))

    def enable_mobility_si(self, neighbor_pcis: tuple = (),
                           q_hyst_db: int = 2, q_rx_lev_min: int = -65,
                           s_intra_search: int | None = 31,
                           t_resel_s: int = 0,
                           q_offset_db: int = 0) -> None:
        """Broadcast SIB3 (+SIB4 when neighbours are given): the 36.304
        idle-mode reselection parameters and intra-frequency neighbour
        list (srsenb generate_sibs packs sib3/sib4 from sib.conf the same
        way; srsue rrc.cc:938-1000 applies them)."""
        if not self.broadcast:
            return
        from ..mac.bcch import SibConfig
        from . import si as si_mod

        sib3 = si_mod.build_sib3(q_hyst_db=q_hyst_db,
                                 q_rx_lev_min=q_rx_lev_min,
                                 s_intra_search=s_intra_search,
                                 t_resel_s=t_resel_s)
        self.sib_payloads.append(sib3)
        self.sib_sched.sibs.append(
            SibConfig(payload_len=len(sib3), period_rf=8))
        if neighbor_pcis:
            sib4 = si_mod.build_sib4(tuple(neighbor_pcis),
                                     q_offset_db=q_offset_db)
            self.sib_payloads.append(sib4)
            self.sib_sched.sibs.append(
                SibConfig(payload_len=len(sib4), period_rf=8))
        self.events.append("mobility_si_enabled")

    def enable_mbms(self, area_id: int = 1, data_mcs: int = 9) -> None:
        """Start eMBMS on this cell: SIB13 joins the broadcast schedule,
        subframe 3 of every frame becomes an MBSFN subframe carrying
        MCCH (at its occasions) or MTCH data from the MBMS-GW (M1)."""
        from . import mbms as mb

        self.mbms = {"area": area_id, "data_mcs": data_mcs,
                     "queue": [], "mcch": mb.build_mcch(data_mcs),
                     "cell": mb.mbsfn_cell(self.cell)}
        if self.broadcast:
            from ..mac.bcch import SibConfig

            sib13 = mb.build_sib13(area_id)
            self.sib_payloads.append(sib13)
            self.sib_sched.sibs.append(
                SibConfig(payload_len=len(sib13), period_rf=16))
        self.events.append(f"mbms_enabled_area{area_id}")

    def deliver_m1(self, gtpu_pdu: bytes) -> None:
        """M1 user plane from the MBMS-GW (mbms-gw.cc fan-out)."""
        from ..epc.mbms_gw import m1_ingest

        ip = m1_ingest(gtpu_pdu)
        if ip is not None and self.mbms is not None:
            self.mbms["queue"].append(ip)

    def _compose_tm4(self, tti: int, rnti: int, macs, prb_next: int,
                     cce: int):
        """One 2-codeword TM4 (closed-loop spatial multiplexing) grant:
        format-2 DCI with an RBG type-0 allocation, two transport
        blocks layer-mapped over 2 ports (srsenb phch_worker TM3/TM4
        path). Returns (grid contribution, PRBs used) or None."""
        import math

        from ..mac.harq import DlHarqEntity
        from ..ops.equalizer import MimoType

        sf_idx = tti % 10
        st = self.active_ues.get(rnti)
        if st is None or rnti not in self.rrc.ues:
            return None
        mac1, mac2 = macs
        raw = max(sum(len(sp.payload) + 2 for sp in m.subpdus) + 2
                  for m in (mac1, mac2))
        mcs = DL_MCS
        if "cqi" in st:
            from ..mac.scheduler import CQI_TO_MCS

            mcs = max(DL_MCS, CQI_TO_MCS[min(max(st["cqi"] - 2, 0), 15)])
        n_prb, _, _ = _dl_grant_for(self.cell.nof_prb, raw, mcs)
        rbg = ra.rbg_size(self.cell.nof_prb)
        n_rbg_tot = math.ceil(self.cell.nof_prb / rbg)
        first = math.ceil(prb_next / rbg)
        k = math.ceil(n_prb / rbg)
        if (first + k) * rbg - rbg >= self.cell.nof_prb:
            pass                         # last RBG may be short: ok
        if first + k > n_rbg_tot:
            return None                  # no RBGs left this tti
        bitmap = ((1 << k) - 1) << (n_rbg_tot - first - k)
        mask = ra.prb_mask_type0(self.cell.nof_prb, bitmap)
        mod, tbs = ra.mcs_to_tbs(mcs, sum(mask))
        harq = st.setdefault("harq", DlHarqEntity())
        procs = [harq.get_empty()]
        if procs[0] is not None:
            procs[0].new_tx(tbs, mcs)
        procs.append(harq.get_empty())
        if procs[1] is not None:
            procs[1].new_tx(tbs, mcs)
        pid0 = procs[0].pid if procs[0] else 0
        ndis = tuple(p.ndi if p else 0 for p in procs)
        dci_bits = dci_mod.pack_format2(
            self.cell.nof_prb, bitmap, (mcs, mcs), harq_pid=pid0,
            ndi=ndis, rv=(0, 0), pmi=0)
        cfg = PdschConfig(cell=self.cell, sf_idx=sf_idx, cfi=self.cfi,
                          rnti=rnti, mod=mod, mimo=MimoType.SPATIAL_MUX,
                          nof_layers=2, nof_codewords=2, pmi=0,
                          prb_mask=mask)
        plan = cfg.plan(tbs)
        grid = pdcch_encode(self._t(dci_bits), rnti, cce, 4,
                            self.cell, self.cfi, sf_idx)
        byts = [m.pack(tbs // 8) for m in (mac1, mac2)]
        tb = [np.unpackbits(np.frombuffer(b, np.uint8)).astype(np.int8)
              for b in byts]
        grid = grid + pdsch_encode(self._t(tb[0])[None], cfg, plan,
                                   self._t(tb[1])[None], plan)[0]
        self.events.append(f"tm4_tx_rnti{rnti:#x}_tti{tti}")
        # per-codeword ACKs at n+4 (PUCCH 1b / 2-bit UCI); a NACKed TB
        # retransmits standalone through the 1A fallback path
        for cw, (p, b) in enumerate(zip(procs, byts)):
            if p is None:
                continue
            self.ack_pending.setdefault(tti + 4, []).append(
                (rnti, p.pid, dict(pid=p.pid, ndi=p.ndi, rv=p.rv,
                                   n_prb=sum(mask), mod=mod, tbs=tbs,
                                   mcs=mcs, mac_bytes=b),
                 N1_PUCCH + cce))
        return grid, sum(mask)

    def _compose_mbsfn(self, tti: int) -> np.ndarray:
        """One MBSFN subframe: normal-CP control region (CRS/PCFICH/
        PHICH) + extended-CP PMCH region with MBSFN RS (enb_dl.c
        put_mbsfn_base + srslte_pmch_encode)."""
        from ..models.pmch import PmchConfig, pmch_encode
        from ..ops.ofdm import ofdm_tx_sf_mbsfn
        from . import mbms as mb

        sf_idx = tti % 10
        base = enb_dl_base_grid(self.cell, sf_idx, (), device=self.device)
        base = pcfich_put(base, self.cfi, self.cell, sf_idx)
        for g, q, ack in self.phich_pending.pop(tti, []):
            from ..models.phich import phich_put

            base = phich_put(base, ack, self.cell, sf_idx, group=g,
                             seq_idx=q)
        mcch = mb.is_mcch_occasion(tti)
        if mcch:
            lcid, payload, mcs = mb.LCID_MCCH, self.mbms["mcch"],                 mb.MCCH_MCS
        elif self.mbms["queue"]:
            lcid, payload, mcs = mb.LCID_MTCH,                 self.mbms["queue"].pop(0), self.mbms["data_mcs"]
        else:
            payload = None
        mcell = self.mbms["cell"]
        if payload is not None:
            mod, tbs = mb.pmch_tbs(mcell, mcs)
            mac = MacPdu()
            mac.add_sdu(lcid, payload)
            tb_bits = np.unpackbits(
                np.frombuffer(mac.pack(tbs // 8), np.uint8))
            cfg = PmchConfig(cell=mcell, area_id=self.mbms["area"],
                             sf_idx=mb.MBSFN_SF, cfi=self.cfi, mod=mod)
            grid12 = pmch_encode(
                self._t(tb_bits.astype(np.int8))[None], cfg,
                cfg.plan(tbs))[0]
            self.events.append(
                f"pmch_tx_{'mcch' if mcch else 'mtch'}_tti{tti}")
        else:
            from ..models.pmch import pmch_put_rs

            cfg = PmchConfig(cell=mcell, area_id=self.mbms["area"],
                             sf_idx=mb.MBSFN_SF, cfi=self.cfi)
            grid12 = pmch_put_rs(
                torch.zeros((12, mcell.nof_re), dtype=torch.complex64,
                            device=self.device), cfg)
        # control region (port 0) over the first cfi symbols
        grid12 = torch.cat([base[0, : self.cfi], grid12[self.cfi :]], dim=0)
        return ofdm_tx_sf_mbsfn(grid12, self.cell,
                                non_mbsfn_region=self.cfi).cpu().numpy()

    def admit_handover(self, req: dict) -> bytes:
        """Target-side admission (36.413 HandoverRequest -> rrc
        prepare_handover): reserve the dedicated preamble and open a
        standing UL window for the arriving UE's complete."""
        self.rrc.rsi = self.rsi       # advertise OUR prach root in mci
        cmd = self.rrc.prepare_handover(req)
        rnti = self.rrc.next_c_rnti - 1       # allocated by prepare
        self.dedicated_preambles[4] = rnti    # ra_preamble_index (rrc)
        self.active_ues.setdefault(rnti, {})["want_ul"] = True
        self.events.append(f"ho_admit_rnti{rnti:#x}")
        return cmd

    def release_ue(self, rnti: int) -> None:
        """RRCConnectionRelease towards the UE; the context is purged a
        few TTIs later (after the release TB has been delivered)."""
        self.send_dl(*self.rrc.release_connection(rnti))
        self.active_ues.setdefault(rnti, {})["release_countdown"] = 20

    def page(self, imsi: str, m_tmsi: int) -> None:
        """Queue an S-TMSI page for the UE's 36.304 paging occasion
        (mme s1ap paging -> rrc.cc is_paging_opportunity)."""
        from ..rrc import messages as M

        pcch = M.pack_pcch({"paging_record_list": [
            {"ue_identity": ("s_tmsi", {"mmec": 0, "m_tmsi": m_tmsi}),
             "cn_domain": "ps"}]})
        self.paging.add(imsi, pcch)
        self.events.append(f"paging_queued_{m_tmsi:#x}")

    def _purge_ue(self, rnti: int) -> None:
        self.active_ues.pop(rnti, None)
        self.drbs.pop(rnti, None)
        self.dl_queues.pop(rnti, None)
        self.rrc.ues.pop(rnti, None)
        self.events.append(f"ue_purged_{rnti:#x}")

    # --- per-TTI processing ---------------------------------------------------

    def tti(self, tti: int, ul_iq) -> np.ndarray:
        """ul_iq is the UE's transmission OF SUBFRAME tti-1 (one-subframe
        transport delay, like rx_now delivering the previous subframe in
        txrx.cc): process it under its own subframe index."""
        if ul_iq is not None:
            self._process_ul(tti - 1, ul_iq)
        else:
            self._process_ul_idle(tti - 1)
        for st in self.active_ues.values():
            rlc = st.get("srb1_rlc")
            if rlc is not None:
                rlc.tick()              # t-PollRetransmit (rlc_am.cc)
        return self._compose_dl(tti)

    def _process_ul_idle(self, tti: int):
        """No UL signal this subframe: expected transmissions are DTX."""
        for p in self.ul_pending.pop(tti, []):
            self.events.append(f"pusch_dtx_tti{tti}")
            self._on_pusch_fail(tti, p)
        for rnti, pid, rec, _ in self.ack_pending.pop(tti, []):
            self._handle_ack(rnti, pid, rec, False)

    def _on_pusch_fail(self, tti: int, p: _PendingUl):
        """CRC failure / DTX on a scheduled PUSCH: PHICH NACK at n+4 and
        a synchronous retransmission slot at n+8 with the next rv
        (scheduler_harq.cc ul path; softbuffers persist for combining)."""
        import dataclasses

        from ..mac.harq import MAX_RETX, RV_SEQ
        from ..models.phich import phich_resource

        g, q = phich_resource(self.cell, p.cfg.prb_start)
        self.phich_pending.setdefault(tti + 4, []).append((g, q, 0))
        if p.n_tx >= MAX_RETX:
            self.events.append(f"ul_harq_max_retx_rnti{p.rnti:#x}")
            return
        cfg = dataclasses.replace(p.cfg, sf_idx=(tti + 8) % 10)
        self.ul_pending.setdefault(tti + 8, []).append(
            _PendingUl(p.rnti, cfg, p.tbs, rv=RV_SEQ[p.n_tx % 4],
                       n_tx=p.n_tx + 1, softbuffers=p.softbuffers))

    def _on_pusch_ok(self, tti: int, p: _PendingUl):
        from ..models.phich import phich_resource

        g, q = phich_resource(self.cell, p.cfg.prb_start)
        self.phich_pending.setdefault(tti + 4, []).append((g, q, 1))

    def _process_ul(self, tti: int, ul_iq):
        sf_idx = tti % 10
        # PRACH detection on the PRACH subframe
        if sf_idx == PRACH_SF:
            seq_len = prach_seq_len(self.cell)
            win = np.asarray(ul_iq).astype(np.complex64)
            cp = len(win) - seq_len if len(win) > seq_len else 0
            det, offs, metric = prach_detect(
                self._t(win[None, cp : cp + seq_len]), self.cell,
                self.rsi, zcz=PRACH_ZCZ,
                freq_offset_prb=PRACH_FREQ_OFFSET)
            det = det[0].cpu().numpy()
            offs = offs[0].cpu().numpy()
            for rapid in np.nonzero(det)[0]:
                self._on_prach(tti, int(rapid), int(offs[rapid]))
        expected = {p.rnti for p in self.ul_pending.get(tti, [])}
        # SR detection on PUCCH format 1 (eNB side of proc_sr): checked
        # for connected UEs on their occasion, unless a PUSCH is due
        sr_ues = [r for r, st in self.active_ues.items()
                  if r in self.rrc.ues and r not in expected
                  and not st.get("want_ul")
                  and sf_idx == self.rrc.ues[r].get("sr_subframe",
                                                    SR_SUBFRAME)]
        grid = None
        if sr_ues:
            from ..models.pucch import PucchConfig, pucch_f1_decode

            grid = self._ul_grid(ul_iq) if grid is None else grid
            for rnti in sr_ues:
                st = self.active_ues[rnti]
                pcfg = PucchConfig(cell=self.cell, sf_idx=sf_idx,
                                   n_pucch=self.rrc.ues[rnti].get(
                                       "sr_n_pucch", 0),
                                   format="1", n_rb_2=PUCCH_N_RB_2)
                d, energy = pucch_f1_decode(grid, pcfg)
                d, energy = complex(d), float(energy)
                if energy > SR_DETECT_THRESHOLD and d.real > 0.5:
                    self.events.append(f"sr_detected_rnti{rnti:#x}")
                    st["want_ul"] = True
        # HARQ-ACK reception (phch_worker decode_pucch / UCI-on-PUSCH):
        # ACK retires the process, NACK/DTX queues a retransmission
        acks_due: dict = {}
        for rnti, pid, rec, n_pucch in self.ack_pending.pop(tti, []):
            acks_due.setdefault(rnti, []).append((pid, rec, n_pucch))
        for rnti in [r for r in acks_due if r not in expected]:
            items = acks_due.pop(rnti)
            grid = self._ul_grid(ul_iq) if grid is None else grid
            bits = self._decode_pucch_ack(grid, sf_idx, items)
            for (pid, rec, _), ack in zip(items, bits):
                self._handle_ack(rnti, pid, rec, ack)
        # periodic CQI on PUCCH format 2 (eNB side of the reporting
        # config; feeds CQI->MCS link adaptation like scheduler_ue.cc)
        cqi_ues = [r for r, st in self.active_ues.items()
                   if r in self.rrc.ues and r not in expected
                   and sf_idx == self.rrc.ues[r].get("cqi_subframe",
                                                     CQI_SUBFRAME)]
        if cqi_ues:
            from ..models.pucch import PucchConfig, pucch_f2_decode
            from ..models.uci import cqi_unpack_wideband

            grid = self._ul_grid(ul_iq) if grid is None else grid
            for rnti in cqi_ues:
                st = self.active_ues[rnti]
                cfg_ue = self.rrc.ues[rnti]
                pcfg = PucchConfig(cell=self.cell, sf_idx=sf_idx,
                                   n_pucch=cfg_ue.get("cqi_n_pucch", 0),
                                   format="2")
                # an RI occasion (36.213 7.2.2 M_ri spacing) carries the
                # 1-bit rank indicator instead of CQI
                ri_occasion = (
                    "ri_period" in cfg_ue
                    and tti % cfg_ue["ri_period"] == cfg_ue["ri_subframe"])
                nof_bits = 1 if ri_occasion else 4
                payload, energy = pucch_f2_decode(grid, pcfg,
                                                  nof_bits,
                                                  return_energy=True)
                if energy < CQI_DETECT_THRESHOLD:
                    continue             # no report this occasion
                if ri_occasion:
                    from ..models.uci import ri_unpack

                    st["ri"] = ri_unpack(payload)
                    self.events.append(
                        f"ri_rx{st['ri']}_rnti{rnti:#x}")
                    continue
                cqi = int(cqi_unpack_wideband(payload))
                if cqi > 0:
                    st["cqi"] = cqi
                    self.events.append(f"cqi_rx{cqi}_rnti{rnti:#x}")
        # scheduled PUSCH receptions (with UCI demux when ACKs are due)
        for p in self.ul_pending.pop(tti, []):
            grid = self._ul_grid(ul_iq) if grid is None else grid
            items = acks_due.pop(p.rnti, None)
            if items or p.cqi_req:
                from ..models.pusch import (UciData, UciPlan,
                                            pusch_decode_uci_jit)
                from ..models.uci import (cqi_hl_subband_nof_bits,
                                          cqi_unpack_hl_subband)

                o_cqi = cqi_hl_subband_nof_bits(self.cell.nof_prb) \
                    if p.cqi_req else 0
                plan = UciPlan(p.cfg, p.tbs,
                               UciData(ack=(1,) * len(items or ()),
                                       cqi_bits=(0,) * o_cqi), rv=p.rv)
                fn = pusch_decode_uci_jit(p.cfg, plan,
                                          p.softbuffers is not None)
                out = fn(grid, 1e-3, p.softbuffers) \
                    if p.softbuffers is not None else fn(grid, 1e-3)
                ok = bool(out["crc_ok"].all())
                if items:
                    if ok:
                        acked = [bool(a) for a in out["ack"]]
                    else:
                        # the UE may have missed the grant and sent the
                        # ACK on PUCCH instead: fall back before
                        # declaring DTX (phch_worker checks both owners)
                        acked = self._decode_pucch_ack(grid, sf_idx,
                                                       items)
                    for (pid, rec, _), ack in zip(items, acked):
                        self._handle_ack(p.rnti, pid, rec, ack)
                if p.cqi_req and ok and out["cqi_bits"] is not None:
                    wb, sbs = cqi_unpack_hl_subband(
                        out["cqi_bits"].cpu().numpy().ravel(),
                        self.cell.nof_prb)
                    stc = self.active_ues.setdefault(p.rnti, {})
                    if wb > 0:
                        stc["cqi"] = wb
                    stc["sb_cqi"] = sbs
                    stc["sb_tti"] = tti
                    self.events.append(
                        f"sbcqi_rx_wb{wb}_rnti{p.rnti:#x}")
                bits, sbuf = out["tb"], out["softbuffers"]
            else:
                fn = pusch_decode_jit(p.cfg, p.tbs, p.rv,
                                      p.softbuffers is not None)
                bits, okc, sbuf = (fn(grid, 1e-3, p.softbuffers)
                                   if p.softbuffers is not None
                                   else fn(grid, 1e-3))
                ok = bool(okc.all())
            if not ok:
                self.events.append(f"pusch_crc_fail_tti{tti}")
                p.softbuffers = sbuf       # combined LLRs for the retx
                self._on_pusch_fail(tti, p)
                continue
            self._on_pusch_ok(tti, p)
            data = np.packbits(bits.cpu().numpy().ravel()[: p.tbs])
            self._on_mac_pdu(p.rnti, bytes(data.tobytes()))
        # ACKs still unresolved (no PUCCH, no PUSCH): DTX
        for rnti, items in acks_due.items():
            for pid, rec, _ in items:
                self._handle_ack(rnti, pid, rec, False)

    def _decode_pucch_ack(self, grid, sf_idx: int, items) -> list[bool]:
        """ACK/NACK bits off PUCCH 1a at the CCE-derived resource."""
        from ..models.pucch import PucchConfig, pucch_f1_bits, \
            pucch_f1_decode

        pcfg = PucchConfig(cell=self.cell, sf_idx=sf_idx,
                           n_pucch=items[0][2],
                           format="1a" if len(items) == 1 else "1b",
                           n_rb_2=PUCCH_N_RB_2)
        d, energy = pucch_f1_decode(grid, pcfg)
        if float(energy) <= ACK_DETECT_THRESHOLD:
            return [False] * len(items)
        bits = pucch_f1_bits(d, pcfg.format).tolist()
        return [bool(b) for b in bits[: len(items)]]

    def _handle_ack(self, rnti: int, pid: int, rec: dict, ack: bool):
        st = self.active_ues.get(rnti)
        if st is None or "harq" not in st:
            return
        harq = st["harq"]
        p = harq.processes[pid]
        if p.ack(ack):
            p.retx()
            rec = dict(rec, rv=p.rv)
            self.events.append(f"harq_nack_pid{pid}_rnti{rnti:#x}")
            self.dl_queues.setdefault(rnti, []).insert(
                0, (None, {"retx": rec}))
        elif ack:
            self.events.append(f"harq_ack_pid{pid}_rnti{rnti:#x}")

    def _ul_grid(self, ul_iq):
        from ..models.ue_ul import enb_ul_receive_grid

        return enb_ul_receive_grid(
            self._t(np.asarray(ul_iq).astype(np.complex64)), self.cell)

    def _on_prach(self, tti: int, rapid: int, offset: int = 0):
        # dedicated preamble (incoming handover) -> the reserved C-RNTI;
        # otherwise RRC will allocate the next one on msg3
        t_crnti = self.dedicated_preambles.pop(
            rapid, self.rrc.next_c_rnti)
        # timing advance from the detected preamble delay (36.213 4.2.3:
        # TA command in units of 16 Ts = 16 * fft/2048 samples)
        ta_unit = 16 * self.cell.fft_size // 2048
        ta = min(0x7FF, (offset + ta_unit // 2) // ta_unit)
        self.events.append(f"prach_rapid{rapid}_ta{ta}")
        ra_rnti = 1 + (tti % 10)
        rar = pack_rar_pdu(rapid, ta=ta, rb_start=MSG3_PRB[0],
                           n_prb=MSG3_PRB[1], mcs=MSG3_MCS,
                           t_crnti=t_crnti, nof_prb_ul=self.cell.nof_prb)
        self.dl_queues.setdefault(ra_rnti, []).append((rar, None))
        # msg3 reception at tti+1(dl tx)+msg3_delay
        msg3_tti = tti + 1 + self.msg3_delay
        mod, tbs = ra.mcs_to_tbs(MSG3_MCS, MSG3_PRB[1], dl=False)
        cfg = PuschConfig(cell=self.cell, sf_idx=msg3_tti % 10,
                          rnti=t_crnti, mod=mod, prb_start=MSG3_PRB[0],
                          n_prb=MSG3_PRB[1])
        self.ul_pending.setdefault(msg3_tti, []).append(
            _PendingUl(t_crnti, cfg, tbs))

    def _on_mac_pdu(self, rnti: int, data: bytes):
        pdu = unpack_pdu(data, ul=True)
        # MAC CEs: BSR drives the standing UL grant (scheduler_ue.cc
        # ul_buffer_add), PHR is recorded for the scheduler
        for sp in pdu.subpdus:
            if sp.is_sdu:
                continue
            st = self.active_ues.setdefault(rnti, {})
            if sp.lcid in (LCID_SHORT_BSR, LCID_TRUNC_BSR):
                idx = sp.payload[0] & 0x3F
                st["ul_buffer"] = BSR_TABLE[idx]
                st["want_ul"] = idx > 0
            elif sp.lcid == LCID_LONG_BSR:
                b = sp.payload
                idxs = [b[0] >> 2, ((b[0] & 0x3) << 4) | (b[1] >> 4),
                        ((b[1] & 0xF) << 2) | (b[2] >> 6), b[2] & 0x3F]
                st["ul_buffer"] = sum(BSR_TABLE[i] for i in idxs)
                st["want_ul"] = st["ul_buffer"] > 0
            elif sp.lcid == LCID_PHR:
                st["phr_db"] = (sp.payload[0] & 0x3F) - 23
        for sp in pdu.subpdus:
            if not sp.is_sdu or not sp.payload:
                continue
            if sp.lcid == 3:          # DRB1 -> GTP-U towards the SP-GW
                d = self._drb(rnti)
                d["rlc_rx"].write_pdu(sp.payload)
                while d["rlc_rx"].rx_sdus:
                    ip = d["pdcp_rx"].write_pdu(d["rlc_rx"].rx_sdus.pop(0))
                    if ip is not None:
                        teid = self.rrc.ues.get(rnti, {}).get(
                            "spgw_teid", 1)
                        self.ul_gtpu.append(gtpu_pack(teid, ip))
                continue
            if sp.lcid == 1:
                rlc = self._srb1(rnti)
                rlc.write_pdu(sp.payload)
                n_ev = len(self.rrc.events)
                while rlc.rx_sdus:
                    sdu = rlc.rx_sdus.pop(0)
                    for m_rnti, m_srb, m_pdu in self.rrc.handle_ul(
                            rnti if rnti in self.rrc.ues else 0, 1, sdu):
                        self.send_dl(m_rnti, m_srb, m_pdu)
                if any(e in ("s1_handover_cmd",) or
                       e.startswith("handover_decision")
                       for e in self.rrc.events[n_ev:]):
                    # source side: the UE departs once the command is
                    # delivered; schedule the context purge
                    st = self.active_ues.setdefault(rnti, {})
                    st.setdefault("release_countdown", 30)
                continue
            if rnti not in self.rrc.ues:
                # msg3: contention resolution identity = first 6 bytes
                self.active_ues[rnti] = {"con_res": sp.payload[:6]}
            n_ev0 = len(self.rrc.events)
            responses = self.rrc.handle_ul(
                rnti if rnti in self.rrc.ues else 0, 0, sp.payload)
            for ev in self.rrc.events[n_ev0:]:
                # context migrated to the new C-RNTI: drop the failed
                # link's MAC/RLC state (kept under the old rnti)
                if ev.startswith("reestablish_migrated_"):
                    old = int(ev.split("_")[2], 16)
                    self.active_ues.pop(old, None)
                    self.drbs.pop(old, None)
                    self.dl_queues.pop(old, None)
            for m_rnti, m_srb, m_pdu in responses:
                self.send_dl(m_rnti, m_srb, m_pdu)

    # --- DL path ----------------------------------------------------------------

    def send_dl(self, rnti: int, srb: int, pdu: bytes):
        if srb == 1:
            # SRB1 rides RLC AM; drained into MAC PDUs by _compose_dl
            self._srb1(rnti).write_sdu(pdu)
        else:
            mac = MacPdu()
            ue = self.active_ues.get(rnti)
            if ue is not None and ue.get("con_res") is not None:
                mac.add_con_res(ue.pop("con_res"))
            mac.add_sdu(0, pdu)
            self.dl_queues.setdefault(rnti, []).append((mac, None))
        # any DL signalling implies the UE may need to answer: open a
        # standing UL grant window
        if rnti in self.rrc.ues:
            self.active_ues.setdefault(rnti, {})["want_ul"] = True

    def _compose_dl(self, tti: int) -> np.ndarray:
        sf_idx = tti % 10
        if self.mbms is not None and sf_idx == 3:
            return self._compose_mbsfn(tti)
        grid = enb_dl_base_grid(self.cell, sf_idx, (), device=self.device)
        grid = put_sync_signals(grid, self.cell, sf_idx)
        grid = pcfich_put(grid, self.cfi, self.cell, sf_idx)
        if self.broadcast and sf_idx == 0:
            from ..models.pbch import pbch_put
            from .si import build_mib_bits

            sfn = (tti // 10) % 1024
            grid = pbch_put(grid, self._t(build_mib_bits(self.cell, sfn)),
                            self.cell, sfn)
        for g, q, ack in self.phich_pending.pop(tti, []):
            from ..models.phich import phich_put

            grid = phich_put(grid, ack, self.cell, sf_idx, group=g,
                             seq_idx=q)

        from ..models.regs import pdcch_nof_cces

        # delayed context purge after a release (rrc.cc rem_user)
        for rnti in list(self.active_ues):
            cd = self.active_ues[rnti].get("release_countdown")
            if cd is not None:
                if cd <= 0:
                    self._purge_ue(rnti)
                else:
                    self.active_ues[rnti]["release_countdown"] = cd - 1
        # paging occasions due this subframe -> PCCH on the P-RNTI
        for pcch in self.paging.opportunity(tti):
            self.dl_queues.setdefault(P_RNTI, []).append((pcch, None))
        # broadcast: SIB occasions on the SI-RNTI + MIB quarter on PBCH
        if self.broadcast:
            for g in self.sib_sched.new_tti(tti):
                self.dl_queues.setdefault(SI_RNTI, []).append(
                    (self.sib_payloads[g.sib_index], {"si_rv": g.rv}))

        n_cce = pdcch_nof_cces(self.cell, self.cfi)
        cce_next = 0          # per-subframe CCE allocator (L=4 slots
                              # land on common-search-space candidates,
                              # 36.213 9.1.1: CCE 0/4/8/12)
        prb_next = 0          # contiguous type-2 PDSCH allocator
        # drain per-UE RLC buffers into MAC PDUs (mac.cc pulling from
        # rlc.cc): SRB1 (AM status + data) has priority over the DRB
        for rnti, st in self.active_ues.items():
            if self.dl_queues.get(rnti):
                continue
            rlc = st.get("srb1_rlc")
            if rlc is not None:
                rlc.tick()             # t-Reordering, per TTI
                mac = MacPdu()
                status = rlc.get_status_pdu()
                if status is not None:
                    mac.add_sdu(1, status)
                pdu1 = rlc.read_pdu(120)
                if pdu1 is not None:
                    mac.add_sdu(1, pdu1)
                if mac.subpdus:
                    self.dl_queues.setdefault(rnti, []).append(
                        (mac, None))
                    continue
            d = self.drbs.get(rnti)
            if d is None:
                continue
            rlc_pdu = d["rlc_tx"].read_pdu(200)
            if rlc_pdu is None:
                continue
            mac = MacPdu()
            mac.add_sdu(3, rlc_pdu)
            if self.cell.nof_ports >= 2 and \
                    self.active_ues.get(rnti, {}).get("ri", 2) == 2:
                # TM4: pair a second transport block when more data
                # waits (two codewords on one spatial-multiplexed
                # grant) — only while the UE's periodic RI reports
                # rank 2 (scheduler_ue.cc dl_ri link adaptation)
                rlc_pdu2 = d["rlc_tx"].read_pdu(200)
                if rlc_pdu2 is not None:
                    mac2 = MacPdu()
                    mac2.add_sdu(3, rlc_pdu2)
                    self.dl_queues.setdefault(rnti, []).append(
                        ((mac, mac2), {"tm4": True}))
                    continue
            self.dl_queues.setdefault(rnti, []).append((mac, None))
        # scheduling order: RA-RNTIs (RAR/broadcast window) first, then
        # connected UEs round-robin (dl_metric_rr::new_tti)
        ras = [r for r, q in self.dl_queues.items()
               if q and (r <= 10 or r >= P_RNTI)]
        ues = [r for r, q in self.dl_queues.items()
               if q and 10 < r < P_RNTI]
        if ues:
            rot = self._rr_next % len(ues)
            ues = ues[rot:] + ues[:rot]
            self._rr_next += 1
        n_alloc = 0
        agent_grants = []
        # frequency-selective allocations land anywhere free; contiguous
        # left-cursor allocations must skip those ranges
        extra_alloc: list = []        # selective (start, end) this tti

        def _skip_extra(s: int, n: int) -> int:
            moved = True
            while moved:
                moved = False
                for a, b in extra_alloc:
                    if not (s + n <= a or b <= s):
                        s, moved = b, True
            return s

        for rnti in ras + ues:
            if cce_next + 4 > min(n_cce, 16):
                break                         # control region exhausted
            queue = self.dl_queues[rnti]
            if not queue:
                continue
            st = self.active_ues.get(rnti)
            payload, meta = queue[0]
            if (meta or {}).get("tm4"):
                prb_next = _skip_extra(prb_next, 16)
                used = self._compose_tm4(tti, rnti, payload, prb_next,
                                         cce_next)
                if used is None:
                    continue
                grid = grid + used[0]
                prb_next += used[1]
                cce_next += 4
                n_alloc += 1
                queue.pop(0)
                continue
            retx = (meta or {}).get("retx")
            if retx is not None:
                # retransmission: same TB (adaptive PRB start), next RV
                pid, ndi, rv = retx["pid"], retx["ndi"], retx["rv"]
                n_prb, mod, tbs, mcs = (retx["n_prb"], retx["mod"],
                                        retx["tbs"], retx["mcs"])
                mac_bytes = retx["mac_bytes"]
            else:
                if isinstance(payload, MacPdu):
                    raw_len = sum(len(sp.payload) + 2
                                  for sp in payload.subpdus) + 2
                else:
                    raw_len = len(payload)
                tpc = 0
                if rnti <= 10 or rnti >= P_RNTI:
                    # common search space: TBS column is N_prb_1A from
                    # the TPC LSB (the UE sizes SI/P/RA grants that way)
                    mcs, n_prb, tpc, mod, tbs = _common_grant_for(raw_len)
                else:
                    # CQI-driven link adaptation (scheduler_ue.cc)
                    mcs = DL_MCS
                    if st is not None and "cqi" in st:
                        from ..mac.scheduler import CQI_TO_MCS

                        # 2-step CQI backoff: no outer-loop adjustment
                        # here (scheduler_ue.cc max_mcs/fixed_mcs)
                        mcs = max(DL_MCS,
                                  CQI_TO_MCS[min(max(st["cqi"] - 2, 0),
                                                 15)])
                    n_prb, mod, tbs = _dl_grant_for(self.cell.nof_prb,
                                                    raw_len, mcs)
            # --- PRB placement ------------------------------------------
            # With a live subband CQI report (36.213 7.2.1 aperiodic
            # feedback), pick the contiguous window with the best mean
            # per-PRB CQI — the frequency-selective metric the reference
            # scheduler builds from its cqi feedback — and cap the MCS by
            # the window's worst subband. Otherwise: next free PRBs.
            prb_start = None
            if (retx is None and st is not None and "sb_cqi" in st
                    and 10 < rnti < P_RNTI):
                from ..models.uci import cqi_hl_subband_size

                k_sb = cqi_hl_subband_size(self.cell.nof_prb)
                per_prb = [st["sb_cqi"][min(i // k_sb,
                                            len(st["sb_cqi"]) - 1)]
                           for i in range(self.cell.nof_prb)]
                best_m = -1.0
                for s in range(prb_next, self.cell.nof_prb - n_prb + 1):
                    if _skip_extra(s, n_prb) != s:
                        continue
                    m = sum(per_prb[s:s + n_prb]) / n_prb
                    if m > best_m:
                        best_m, prb_start = m, s
                if prb_start is not None:
                    win_min = min(per_prb[prb_start:prb_start + n_prb])
                    from ..mac.scheduler import CQI_TO_MCS

                    cap = CQI_TO_MCS[min(max(win_min - 2, 0), 15)]
                    if cap < mcs:
                        _, tbs_cap = ra.mcs_to_tbs(cap, n_prb)
                        if tbs_cap >= 8 * raw_len:
                            mcs = cap
                            mod, tbs = ra.mcs_to_tbs(mcs, n_prb)
                    extra_alloc.append((prb_start,
                                        prb_start + n_prb))
                    self.events.append(
                        f"fsel_alloc_prb{prb_start}_rnti{rnti:#x}")
            if prb_start is None:
                prb_start = _skip_extra(prb_next, n_prb)
                if prb_start + n_prb > self.cell.nof_prb:
                    continue                  # no PRBs left this tti
                prb_next = prb_start + n_prb
            if retx is not None:
                self.events.append(f"harq_retx_pid{pid}_rv{rv}")
                tpc = 0
            else:
                mac_bytes = payload.pack(tbs // 8) \
                    if isinstance(payload, MacPdu) \
                    else payload + b"\x00" * (tbs // 8 - len(payload))
                pid, ndi = 0, 0
                rv = (meta or {}).get("si_rv", 0)
                if st is not None and rnti in self.rrc.ues:
                    from ..mac.harq import DlHarqEntity

                    harq = st.setdefault("harq", DlHarqEntity())
                    p = harq.get_empty()
                    if p is not None:
                        p.new_tx(tbs, mcs)
                        pid, ndi = p.pid, p.ndi
            queue.pop(0)
            tb_bits = np.unpackbits(np.frombuffer(mac_bytes, np.uint8))
            dci_bits = dci_mod.pack_format1a(
                self.cell.nof_prb, prb_start, n_prb, mcs, harq_pid=pid,
                ndi=ndi, rv=rv, tpc=tpc)
            from ..ops.equalizer import MimoType

            cfg = PdschConfig(cell=self.cell, sf_idx=sf_idx, cfi=self.cfi,
                              rnti=rnti, mod=mod,
                              mimo=(MimoType.DIVERSITY
                                    if self.cell.nof_ports >= 2
                                    else MimoType.SINGLE),
                              prb_mask=ra.prb_mask_type2(
                                  self.cell.nof_prb, prb_start, n_prb))
            plan = cfg.plan(tbs, rv=rv)
            cce_used = cce_next
            grid = grid + pdcch_encode(self._t(dci_bits), rnti,
                                       cce_used, 4, self.cell, self.cfi,
                                       sf_idx)
            cce_next += 4
            grid = grid + pdsch_encode(
                self._t(tb_bits.astype(np.int8))[None], cfg, plan)[0]
            n_alloc += 1
            if self.agent is not None:
                from ..mac.scheduler import DlGrant

                agent_grants.append(DlGrant(
                    rnti=rnti, rbg_bitmap=0, n_prb=n_prb, mcs=mcs,
                    tbs=tbs, harq_pid=pid, rv=rv, ndi=ndi))
            if st is not None and "harq" in st and rnti in self.rrc.ues:
                # expect the HARQ-ACK at n+4, on PUCCH n_cce + N1
                # (36.213 10.1) or multiplexed on a granted PUSCH
                self.ack_pending.setdefault(tti + 4, []).append(
                    (rnti, pid, dict(pid=pid, ndi=ndi, rv=rv,
                                     n_prb=n_prb, mod=mod, tbs=tbs,
                                     mcs=mcs, mac_bytes=mac_bytes),
                     N1_PUCCH + cce_used))

        if n_alloc > 1:
            self.events.append(f"dl_multiuser{n_alloc}_tti{tti}")
        if self.agent is not None:
            self.agent.process_dl_results(tti, agent_grants,
                                          self.cell.nof_prb)

        # standing UL grants (DCI0) for UEs with pending uplink: each UE
        # gets its own PRB slice and CCE (ul_sched allocating distinct
        # resources per user)
        ul_slot = 0
        for rnti, st in list(self.active_ues.items()):
            pend = self.ul_pending.get(tti + 4, [])
            if not st.get("want_ul") or any(p.rnti == rnti for p in pend):
                continue
            start = UL_GRANT_PRB0 + UL_GRANT_N_PRB * ul_slot
            n_prb = UL_GRANT_N_PRB
            if (start + n_prb > self.cell.nof_prb - PUCCH_N_RB_2
                    or cce_next + 4 > min(n_cce, 16)):
                break                      # out of PRBs/CCEs this tti
            ul_slot += 1
            mod, tbs = ra.mcs_to_tbs(UL_MCS, n_prb, dl=False)
            # aperiodic CSI request when the subband report is stale
            # (sched ul_sched cqi_request; 36.212 format 0 CSI bit)
            cqi_req = (self.aperiodic_cqi and rnti in self.rrc.ues
                       and tti - st.get("sb_tti", -999) > 20)
            dci0 = dci_mod.pack_format0(self.cell.nof_prb, start, n_prb,
                                        UL_MCS, cqi_req=int(cqi_req))
            grid = grid + pdcch_encode(self._t(dci0), rnti, cce_next,
                                       4, self.cell, self.cfi, sf_idx)
            cce_next += 4
            cfg = PuschConfig(cell=self.cell, sf_idx=(tti + 4) % 10,
                              rnti=rnti, mod=mod, prb_start=start,
                              n_prb=n_prb)
            self.ul_pending.setdefault(tti + 4, []).append(
                _PendingUl(rnti, cfg, tbs, cqi_req=cqi_req))
        if self.agent is not None:
            self.agent.process_ul_results(
                tti, UL_GRANT_N_PRB * ul_slot, self.cell.nof_prb)

        sig = enb_dl_gen_signal(grid, self.cell).cpu().numpy()
        if self.cell.nof_ports == 1:
            return sig[0]
        return sig                    # [P, sf_len]: the air combines
