"""RRC connection procedures: UE and eNB state machines over the codecs.

Capability parity with srsue/src/upper/rrc.cc (connection establishment,
NAS transport, AS security activation, reconfiguration, measurement
reporting, handover) and srsenb/src/upper/rrc.cc (the eNB peer). NAS
PDUs ride inside RRC exactly as in the reference (SetupComplete /
UL/DLInformationTransfer); the MME is the epc.Mme attach state machine.

Transport is message-level: each endpoint consumes/produces
(srb_id, pdu_bytes) pairs, so tests can run them back-to-back or through
real RLC/PDCP entities. SRB1/SRB2 signalling is integrity-protected with
the PDCP entity once AS security activates (K_eNB -> K_RRCint per 33.401).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..upper import security
from ..upper.pdcp import PdcpConfig, PdcpEntity
from . import messages as M

SRB0, SRB1, SRB2 = 0, 1, 2


def short_mac_i(k_rrc_int: bytes, cell_identity: int, pci: int,
                c_rnti: int) -> int:
    """VarShortMAC-Input MAC (36.331 5.3.7.4): EIA2 over the UPER-packed
    (cellIdentity, physCellId, c-RNTI) with COUNT/BEARER/DIRECTION all
    ones; 16 LSBs."""
    from .per import BitWriter

    w = BitWriter()
    w.put(cell_identity, 28)
    w.put(pci, 9)
    w.put(c_rnti, 16)
    mac = security.eia2(k_rrc_int, 0xFFFFFFFF, 0x1F, 1, w.to_bytes())
    return int.from_bytes(mac[2:4], "big")

_DEFAULT_SRB1 = {
    "srb_identity": 1,
    "rlc_config": ("explicitValue", ("am", {
        "ul_am_rlc": {"t_poll_retransmit": 10, "poll_pdu": 0,
                      "poll_byte": 14, "max_retx_threshold": 3},
        "dl_am_rlc": {"t_reordering": 7, "t_status_prohibit": 0}})),
    "logical_channel_config": ("defaultValue", None),
}

_DEFAULT_DRB1 = {
    "eps_bearer_identity": 5,
    "drb_identity": 1,
    "pdcp_config": {"discard_timer": 2,
                    "rlc_um": {"pdcp_sn_size": 1},
                    "header_compression": ("notUsed", None)},
    "rlc_config": ("um_bi_directional", {
        "ul_um_rlc": {"sn_field_length": 1},
        "dl_um_rlc": {"sn_field_length": 1, "t_reordering": 7}}),
    "logical_channel_identity": 3,
    "logical_channel_config": {"ul_specific_parameters": {
        "priority": 13, "prioritised_bit_rate": 0,
        "bucket_size_duration": 2, "logical_channel_group": 2}},
}

_DEFAULT_MEAS = {
    "meas_object_to_add_mod_list": [
        {"meas_object_id": 1, "meas_object": ("measObjectEUTRA", {
            "carrier_freq": 3400, "allowed_meas_bandwidth": 3,
            "presence_antenna_port1": True, "neigh_cell_config": 1})}],
    "report_config_to_add_mod_list": [
        {"report_config_id": 1, "report_config": ("reportConfigEUTRA", {
            "trigger_type": ("event", {
                "event_id": ("eventA3", {"a3_offset": 6,
                                         "report_on_leave": False}),
                "hysteresis": 0, "time_to_trigger": 0}),
            "trigger_quantity": 0, "report_quantity": 1,
            "max_report_cells": 4, "report_interval": 0,
            "report_amount": 7})}],
    "meas_id_to_add_mod_list": [
        {"meas_id": 1, "meas_object_id": 1, "report_config_id": 1}],
}


def _srb_pdcp(k_rrc_int: bytes, k_rrc_enc: bytes) -> PdcpConfig:
    return PdcpConfig(is_control=True, bearer_id=1, cipher="eea0",
                      integrity="eia2", key_enc=k_rrc_enc,
                      key_int=k_rrc_int)


@dataclass
class UeRrc:
    """srsue rrc.cc analog: IDLE -> CONNECTED with AS security."""

    nas: object                          # epc.mme.UeNas
    state: str = "idle"
    c_rnti: int = 0
    transaction_id: int = 0
    srb1_pdcp_tx: PdcpEntity | None = None
    srb1_pdcp_rx: PdcpEntity | None = None
    security_activated: bool = False
    k_enb: bytes = b""
    k_enb_initial: bytes = b""
    nh: bytes = b""
    ncc: int = 0
    meas_config: dict | None = None
    drbs: list = field(default_factory=list)
    serving_pci: int = 0
    events: list = field(default_factory=list)
    #: dedicated PUCCH resources from PhysicalConfigDedicated
    sr_cfg: dict | None = None
    cqi_cfg: dict | None = None
    ri_cfg: dict | None = None
    #: pending handover execution (mobilityControlInfo) for the stack
    ho_info: dict | None = None

    # --- connection establishment -------------------------------------------

    def reestablish(self, cell_identity: int = 0,
                    cause: str = "otherFailure") -> tuple[int, bytes]:
        """Radio-link-failure recovery (36.331 5.3.7; srsue rrc.cc
        reestablishment): -> (SRB0, RRCConnectionReestablishmentRequest)
        carrying (C-RNTI, PCI, shortMAC-I)."""
        causes = {"reconfigurationFailure": 0, "handoverFailure": 1,
                  "otherFailure": 2, "spare1": 3}
        _, k_rrc_int = security.generate_k_rrc(self.k_enb, 0, 2)
        mac = short_mac_i(k_rrc_int, cell_identity, self.serving_pci,
                          self.c_rnti)
        msg = {"critical_extensions": ("r8", {
            "ue_identity": {"c_rnti": self.c_rnti,
                            "phys_cell_id": self.serving_pci,
                            "short_mac_i": mac},
            "reestablishment_cause": causes[cause], "spare": 0})}
        self.state = "reestablishing"
        return SRB0, M.pack_ul_ccch("rrcConnectionReestablishmentRequest",
                                    msg)

    def connect(self, cause: str = "mo_Signalling") -> tuple[int, bytes]:
        """-> (SRB0, RRCConnectionRequest)."""
        import os
        msg = {"critical_extensions": ("r8", {
            "ue_identity": ("randomValue",
                            int.from_bytes(os.urandom(5), "big")),
            "establishment_cause": cause, "spare": 0})}
        self.state = "connecting"
        return SRB0, M.pack_ul_ccch("rrcConnectionRequest", msg)

    def handle_dl(self, srb: int, pdu: bytes) -> list[tuple[int, bytes]]:
        """Process one DL message; returns UL (srb, pdu) responses."""
        if srb == SRB0:
            return self._handle_dl_ccch(pdu)
        if self.security_activated:
            body = self.srb1_pdcp_rx.write_pdu(pdu, direction=1)
            if body is None:
                self.events.append("integrity_failure")
                return []
            pdu = body
        return self._handle_dl_dcch(pdu)

    def _handle_dl_ccch(self, pdu: bytes) -> list[tuple[int, bytes]]:
        name, v = M.unpack_dl_ccch(pdu)
        if name == "rrcConnectionReestablishment" \
                and self.state == "reestablishing":
            r8 = v["critical_extensions"][1][1]
            ncc = r8["next_hop_chaining_count"]
            # vertical key derivation on reestablishment (33.401 7.2.8):
            # K_eNB* from the current K_eNB and the serving cell
            self.k_enb = security.generate_k_enb_star(
                self.k_enb, self.serving_pci, 3400)
            k_rrc_enc, k_rrc_int = security.generate_k_rrc(self.k_enb, 0, 2)
            self.srb1_pdcp_tx = PdcpEntity(_srb_pdcp(k_rrc_int, k_rrc_enc))
            self.srb1_pdcp_rx = PdcpEntity(_srb_pdcp(k_rrc_int, k_rrc_enc))
            self.state = "connected"
            self.security_activated = True
            self.events.append(f"reestablished_ncc{ncc}")
            msg = {"rrc_transaction_identifier":
                   v["rrc_transaction_identifier"],
                   "critical_extensions": ("r8", {})}
            return [self._ul(SRB1, M.pack_ul_dcch(
                "rrcConnectionReestablishmentComplete", msg))]
        if name == "rrcConnectionSetup" and self.state == "connecting":
            self.state = "connected"
            self.events.append("connection_setup")
            r8s = v["critical_extensions"][1][1]
            self._apply_phys_cfg((r8s.get("radio_resource_config_dedicated")
                                  or {}).get("physical_config_dedicated"))
            msg = {"rrc_transaction_identifier":
                   v["rrc_transaction_identifier"],
                   "critical_extensions": ("c1", ("r8", {
                       "selected_plmn_identity": 1,
                       # ECM-idle with a registered context re-activates
                       # via Service Request; a pending T3412 expiry
                       # sends the periodic TAU instead; else Attach
                       "dedicated_info_nas":
                           self.nas.tau_request()
                           if getattr(self.nas, "pending_tau", False)
                           else self.nas.service_request()
                           if getattr(self.nas, "attached", False)
                           else self.nas.attach_request()}))}
            return [(SRB1,
                     M.pack_ul_dcch("rrcConnectionSetupComplete", msg))]
        if name == "rrcConnectionReject":
            self.state = "idle"
            self.events.append("connection_reject")
        return []

    def _apply_phys_cfg(self, phys: dict | None) -> None:
        """PhysicalConfigDedicated -> SR/CQI occasion configs (36.213
        Tables 10.1-5 and 7.2.2-1A index mappings)."""
        if not phys:
            return
        src = phys.get("scheduling_request_config")
        if src and src[0] == "setup":
            s = src[1]
            i = s["sr_config_index"]
            period, off = (5, i) if i < 5 else (10, i - 5)
            self.sr_cfg = dict(
                n_pucch=s["sr_pucch_resource_index"], period=period,
                subframe=off,
                dsr_trans_max=(4, 8, 16, 32, 64)[
                    min(s["dsr_trans_max"], 4)])
            self.events.append("sr_configured")
        crc = phys.get("cqi_report_config") or {}
        crp = crc.get("cqi_report_periodic")
        if crp and crp[0] == "setup":
            i = crp[1]["cqi_pmi_config_index"]
            if i < 2:
                period, off = 2, i
            elif i < 7:
                period, off = 5, i - 2
            else:
                period, off = 10, i - 7
            self.cqi_cfg = dict(
                n_pucch=crp[1]["cqi_pucch_resource_index"],
                period=period, subframe=off)
            self.events.append("cqi_configured")
            # periodic RI (36.213 7.2.2 Table 7.2.2-1B): interval
            # M_ri * N_pd; an RI occasion replaces the CQI report
            # (phch_worker.cc:1086 uci_data.uci_ri path)
            iri = crp[1].get("ri_config_index")
            if iri is not None:
                if iri <= 160:
                    m_ri, noff = 1, -iri
                elif iri <= 321:
                    m_ri, noff = 2, -(iri - 161)
                elif iri <= 482:
                    m_ri, noff = 4, -(iri - 322)
                else:
                    m_ri, noff = 8, -(iri - 483)
                p_ri = period * m_ri
                self.ri_cfg = dict(
                    n_pucch=crp[1]["cqi_pucch_resource_index"],
                    period=p_ri, subframe=(off + noff) % p_ri)
                self.events.append("ri_configured")

    def _handle_dl_dcch(self, pdu: bytes) -> list[tuple[int, bytes]]:
        name, v = M.unpack_dl_dcch(pdu)
        r8 = v["critical_extensions"][1][1] if name != "dlInformationTransfer" \
            else v["critical_extensions"][1][1]
        out: list[tuple[int, bytes]] = []
        if name == "dlInformationTransfer":
            nas_pdu = r8["dedicated_info_type"][1]
            resp = self.nas.handle_dl_nas(nas_pdu)
            if resp is not None:
                msg = {"critical_extensions": ("c1", ("r8", {
                    "dedicated_info_type": ("dedicatedInfoNAS", resp)}))}
                out.append(self._ul(SRB1, M.pack_ul_dcch(
                    "ulInformationTransfer", msg)))
        elif name == "securityModeCommand":
            # derive AS keys (33.401 A.3/A.7); NAS uplink count 0 as in
            # the initial-attach K_eNB derivation
            self.k_enb = security.generate_k_enb(self.nas.kasme, 0)
            self.k_enb_initial = self.k_enb
            self.nh, self.ncc = b"", 0
            k_rrc_enc, k_rrc_int = security.generate_k_rrc(self.k_enb, 0, 2)
            self.srb1_pdcp_tx = PdcpEntity(_srb_pdcp(k_rrc_int, k_rrc_enc))
            self.srb1_pdcp_rx = PdcpEntity(_srb_pdcp(k_rrc_int, k_rrc_enc))
            msg = {"rrc_transaction_identifier":
                   v["rrc_transaction_identifier"],
                   "critical_extensions": ("r8", {})}
            raw = M.pack_ul_dcch("securityModeComplete", msg)
            # the complete is the first integrity-protected message
            self.security_activated = True
            self.events.append("security_activated")
            out.append(self._ul(SRB1, raw, force_protect=True))
        elif name == "rrcConnectionReconfiguration":
            if r8.get("radio_resource_config_dedicated"):
                rrd = r8["radio_resource_config_dedicated"]
                for drb in rrd.get("drb_to_add_mod_list") or []:
                    self.drbs.append(drb["drb_identity"])
                    self.events.append(f"drb{drb['drb_identity']}_setup")
            if r8.get("meas_config"):
                self.meas_config = r8["meas_config"]
                self.events.append("meas_configured")
            if r8.get("mobility_control_info"):
                mci = r8["mobility_control_info"]
                self.serving_pci = mci["target_pci"]
                self.c_rnti = mci["new_ue_identity"]
                # handover key derivation (33.401 A.5): horizontal from
                # the current K_eNB, or vertical through the NH chain
                # when securityConfigHO advances the NCC (S1 handover,
                # 33.401 7.2.8.4.3)
                sch = r8.get("security_config_ho")
                ncc = None
                if sch is not None and sch["handover_type"][0] == "intraLTE":
                    ncc = sch["handover_type"][1]["next_hop_chaining_count"]
                if ncc is not None and ncc > self.ncc:
                    while self.ncc < ncc:
                        self.nh = security.generate_nh(
                            self.nas.kasme, self.nh or self.k_enb_initial)
                        self.ncc += 1
                    self.k_enb = self.nh
                    self.events.append(f"nh_chain_ncc{ncc}")
                self.k_enb = security.generate_k_enb_star(
                    self.k_enb, mci["target_pci"], 3400)
                k_rrc_enc, k_rrc_int = security.generate_k_rrc(
                    self.k_enb, 0, 2)
                self.srb1_pdcp_tx = PdcpEntity(
                    _srb_pdcp(k_rrc_int, k_rrc_enc))
                self.srb1_pdcp_rx = PdcpEntity(
                    _srb_pdcp(k_rrc_int, k_rrc_enc))
                self.events.append(f"handover_to_{mci['target_pci']}")
                # execution info for the PHY/MAC stack (36.331 5.3.5.4:
                # T304, retune, dedicated RA at the target)
                self.ho_info = {
                    "pci": mci["target_pci"],
                    "rnti": mci["new_ue_identity"],
                    "preamble": (mci.get("rach_config_dedicated")
                                 or {}).get("ra_preamble_index", 4),
                    "rsi": (mci.get("radio_resource_config_common")
                            or {}).get("prach_config", {}).get(
                                "root_sequence_index", 128)}
            for nas_pdu in r8.get("dedicated_info_nas_list") or []:
                resp = self.nas.handle_dl_nas(nas_pdu)
                if resp is not None:
                    msg = {"critical_extensions": ("c1", ("r8", {
                        "dedicated_info_type": ("dedicatedInfoNAS",
                                                resp)}))}
                    out.append(self._ul(SRB1, M.pack_ul_dcch(
                        "ulInformationTransfer", msg)))
            msg = {"rrc_transaction_identifier":
                   v["rrc_transaction_identifier"],
                   "critical_extensions": ("r8", {})}
            comp = self._ul(SRB1, M.pack_ul_dcch(
                "rrcConnectionReconfigurationComplete", msg))
            if self.ho_info is not None and "complete" not in self.ho_info:
                # 36.331 5.3.5.4: the complete is submitted to lower
                # layers only after random access at the TARGET; the
                # stack seeds the re-established RLC with it
                self.ho_info["complete"] = comp[1]
            out.append(comp)
        elif name == "ueCapabilityEnquiry":
            caps = M.pack_eutra_capability({
                "access_stratum_release": 0,        # rel8
                "ue_category": 4,
                "pdcp_parameters": {"supported_rohc_profiles": {
                    p: False for p in (
                        "profile0x0001", "profile0x0002", "profile0x0003",
                        "profile0x0004", "profile0x0006", "profile0x0101",
                        "profile0x0102", "profile0x0103",
                        "profile0x0104")}},
                "phy_layer_parameters": {
                    "ue_tx_antenna_selection_supported": False,
                    "ue_specific_ref_sigs_supported": False},
                "rf_parameters": {"supported_band_list_eutra": [
                    {"band_eutra": 7, "half_duplex": False}]},
                "meas_parameters": {"band_list_eutra": [
                    {"inter_freq_band_list": [
                        {"inter_freq_need_for_gaps": True}]}]},
                "inter_rat_parameters": {}})
            msg = {"rrc_transaction_identifier":
                   v["rrc_transaction_identifier"],
                   "critical_extensions": ("c1", ("r8", {
                       "ue_capability_rat_container_list": [
                           {"rat_type": "eutra",
                            "ue_capability_rat_container": caps}]}))}
            out.append(self._ul(SRB1, M.pack_ul_dcch(
                "ueCapabilityInformation", msg)))
            self.events.append("capability_sent")
        elif name == "rrcConnectionRelease":
            self.state = "idle"
            self.security_activated = False
            self.drbs.clear()
            self.sr_cfg = None
            self.cqi_cfg = None
            self.ri_cfg = None
            self.events.append("released")
        return out

    def send_measurement_report(self, rsrp: int, rsrq: int,
                                neigh: list[tuple[int, int, int]]
                                ) -> tuple[int, bytes]:
        """neigh: [(pci, rsrp, rsrq)]; -> protected SRB1 PDU."""
        cells = [{"phys_cell_id": pci,
                  "meas_result": {"rsrp_result": p, "rsrq_result": q}}
                 for pci, p, q in neigh]
        mr = {"critical_extensions": ("c1", ("r8", {"meas_results": {
            "meas_id": 1,
            "meas_result_pcell": {"rsrp_result": rsrp, "rsrq_result": rsrq},
            "meas_result_neigh_cells": ("measResultListEUTRA", cells)
            if cells else None}}))}
        return self._ul(SRB1, M.pack_ul_dcch("measurementReport", mr))

    def _ul(self, srb: int, raw: bytes,
            force_protect: bool = False) -> tuple[int, bytes]:
        if (self.security_activated or force_protect) and srb != SRB0:
            return srb, self.srb1_pdcp_tx.write_sdu(raw, direction=0)
        return srb, raw

    def send_ul_nas(self, nas_pdu: bytes) -> tuple[int, bytes]:
        """NAS-initiated uplink (srsue rrc.cc write_sdu ->
        ULInformationTransfer), e.g. T3411 attach retries or TAU."""
        msg = {"critical_extensions": ("c1", ("r8", {
            "dedicated_info_type": ("dedicatedInfoNAS", nas_pdu)}))}
        return self._ul(SRB1, M.pack_ul_dcch("ulInformationTransfer", msg))


@dataclass
class EnbRrc:
    """srsenb rrc.cc analog: per-UE connection handling + NAS relay."""

    mme: object                          # epc.mme.Mme
    next_c_rnti: int = 0x46
    ues: dict = field(default_factory=dict)
    handover_margin_db: int = 3
    events: list = field(default_factory=list)
    pci: int = 1
    #: neighbour PCIs served by *other* eNBs: pci -> global eNB id.
    #: A3 winners found here hand over via S1 instead of intra-eNB.
    neighbor_enbs: dict = field(default_factory=dict)

    def handle_ul(self, rnti: int, srb: int,
                  pdu: bytes) -> list[tuple[int, int, bytes]]:
        """-> list of (rnti, srb, pdu) downlink messages."""
        if srb == SRB0:
            return self._handle_ul_ccch(pdu)
        ue = self.ues[rnti]
        if ue["security_activated"] or ue.get("smc_pending"):
            # after sending SecurityModeCommand the next UL message (the
            # complete) is already integrity-protected (36.331 5.3.4.3)
            body = ue["pdcp_rx"].write_pdu(pdu, direction=0)
            if body is None:
                self.events.append("integrity_failure")
                return []
            pdu = body
        return self._handle_ul_dcch(rnti, pdu)

    def _handle_ul_ccch(self, pdu: bytes):
        name, v = M.unpack_ul_ccch(pdu)
        if name == "rrcConnectionReestablishmentRequest":
            return self._handle_reestablishment(v)
        if name != "rrcConnectionRequest":
            return []
        rnti = self.next_c_rnti
        self.next_c_rnti += 1
        # dedicated PUCCH resources (36.331 PhysicalConfigDedicated):
        # sr-ConfigIndex 5..14 = period 10 / offset I-5 (36.213
        # Table 10.1-5), cqi-pmi-ConfigIndex 7..16 = period 10 /
        # offset I-7 (Table 7.2.2-1A); indexes stride per UE
        ue_ix = len(self.ues)
        phys = {
            "scheduling_request_config": ("setup", {
                "sr_pucch_resource_index": ue_ix,
                "sr_config_index": 5 + (2 * ue_ix) % 10,
                "dsr_trans_max": 2}),          # enum idx 2 = n16
            "cqi_report_config": {
                "nom_pdsch_rs_epre_offset": 0,
                "cqi_report_periodic": ("setup", {
                    "cqi_pucch_resource_index": ue_ix,
                    "cqi_pmi_config_index": 7 + (2 * ue_ix + 4) % 10,
                    # I_ri 322 -> M_ri = 4 (36.213 Table 7.2.2-1B):
                    # every 4th CQI occasion carries RI instead
                    "ri_config_index": 322,
                    "cqi_format_indicator_periodic": ("widebandCQI",
                                                      None),
                    "simultaneous_ack_nack_and_cqi": False})},
        }
        self.ues[rnti] = {"state": "setup", "security_activated": False,
                          "pdcp_tx": None, "pdcp_rx": None, "tid": 0,
                          "sr_n_pucch": ue_ix,
                          "sr_subframe": (2 * ue_ix) % 10,
                          "cqi_n_pucch": ue_ix,
                          "cqi_subframe": (2 * ue_ix + 4) % 10,
                          "ri_period": 40,
                          "ri_subframe": (2 * ue_ix + 4) % 10}
        self.events.append(f"connection_request_{rnti:#x}")
        msg = {"rrc_transaction_identifier": 0,
               "critical_extensions": ("c1", ("r8", {
                   "radio_resource_config_dedicated": {
                       "srb_to_add_mod_list": [_DEFAULT_SRB1],
                       "physical_config_dedicated": phys}}))}
        return [(rnti, SRB0, M.pack_dl_ccch("rrcConnectionSetup", msg))]

    def _handle_ul_dcch(self, rnti: int, pdu: bytes):
        ue = self.ues[rnti]
        name, v = M.unpack_ul_dcch(pdu)
        out = []
        if name == "rrcConnectionSetupComplete":
            ue["state"] = "connected"
            nas_pdu = v["critical_extensions"][1][1]["dedicated_info_nas"]
            out.extend(self._apply_directives(
                rnti, ue, self._mme_iface().initial_ue(nas_pdu,
                                                       enb_teid=rnti)))
        elif name == "ulInformationTransfer":
            nas_pdu = v["critical_extensions"][1][1][
                "dedicated_info_type"][1]
            out.extend(self._apply_directives(
                rnti, ue, self._mme_iface().ul_nas(nas_pdu,
                                                   enb_teid=rnti)))
        elif name == "securityModeComplete":
            # first protected message: validated with the derived keys
            ue["smc_pending"] = False
            ue["security_activated"] = True
            self.events.append("as_security_activated")
            out.append((rnti, SRB1, self._protect(ue, self._reconfig(ue))))
        elif name == "rrcConnectionReconfigurationComplete":
            ue["state"] = "reconfigured"
            self.events.append("reconfig_complete")
        elif name == "ueCapabilityInformation":
            conts = v["critical_extensions"][1][1][
                "ue_capability_rat_container_list"]
            for c in conts:
                if c["rat_type"] == "eutra":
                    ue["eutra_capability"] = M.unpack_eutra_capability(
                        c["ue_capability_rat_container"])
                    self.events.append(
                        f"ue_cat{ue['eutra_capability']['ue_category']}")
                    # forward to the MME over S1 (srsenb
                    # send_ue_capabilities, s1ap.cc)
                    iface = self._mme_iface()
                    if hasattr(iface, "ue_capabilities"):
                        iface.ue_capabilities(
                            c["ue_capability_rat_container"])
        elif name == "measurementReport":
            mr = v["critical_extensions"][1][1]["meas_results"]
            serving = mr["meas_result_pcell"]["rsrp_result"]
            neigh = mr.get("meas_result_neigh_cells")
            if neigh is not None:
                for cell in neigh[1]:
                    n_rsrp = cell["meas_result"]["rsrp_result"]
                    if n_rsrp >= serving + 2 * self.handover_margin_db:
                        pci = cell["phys_cell_id"]
                        self.events.append(f"handover_decision_{pci}")
                        iface = self._mme_iface()
                        if pci in self.neighbor_enbs \
                                and hasattr(iface, "handover_required"):
                            # inter-eNB: S1 handover (36.413 8.4); the
                            # target builds the RRC command, the source
                            # only protects and forwards it
                            prep = M.pack_handover_prep_info(
                                source_pci=self.pci, old_c_rnti=rnti,
                                ue_category=(ue.get("eutra_capability")
                                             or {}).get("ue_category", 4))
                            for d in iface.handover_required(
                                    self.neighbor_enbs[pci], prep):
                                if d[0] == "handover_command":
                                    self.events.append("s1_handover_cmd")
                                    out.append((rnti, SRB1, self._protect(
                                        ue, d[1])))
                        else:
                            out.append((rnti, SRB1, self._protect(
                                ue, self._handover_command(ue, pci))))
                        break
        return out

    def _handle_reestablishment(self, v):
        """srsenb rrc.cc reestablishment: validate shortMAC-I against the
        stored context, re-key, answer with SRB1 config + NCC."""
        r8 = v["critical_extensions"][1]
        ident = r8["ue_identity"]
        rnti = ident["c_rnti"]
        ue = self.ues.get(rnti)
        if ue is None or "k_enb" not in ue:
            self.events.append("reestablishment_unknown_ue")
            return []   # srsenb sends a reject; we drop
        _, k_rrc_int = security.generate_k_rrc(ue["k_enb"], 0, 2)
        expected = short_mac_i(k_rrc_int, 0, ident["phys_cell_id"], rnti)
        if ident["short_mac_i"] != expected:
            self.events.append("reestablishment_bad_mac")
            return []
        ue["k_enb"] = security.generate_k_enb_star(
            ue["k_enb"], ident["phys_cell_id"], 3400)
        k_rrc_enc, k_rrc_int = security.generate_k_rrc(ue["k_enb"], 0, 2)
        ue["pdcp_tx"] = PdcpEntity(_srb_pdcp(k_rrc_int, k_rrc_enc))
        ue["pdcp_rx"] = PdcpEntity(_srb_pdcp(k_rrc_int, k_rrc_enc))
        ue["security_activated"] = True
        # The reestablishing UE arrived through a fresh random access, so
        # its context migrates to the new C-RNTI (srsenb rrc.cc moves the
        # user context on reestablishment); the reply is addressed there.
        new_rnti = self.next_c_rnti
        self.next_c_rnti += 1
        self.ues[new_rnti] = self.ues.pop(rnti)
        self.events.append("reestablishment_ok")
        self.events.append(f"reestablish_migrated_{rnti:#x}_{new_rnti:#x}")
        msg = {"rrc_transaction_identifier": 0,
               "critical_extensions": ("c1", ("r8", {
                   "radio_resource_config_dedicated": {
                       "srb_to_add_mod_list": [_DEFAULT_SRB1]},
                   "next_hop_chaining_count": 1}))}
        return [(new_rnti, SRB0,
                 M.pack_dl_ccch("rrcConnectionReestablishment", msg))]

    # --- message builders -----------------------------------------------------

    def _dl_info_transfer(self, ue, nas_pdu: bytes) -> bytes:
        ue["tid"] = (ue["tid"] + 1) % 4
        msg = {"rrc_transaction_identifier": ue["tid"],
               "critical_extensions": ("c1", ("r8", {
                   "dedicated_info_type": ("dedicatedInfoNAS", nas_pdu)}))}
        raw = M.pack_dl_dcch("dlInformationTransfer", msg)
        return self._protect(ue, raw) if ue["security_activated"] else raw

    def _apply_directives(self, rnti, ue, directives) -> list:
        """Map MME directives (direct adapter or S1AP client) to DL
        messages: dl_nas -> DLInformationTransfer; ctx_setup (the
        InitialContextSetupRequest carrying K_eNB + attach accept) ->
        AS SecurityModeCommand, accept deferred to the reconfiguration."""
        out = []
        for d in directives:
            if d[0] == "dl_nas":
                out.append((rnti, SRB1, self._dl_info_transfer(ue, d[1])))
            elif d[0] == "ctx_setup":
                _, k_enb, nas_pdu = d[:3]
                ue["pending_nas"] = nas_pdu
                ue["k_enb"] = k_enb
                if len(d) > 3:
                    # S1-U uplink TEID for the default E-RAB (36.413
                    # InitialContextSetup E-RABToBeSetupItem)
                    ue["spgw_teid"] = d[3]
                out.append((rnti, SRB1, self._security_mode_command(ue)))
            elif d[0] == "release":
                ue["state"] = "idle"
        return out

    def _mme_iface(self):
        """Accept either a raw epc.Mme (wrapped in the direct adapter) or
        an object already exposing initial_ue/ul_nas (EnbS1ap)."""
        if hasattr(self.mme, "initial_ue"):
            return self.mme
        from ..s1ap.procedures import DirectMmeAdapter

        if not hasattr(self, "_adapter"):
            self._adapter = DirectMmeAdapter(self.mme)
        return self._adapter

    def _security_mode_command(self, ue) -> bytes:
        k_enb = ue.get("k_enb") or security.generate_k_enb(ue["kasme"], 0)
        k_rrc_enc, k_rrc_int = security.generate_k_rrc(k_enb, 0, 2)
        ue["k_enb"] = k_enb
        ue["pdcp_tx"] = PdcpEntity(_srb_pdcp(k_rrc_int, k_rrc_enc))
        ue["pdcp_rx"] = PdcpEntity(_srb_pdcp(k_rrc_int, k_rrc_enc))
        ue["smc_pending"] = True
        msg = {"rrc_transaction_identifier": 1,
               "critical_extensions": ("c1", ("r8", {
                   "security_config_smc": {"security_algorithm_config": {
                       "ciphering_algorithm": "eea0",
                       "integrity_prot_algorithm": "eia2"}}}))}
        return M.pack_dl_dcch("securityModeCommand", msg)

    def release_connection(self, rnti: int) -> tuple[int, int, bytes]:
        """-> (rnti, srb, pdu) RRCConnectionRelease (36.331 5.3.8); the
        UE context transitions to idle (rrc.cc rem_user path)."""
        ue = self.ues[rnti]
        msg = {"rrc_transaction_identifier": 0,
               "critical_extensions": ("c1", ("r8", {
                   "release_cause": 0}))}
        raw = M.pack_dl_dcch("rrcConnectionRelease", msg)
        if ue["security_activated"]:
            raw = self._protect(ue, raw)
        ue["state"] = "released"
        self.events.append(f"release_sent_{rnti:#x}")
        return rnti, SRB1, raw

    def send_capability_enquiry(self, rnti: int) -> tuple[int, int, bytes]:
        """-> (rnti, srb, pdu) UECapabilityEnquiry for EUTRA."""
        ue = self.ues[rnti]
        msg = {"rrc_transaction_identifier": 3,
               "critical_extensions": ("c1", ("r8", {
                   "ue_capability_request": [0]}))}   # 0 = eutra
        raw = M.pack_dl_dcch("ueCapabilityEnquiry", msg)
        if ue["security_activated"]:
            raw = self._protect(ue, raw)
        return rnti, SRB1, raw

    def _reconfig(self, ue) -> bytes:
        nas_list = [ue.pop("pending_nas")] if ue.get("pending_nas") else None
        msg = {"rrc_transaction_identifier": 2,
               "critical_extensions": ("c1", ("r8", {
                   "meas_config": _DEFAULT_MEAS,
                   "dedicated_info_nas_list": nas_list,
                   "radio_resource_config_dedicated": {
                       "drb_to_add_mod_list": [_DEFAULT_DRB1]}}))}
        return M.pack_dl_dcch("rrcConnectionReconfiguration", msg)

    def prepare_handover(self, req: dict) -> bytes:
        """Target-side S1 handover admission (36.413 HandoverRequest ->
        36.331 10.2.3): allocate a C-RNTI, derive K_eNB* from the MME's
        fresh {NH, NCC} (33.401 7.2.8.4.3), install the UE context with
        the new AS keys, and return the RRCConnectionReconfiguration-
        with-mobilityControlInfo for the target-to-source container."""
        info = M.unpack_handover_prep_info(req["container"]) \
            if req.get("container") else {}
        rnti = self.next_c_rnti
        self.next_c_rnti += 1
        k_enb = security.generate_k_enb_star(req["nh"], self.pci, 3400)
        k_rrc_enc, k_rrc_int = security.generate_k_rrc(k_enb, 0, 2)
        self.ues[rnti] = {
            "state": "handover_pending", "k_enb": k_enb,
            "security_activated": True, "kasme": b"",
            "eutra_capability": {"ue_category":
                                 info.get("ue_category", 4)},
            "pdcp_tx": PdcpEntity(_srb_pdcp(k_rrc_int, k_rrc_enc)),
            "pdcp_rx": PdcpEntity(_srb_pdcp(k_rrc_int, k_rrc_enc)),
        }
        self.events.append(f"ho_admitted_{rnti:#x}")
        return self._mobility_reconfig(rnti, self.pci, ncc=req["ncc"])

    def _handover_command(self, ue, target_pci: int) -> bytes:
        new_rnti = self.next_c_rnti
        self.next_c_rnti += 1
        return self._mobility_reconfig(new_rnti, target_pci)

    def _mobility_reconfig(self, new_rnti: int, target_pci: int,
                           ncc: int | None = None) -> bytes:
        mci = {"target_pci": target_pci, "t304": 4,
               "new_ue_identity": new_rnti,
               "radio_resource_config_common": {
                   "prach_config": {"root_sequence_index":
                                    getattr(self, "rsi", 128)},
                   "pusch_config_common": {
                       "pusch_config_basic": {
                           "n_sb": 1, "hopping_mode": 0,
                           "pusch_hopping_offset": 2,
                           "enable_64qam": False},
                       "ul_reference_signals_pusch": {
                           "group_hopping_enabled": False,
                           "group_assignment_pusch": 0,
                           "sequence_hopping_enabled": False,
                           "cyclic_shift": 0}},
                   "ul_cyclic_prefix_length": 0},
               "rach_config_dedicated": {"ra_preamble_index": 4,
                                         "ra_prach_mask_index": 0}}
        r8 = {"mobility_control_info": mci}
        if ncc is not None:
            r8["security_config_ho"] = {"handover_type": ("intraLTE", {
                "key_change_indicator": False,
                "next_hop_chaining_count": ncc})}
        msg = {"rrc_transaction_identifier": 3,
               "critical_extensions": ("c1", ("r8", r8))}
        return M.pack_dl_dcch("rrcConnectionReconfiguration", msg)

    def _protect(self, ue, raw: bytes) -> bytes:
        return ue["pdcp_tx"].write_sdu(raw, direction=1)


