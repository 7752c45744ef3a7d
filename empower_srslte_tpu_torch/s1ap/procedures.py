"""S1AP endpoints: eNB client and MME server over the 36.413 codecs.

Capability parity with srsenb/src/upper/s1ap.cc (S1 setup, initial UE
message, UL NAS, initial context setup handling) and
srsepc/src/mme/s1ap*.cc (the server side: s1ap_mngmt_proc,
s1ap_nas_transport, s1ap_ctx_mngmt_proc). The MME side drives the same
epc.Mme attach state machine used by the direct path; the wire format
is real S1AP bytes, transported in-memory or over a socket
(transport.py — the reference uses SCTP, we frame over TCP when SCTP
is unavailable).

The eNB side presents the MME-interface consumed by rrc.procedures:
  initial_ue(nas) / ul_nas(nas) -> [directives]
where directives are ("dl_nas", pdu) | ("ctx_setup", k_enb, nas_pdu,
spgw_teid)
| ("release",).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..upper import security
from . import messages as S


class DirectMmeAdapter:
    """In-process adapter presenting the directive interface over a plain
    epc.Mme (no S1AP wire) — the pre-S1AP behavior."""

    def __init__(self, mme):
        self.mme = mme

    def initial_ue(self, nas_pdu: bytes, enb_teid: int = 0):
        return self._directives(self.mme.handle_ul_nas(nas_pdu, enb_teid))

    def ul_nas(self, nas_pdu: bytes, enb_teid: int = 0):
        return self._directives(self.mme.handle_ul_nas(nas_pdu, enb_teid))

    def _directives(self, resp):
        ctx = getattr(self.mme, "last_ctx", None)
        if ctx is not None and getattr(ctx, "pending_ctx_setup", False) \
                and resp is not None:
            ctx.pending_ctx_setup = False
            k_enb = security.generate_k_enb(ctx.kasme, 0)
            return [("ctx_setup", k_enb, resp, ctx.spgw_teid)]
        if resp is not None:
            return [("dl_nas", resp)]
        return []


@dataclass
class MmeS1ap:
    """srsepc s1ap.cc analog: decodes S1AP, drives epc.Mme, encodes
    responses. `handle(pdu) -> [response pdus]`."""

    mme: object
    mcc: str = "001"
    mnc: str = "01"
    mme_name: str = "tpu-mme"
    next_mme_ue_id: int = 1
    ue_ids: dict = field(default_factory=dict)    # enb_ue_id -> mme_ue_id
    enbs: list = field(default_factory=list)
    events: list = field(default_factory=list)
    ue_capabilities: dict = field(default_factory=dict)
    enb_links: dict = field(default_factory=dict)

    def handle(self, pdu: bytes) -> list[bytes]:
        kind, proc, ies = S.unpack_pdu(pdu)
        if proc == S.PROC_S1_SETUP and kind == S.INITIATING:
            req = S.unpack_s1_setup_request(ies)
            self.enbs.append(req)
            self.events.append(f"s1_setup_{req['enb_name']}")
            return [S.pack_s1_setup_response(self.mme_name, self.mcc,
                                             self.mnc, 0x8001, 0x1A)]
        if proc == S.PROC_INITIAL_UE_MESSAGE:
            enb_ue = S.get_ue_ids(ies)[1]
            mme_ue = self.next_mme_ue_id
            self.next_mme_ue_id += 1
            self.ue_ids[enb_ue] = mme_ue
            return self._nas_response(enb_ue, S.get_nas(ies))
        if proc == S.PROC_UPLINK_NAS:
            enb_ue = S.get_ue_ids(ies)[1]
            return self._nas_response(enb_ue, S.get_nas(ies))
        if proc == S.PROC_INITIAL_CONTEXT_SETUP and kind == S.SUCCESSFUL:
            self.events.append("initial_ctx_setup_complete")
            return []
        if proc == S.PROC_INITIAL_CONTEXT_SETUP and kind == S.UNSUCCESSFUL:
            # srsepc releases the UE on setup failure
            mme_ue, enb_ue = S.get_ue_ids(ies)
            self.events.append("initial_ctx_setup_failure")
            return [S.pack_ue_context_release_command(mme_ue or 0,
                                                      enb_ue or 0)]
        if proc == S.PROC_UE_CONTEXT_RELEASE and kind == S.SUCCESSFUL:
            self.events.append("ue_context_released")
            return []
        if proc == S.PROC_UE_CONTEXT_RELEASE_REQUEST:
            mme_ue, enb_ue = S.get_ue_ids(ies)
            self.events.append("release_requested")
            return [S.pack_ue_context_release_command(mme_ue or 0,
                                                      enb_ue or 0)]
        if proc == S.PROC_UE_CAPABILITY_INFO_IND:
            mme_ue, enb_ue = S.get_ue_ids(ies)
            self.ue_capabilities[enb_ue] = S.get_ue_radio_capability(ies)
            self.events.append("ue_capabilities_stored")
            return []
        if proc == S.PROC_ERAB_SETUP and kind == S.SUCCESSFUL:
            res = S.unpack_erab_setup_response(ies)
            self.events.append(f"erab_setup_complete_{res['erab_id']}")
            return []
        if proc in (S.PROC_HANDOVER_PREPARATION, S.PROC_ENB_STATUS_TRANSFER,
                    S.PROC_HANDOVER_NOTIFICATION):
            return self._handle_handover(kind, proc, ies)
        if proc == S.PROC_RESET and kind == S.INITIATING:
            # eNB-initiated RESET (36.413 8.7.1.2.1): drop the named
            # contexts (or all) and acknowledge
            req = S.unpack_reset(ies)
            if req["reset_all"]:
                dropped = list(self.ue_ids)
                self.ue_ids.clear()
                self.events.append("reset_all")
                return [S.pack_reset_ack()]
            part = []
            for mme_ue, enb_ue in req["partial"]:
                match = [e for e, m in self.ue_ids.items()
                         if m == mme_ue or e == enb_ue]
                for e in match:
                    del self.ue_ids[e]
                part.append((mme_ue, enb_ue))
            self.events.append(f"reset_partial_{len(part)}")
            return [S.pack_reset_ack(partial=part)]
        if proc == S.PROC_RESET and kind == S.SUCCESSFUL:
            self.events.append("reset_acked")
            return []
        if proc == S.PROC_ERROR_INDICATION:
            err = S.unpack_error_indication(ies)
            self.events.append(f"error_indication_{err['cause']}")
            return []
        if proc == S.PROC_ERAB_RELEASE and kind == S.SUCCESSFUL:
            res = S.unpack_erab_release_response(ies)
            self.events.append(f"erab_released_{res['released']}")
            return []
        if proc == S.PROC_ERAB_MODIFY and kind == S.SUCCESSFUL:
            res = S.unpack_erab_modify_response(ies)
            self.events.append(f"erab_modified_{res['modified']}")
            return []
        if proc == S.PROC_NAS_NON_DELIVERY:
            nd = S.unpack_nas_non_delivery_indication(ies)
            # srsepc logs the undelivered PDU; the NAS layer's own retry
            # timers (T3413 paging etc.) drive any retransmission
            self.events.append(
                f"nas_non_delivery_ue{nd['mme_ue_id']}_{nd['cause']}")
            return []
        if proc == S.PROC_ENB_CONFIGURATION_UPDATE and kind == S.INITIATING:
            upd = S.unpack_enb_configuration_update(ies)
            self.events.append(f"enb_config_update_{sorted(upd)}")
            return [S.pack_enb_configuration_update_ack()]
        if proc == S.PROC_MME_CONFIGURATION_UPDATE and kind == S.SUCCESSFUL:
            self.events.append("mme_config_update_acked")
            return []
        if proc == S.PROC_WRITE_REPLACE_WARNING and kind == S.SUCCESSFUL:
            res = S.unpack_write_replace_warning_response(ies)
            self.events.append(f"warning_broadcast_{res['message_id']}")
            return []
        # unknown/unsupported PDU -> ERROR INDICATION
        # (36.413 8.7.3: unknown procedure, cause protocol/
        # message-not-compatible)
        self.events.append(f"unknown_pdu_proc{proc}")
        return [S.pack_error_indication(cause=(3, 1))]

    # --- MME-initiated interface management (36.413 8.7.5-8.7.7, 9.1.13)

    def overload_start(self, action: int = 1) -> bytes:
        """OVERLOAD START toward every linked eNB; returns the PDU."""
        pdu = S.pack_overload_start(action)
        for link in self.enb_links.values():
            link(pdu)
        return pdu

    def overload_stop(self) -> bytes:
        pdu = S.pack_overload_stop()
        for link in self.enb_links.values():
            link(pdu)
        return pdu

    def mme_configuration_update(self, **kw) -> bytes:
        pdu = S.pack_mme_configuration_update(**kw)
        for link in self.enb_links.values():
            link(pdu)
        return pdu

    def write_replace_warning(self, message_id: int, serial: int,
                              **kw) -> bytes:
        pdu = S.pack_write_replace_warning_request(message_id, serial,
                                                   **kw)
        for link in self.enb_links.values():
            link(pdu)
        return pdu

    def attach_enb_link(self, enb_id: int, link) -> None:
        """Register a delivery channel to an eNB (callable pdu ->
        [response pdus]) so MME-initiated procedures (handover relay,
        release) can reach it."""
        self.enb_links[enb_id] = link

    def _handle_handover(self, kind, proc, ies):
        """S1 handover relay (36.413 8.4): source HandoverRequired ->
        HandoverRequest at the target -> HandoverCommand back to the
        source; status transfer rewrite; notify -> source release."""
        if proc == S.PROC_HANDOVER_PREPARATION and kind == S.INITIATING:
            mme_ue, src_enb_ue = S.get_ue_ids(ies)
            target = S.dec_target_enb_id(ies[S.IE_TARGET_ID])
            link = self.enb_links.get(target["enb_id"])
            if link is None:
                self.events.append("handover_target_unknown")
                return []
            container = S._dec_container(
                ies[S.IE_SOURCE_TO_TARGET_CONTAINER])
            ctx = getattr(self.mme, "last_ctx", None)
            kasme = getattr(ctx, "kasme", bytes(32))
            k_enb = security.generate_k_enb(kasme, 0)
            nh = security.generate_nh(kasme, k_enb)     # first hop, NCC=1
            self._ho = {"mme_ue": mme_ue, "src_enb_ue": src_enb_ue,
                        "src_link": None, "target": target["enb_id"]}
            req = S.pack_handover_request(
                mme_ue, erab_id=5, qci=9, teid=mme_ue,
                gtp_addr=bytes([172, 16, 255, 1]),
                rrc_container=container, nh=nh, ncc=1)
            self.events.append("handover_request_to_target")
            for resp in link(req):
                rk, rp, ries = S.unpack_pdu(resp)
                if rp == S.PROC_HANDOVER_RESOURCE_ALLOC \
                        and rk == S.SUCCESSFUL:
                    ack = S.unpack_handover_request_ack(ries)
                    self._ho["tgt_enb_ue"] = S.get_ue_ids(ries)[1]
                    self.events.append("handover_command_to_source")
                    return [S.pack_handover_command(
                        mme_ue, src_enb_ue, ack["container"])]
            return []
        if proc == S.PROC_ENB_STATUS_TRANSFER:
            mme_ue, _ = S.get_ue_ids(ies)
            bearers = S.unpack_status_transfer(ies)
            ho = getattr(self, "_ho", None)
            if ho is not None:
                link = self.enb_links.get(ho["target"])
                if link is not None:
                    link(S.pack_status_transfer(
                        mme_ue, ho.get("tgt_enb_ue", 0),
                        [(bb["erab_id"], *bb["ul_count"], *bb["dl_count"])
                         for bb in bearers], direction_mme=True))
                    self.events.append("status_transfer_relayed")
            return []
        if proc == S.PROC_HANDOVER_NOTIFICATION:
            ho = getattr(self, "_ho", None)
            self.events.append("handover_notify")
            if ho is not None:
                # path switched: release the source-side context
                self.ue_ids[ho.get("tgt_enb_ue", 0)] = ho["mme_ue"]
                src = None
                for enb_id, link in self.enb_links.items():
                    if enb_id != ho["target"]:
                        src = link
                if src is not None:
                    src(S.pack_ue_context_release_command(
                        ho["mme_ue"], ho["src_enb_ue"], cause=0))
                    self.events.append("source_released")
            return []
        return []

    def setup_bearer(self, enb_ue_id: int, erab_id: int, qci: int,
                     teid: int, gtp_addr: bytes, nas_pdu: bytes) -> bytes:
        """Build an E-RAB SETUP REQUEST for a dedicated bearer (the MME
        GTP-C create-bearer path; srsepc scope is the default bearer, the
        procedure itself mirrors 36.413 8.2.1)."""
        mme_ue = self.ue_ids.get(enb_ue_id, 0)
        self.events.append("erab_setup_request")
        return S.pack_erab_setup_request(mme_ue, enb_ue_id, erab_id, qci,
                                         teid, gtp_addr, nas_pdu)

    def _nas_response(self, enb_ue: int, nas_pdu: bytes) -> list[bytes]:
        resp = self.mme.handle_ul_nas(nas_pdu)
        mme_ue = self.ue_ids.get(enb_ue, 0)
        ctx = getattr(self.mme, "last_ctx", None)
        if ctx is not None and getattr(ctx, "pending_ctx_setup", False) \
                and resp is not None:
            ctx.pending_ctx_setup = False
            k_enb = security.generate_k_enb(ctx.kasme, 0)
            teid, addr = 0, bytes(4)
            if ctx.spgw_teid:
                # the session was created during attach; advertise its
                # S1-U TEID, as the direct adapter does (the SP-GW drops
                # uplink GTP-U to any other TEID)
                teid = ctx.spgw_teid
                addr = bytes([172, 16, 255, 1])
            self.events.append("initial_ctx_setup_request")
            return [S.pack_initial_context_setup_request(
                mme_ue, enb_ue, erab_id=5, teid=teid, gtp_addr=addr,
                security_key=k_enb, nas_pdu=resp)]
        if resp is not None:
            return [S.pack_dl_nas_transport(mme_ue, enb_ue, resp)]
        return []

    def page(self, m_tmsi: int, mmec: int, tac: int) -> bytes:
        return S.pack_paging(m_tmsi, mmec, self.mcc, self.mnc, tac)

    def reset(self, partial: list | None = None,
              cause=(4, 1)) -> bytes:
        """Build an MME-initiated RESET (O&M intervention by default)."""
        self.events.append("reset_sent")
        if partial is None:
            self.ue_ids.clear()
        return S.pack_reset(cause=cause, partial=partial)

    def release_bearers(self, enb_ue_id: int, erabs: list,
                        nas_pdu: bytes | None = None) -> bytes:
        """Build an E-RAB RELEASE COMMAND (36.413 8.2.3)."""
        mme_ue = self.ue_ids.get(enb_ue_id, 0)
        self.events.append("erab_release_command")
        return S.pack_erab_release_command(mme_ue, enb_ue_id, erabs,
                                           nas_pdu)

    def modify_bearers(self, enb_ue_id: int, erabs: list) -> bytes:
        """Build an E-RAB MODIFY REQUEST (36.413 8.2.2).
        erabs = [(erab_id, new_qci, nas_pdu)]."""
        mme_ue = self.ue_ids.get(enb_ue_id, 0)
        self.events.append("erab_modify_request")
        return S.pack_erab_modify_request(mme_ue, enb_ue_id, erabs)


@dataclass
class EnbS1ap:
    """srsenb s1ap.cc analog: the eNB end of the S1 interface. Presents
    the directive interface to rrc.procedures while exchanging real
    S1AP PDUs with the MME through `send` (callable returning response
    PDUs, e.g. MmeS1ap.handle or a socket round-trip)."""

    send: object
    mcc: str = "001"
    mnc: str = "01"
    tac: int = 7
    cell_id: int = 0x1A2D001
    enb_id: int = 0x19B
    enb_name: str = "tpu-enb"
    next_enb_ue_id: int = 1
    setup_done: bool = False
    events: list = field(default_factory=list)
    _current_ue: int = 0
    #: active MME overload action (None = not overloaded); new
    #: non-emergency connection requests should be rejected while set
    overload_action: int | None = None
    #: received write-replace warning broadcasts (PWS), newest last
    warnings: list = field(default_factory=list)

    def s1_setup(self) -> bool:
        for resp in self.send(S.pack_s1_setup_request(
                self.mcc, self.mnc, self.enb_id, self.enb_name, self.tac)):
            kind, proc, _ = S.unpack_pdu(resp)
            if proc == S.PROC_S1_SETUP and kind == S.SUCCESSFUL:
                self.setup_done = True
                self.events.append("s1_setup_ok")
        return self.setup_done

    def initial_ue(self, nas_pdu: bytes, enb_teid: int = 0):
        if not self.setup_done:
            self.s1_setup()
        self._current_ue = self.next_enb_ue_id
        self.next_enb_ue_id += 1
        pdu = S.pack_initial_ue_message(self._current_ue, nas_pdu,
                                        self.mcc, self.mnc, self.tac,
                                        self.cell_id)
        return self._directives(self.send(pdu))

    def ul_nas(self, nas_pdu: bytes, enb_teid: int = 0):
        pdu = S.pack_ul_nas_transport(0, self._current_ue, nas_pdu,
                                      self.mcc, self.mnc, self.tac,
                                      self.cell_id)
        return self._directives(self.send(pdu))

    def _directives(self, responses) -> list:
        out = []
        for resp in responses:
            kind, proc, ies = S.unpack_pdu(resp)
            if proc == S.PROC_DOWNLINK_NAS:
                out.append(("dl_nas", S.get_nas(ies)))
            elif proc == S.PROC_INITIAL_CONTEXT_SETUP \
                    and kind == S.INITIATING:
                item = S.unpack_erab_setup_item(ies, with_nas=True)
                k_enb = ies[S.IE_SECURITY_KEY]
                mme_ue, enb_ue = S.get_ue_ids(ies)
                self.events.append("initial_ctx_setup")
                # acknowledge with our GTP endpoint
                self.send(S.pack_initial_context_setup_response(
                    mme_ue, enb_ue, item["erab_id"], teid=enb_ue,
                    gtp_addr=bytes([172, 16, 255, 2])))
                out.append(("ctx_setup", k_enb, item["nas_pdu"],
                            item.get("teid", 0)))
            elif proc == S.PROC_UE_CONTEXT_RELEASE \
                    and kind == S.INITIATING:
                # srsenb handle_uectxtreleasecommand: ack with complete
                mme_ue, enb_ue = self._ids_from_release(ies)
                self.send(S.pack_ue_context_release_complete(
                    mme_ue, enb_ue))
                self.events.append("released")
                out.append(("release",))
            elif proc == S.PROC_HANDOVER_PREPARATION \
                    and kind == S.SUCCESSFUL:
                self.events.append("handover_command")
                out.append(("handover_command", S._dec_container(
                    ies[S.IE_TARGET_TO_SOURCE_CONTAINER])))
            elif proc == S.PROC_ERAB_SETUP and kind == S.INITIATING:
                item = S.unpack_erab_setup_request(ies)
                mme_ue, enb_ue = S.get_ue_ids(ies)
                self.events.append(f"erab_setup_{item['erab_id']}")
                self.send(S.pack_erab_setup_response(
                    mme_ue, enb_ue, item["erab_id"], teid=enb_ue,
                    gtp_addr=bytes([172, 16, 255, 2])))
                out.append(("erab_setup", item["erab_id"], item["qci"],
                            item["teid"], item["addr"], item["nas_pdu"]))
            elif proc == S.PROC_ERAB_RELEASE and kind == S.INITIATING:
                cmd = S.unpack_erab_release_command(ies)
                ids = [e for e, _c in cmd["erabs"]]
                self.events.append(f"erab_release_{ids}")
                self.send(S.pack_erab_release_response(
                    cmd["mme_ue_id"] or 0, cmd["enb_ue_id"] or 0, ids))
                out.append(("erab_release", ids, cmd["nas_pdu"]))
            elif proc == S.PROC_ERAB_MODIFY and kind == S.INITIATING:
                req = S.unpack_erab_modify_request(ies)
                ids = [e for e, _q, _n in req["erabs"]]
                self.events.append(f"erab_modify_{ids}")
                self.send(S.pack_erab_modify_response(
                    req["mme_ue_id"] or 0, req["enb_ue_id"] or 0, ids))
                out.append(("erab_modify", req["erabs"]))
            elif proc == S.PROC_RESET and kind == S.INITIATING:
                req = S.unpack_reset(ies)
                self.events.append("reset")
                self.send(S.pack_reset_ack(partial=req["partial"]))
                out.append(("reset", req["reset_all"], req["partial"]))
            elif proc == S.PROC_ERROR_INDICATION:
                err = S.unpack_error_indication(ies)
                self.events.append(f"error_indication_{err['cause']}")
            elif proc == S.PROC_OVERLOAD_START:
                ov = S.unpack_overload_start(ies)
                self.overload_action = ov["action"]
                self.events.append(f"overload_start_{ov['action']}")
                out.append(("overload", ov["action"]))
            elif proc == S.PROC_OVERLOAD_STOP:
                self.overload_action = None
                self.events.append("overload_stop")
                out.append(("overload", None))
            elif proc == S.PROC_MME_CONFIGURATION_UPDATE \
                    and kind == S.INITIATING:
                upd = S.unpack_mme_configuration_update(ies)
                self.events.append("mme_config_update")
                self.send(S.pack_mme_configuration_update_ack())
                out.append(("mme_config", upd))
            elif proc == S.PROC_WRITE_REPLACE_WARNING \
                    and kind == S.INITIATING:
                w = S.unpack_write_replace_warning_request(ies)
                self.warnings.append(w)
                self.events.append(f"warning_rx_{w['message_id']}")
                self.send(S.pack_write_replace_warning_response(
                    w["message_id"], w["serial"]))
                out.append(("warning", w))
        return out

    def configuration_update(self, **kw) -> bool:
        """eNB CONFIGURATION UPDATE (srsenb would send this after a cell
        reconfiguration); returns True on MME acknowledge."""
        for resp in self.send(S.pack_enb_configuration_update(**kw)):
            kind, proc, _ = S.unpack_pdu(resp)
            if proc == S.PROC_ENB_CONFIGURATION_UPDATE \
                    and kind == S.SUCCESSFUL:
                self.events.append("enb_config_update_acked")
                return True
        return False

    def nas_non_delivery(self, nas_pdu: bytes,
                         cause=(0, 25)) -> None:
        """Report an undeliverable DL NAS PDU (srsenb s1ap.cc would send
        this when the UE left before delivery)."""
        self.send(S.pack_nas_non_delivery_indication(
            0, self._current_ue, nas_pdu, cause))
        self.events.append("nas_non_delivery_sent")

    @staticmethod
    def _ids_from_release(ies) -> tuple[int, int]:
        if S.IE_UE_S1AP_IDS in ies:
            from .per import AReader

            r = AReader(ies[S.IE_UE_S1AP_IDS])
            r.get(1)
            if r.get(1) == 0:       # pair
                r.get(1)
                r.get(1)
                return r.get_big_int(), r.get_big_int()
            return r.get_big_int(), 0
        return S.get_ue_ids(ies)

    def ue_capabilities(self, ue_radio_cap: bytes):
        """Forward UE radio capabilities to the MME (srsenb
        send_ue_capabilities)."""
        self.events.append("capabilities_forwarded")
        return self._directives(self.send(
            S.pack_ue_capability_info_indication(0, self._current_ue,
                                                 ue_radio_cap)))

    def initial_ctx_setup_failure(self, cause=(0, 26)):
        """Report context-setup failure (srsenb
        send_initial_ctxt_setup_failure); the MME answers with a release
        command."""
        self.events.append("ctx_setup_failed")
        return self._directives(self.send(
            S.pack_initial_context_setup_failure(0, self._current_ue,
                                                 cause)))

    def release_request(self, cause=(0, 21)):
        """eNB-initiated UE release (srsenb send_uectxtreleaserequest)."""
        self.events.append("release_requested")
        return self._directives(self.send(
            S.pack_ue_context_release_request(0, self._current_ue, cause)))

    def deliver(self, pdu: bytes) -> list:
        """MME-initiated inbound PDU (full-duplex topologies: release
        commands, paging): processed through the directive pipeline;
        any acknowledgements flow back via ``send``."""
        return self._directives([pdu])

    def handover_required(self, target_enb_id: int, rrc_container: bytes,
                          bearers=None):
        """Start an S1 handover toward ``target_enb_id`` (36.413 8.4.1):
        HANDOVER REQUIRED, then the PDCP COUNT status transfer once the
        command arrives. Returns directives; expect
        ("handover_command", container)."""
        self.events.append("handover_required")
        out = self._directives(self.send(S.pack_handover_required(
            0, self._current_ue, self.mcc, self.mnc, target_enb_id,
            self.tac, rrc_container)))
        if any(d[0] == "handover_command" for d in out):
            self.send(S.pack_status_transfer(
                0, self._current_ue,
                bearers or [(5, 0, 0, 0, 0)]))
            self.events.append("status_transferred")
        return out


@dataclass
class EnbS1apTarget:
    """Target-side eNB handover handler: the MME-initiated inbound
    surface of an eNB (36.413 8.4.2 Handover Resource Allocation +
    status transfer + release). Compose with EnbS1ap for a full eNB, or
    use standalone as the target in an S1 handover test topology.

    ``prepare`` hook: called with the decoded HandoverRequest dict, must
    return the target-to-source RRC container (the
    RRCConnectionReconfiguration-with-mobilityControlInfo the target RRC
    builds); default echoes an empty container.
    """

    mcc: str = "001"
    mnc: str = "01"
    tac: int = 7
    cell_id: int = 0x1A2D002
    gtp_addr: bytes = bytes([172, 16, 255, 3])
    prepare: object = None
    next_enb_ue_id: int = 100
    events: list = field(default_factory=list)
    last_request: dict | None = None
    counts: list = field(default_factory=list)

    def handle(self, pdu: bytes) -> list[bytes]:
        kind, proc, ies = S.unpack_pdu(pdu)
        if proc == S.PROC_HANDOVER_RESOURCE_ALLOC and kind == S.INITIATING:
            req = S.unpack_handover_request(ies)
            mme_ue = S.get_ue_ids(ies)[0]
            enb_ue = self.next_enb_ue_id
            self.next_enb_ue_id += 1
            self.last_request = {**req, "mme_ue": mme_ue,
                                 "enb_ue": enb_ue}
            container = self.prepare(self.last_request) \
                if self.prepare is not None else b""
            self.events.append("handover_request")
            return [S.pack_handover_request_ack(
                mme_ue, enb_ue, req["erab_id"], teid=enb_ue,
                gtp_addr=self.gtp_addr, rrc_container=container)]
        if proc == S.PROC_MME_STATUS_TRANSFER:
            self.counts = S.unpack_status_transfer(ies)
            self.events.append("status_received")
            return []
        return []

    def notify_arrival(self, mme_s1) -> None:
        """UE arrived on the target cell: HANDOVER NOTIFY to the MME."""
        lr = self.last_request or {}
        self.events.append("handover_notify")
        mme_s1.handle(S.pack_handover_notify(
            lr.get("mme_ue", 0), lr.get("enb_ue", 0), self.mcc, self.mnc,
            self.tac, self.cell_id))
