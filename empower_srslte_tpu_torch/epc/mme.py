"""MME: NAS EMM/ESM state machines over HSS + SP-GW
(srsepc/src/mme parity — nas.cc attach/auth/SMC/ESM-info/detach/service
flows — on the real 24.301 wire format from epc/nas.py).

Drives the reference's attach sequence (srsepc nas.cc): Attach Request
(+ ESM PDN Connectivity Request) -> Authentication Request/Response
(Milenage via the HSS) -> Security Mode Command/Complete -> optional ESM
Information Request/Response -> session creation at the SP-GW -> Attach
Accept carrying Activate Default EPS Bearer Context Request + GUTI ->
Attach Complete -> EMM Information. Also: Service Request (short-MAC),
UE/network detach, Tracking Area Update, GUTI reallocation, identity
request, attach/auth/service reject paths. Transport-agnostic: the eNB
side passes opaque NAS PDUs (the reference carries them over S1AP).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..upper import security
from . import nas
from .hss import Hss
from .nas import Guti
from .spgw import SpGw

#: MME identity / serving area (mirrors srsepc mme.conf defaults).
PLMN = "00101"
MME_GROUP = 0x0002
MME_CODE = 0x1A
TAC = 0x0007
APN = "srsapn"
NETWORK_FULL_NAME = "srsLTE"
NETWORK_SHORT_NAME = "srs"


def kdf_nas_keys(kasme: bytes, eea: int = 0,
                 eia: int = 2) -> tuple[bytes, bytes]:
    """(K_NASenc, K_NASint) per 33.401 A.7."""
    return security.generate_k_nas(kasme, eea, eia)


def kdf_nas_int(kasme: bytes, alg_id: int = 2) -> bytes:
    """K_NASint derivation (33.401 A.7; kept for API compatibility)."""
    return security.generate_k_nas(kasme, 0, alg_id)[1]


@dataclass
class UeContext:
    imsi: str
    state: str = "idle"        # idle -> auth -> smc -> esm_info? -> attached
    xres: bytes = b""
    kasme: bytes = b""
    k_nas_int: bytes = b""
    k_nas_enc: bytes = b""
    ul_count: int = 0
    dl_count: int = 0
    ue_ip: str = ""
    guti: Guti | None = None
    spgw_teid: int = 0
    apn: str = APN
    ebi: int = 5
    pti: int = 1
    esm_info_pending: bool = False
    attach_complete: bool = False
    #: one-shot: the attach accept that needs an InitialContextSetup
    #: (consumed by the S1AP layer; further DL NAS rides DownlinkNASTransport)
    pending_ctx_setup: bool = False


class Mme:
    """NAS endpoint (one per EPC)."""

    def __init__(self, hss: Hss, spgw: SpGw | None = None):
        self.hss = hss
        self.spgw = spgw or SpGw()
        # S11: serialized GTPv2-C to the SP-GW (mme_gtpc.cc analog;
        # in-memory transport by default, socket-pluggable)
        from .gtpc import MmeGtpc, SpGwGtpc

        self.gtpc = MmeGtpc(transport=SpGwGtpc(self.spgw).handle)
        self._by_imsi: dict[str, UeContext] = {}
        self._next_m_tmsi = 0x1000
        self.last_ctx: UeContext | None = None  # ctx of the last UL NAS

    # -- helpers ------------------------------------------------------------

    def _alloc_guti(self, ctx: UeContext) -> Guti:
        guti = Guti(PLMN, MME_GROUP, MME_CODE, self._next_m_tmsi)
        self._next_m_tmsi += 1
        ctx.guti = guti
        return guti

    def _by_guti(self, guti: Guti) -> UeContext | None:
        for ctx in self._by_imsi.values():
            if ctx.guti == guti:
                return ctx
        return None

    def _dl(self, ctx: UeContext, msg: bytes,
            sh: int = nas.SH_INTEGRITY_CIPHERED) -> bytes:
        out = nas.protect(msg, ctx.k_nas_int, ctx.dl_count, 1, sh=sh)
        ctx.dl_count += 1
        return out

    #: additional tracking-area codes this MME serves beyond TAC (the
    #: accepts' TAI list; a UE reselecting into one of these stays
    #: registered without further TAU loops)
    extra_tacs: list = []

    def _tai_list(self) -> list:
        return [(PLMN, TAC)] + [(PLMN, t) for t in self.extra_tacs]

    def _attach_accept(self, ctx: UeContext, enb_teid: int) -> bytes:
        res = self.gtpc.create_session(ctx.imsi, enb_teid)
        ctx.ue_ip = res["ue_ip"]
        ctx.spgw_teid = res["spgw_teid"]
        guti = self._alloc_guti(ctx)
        ctx.state = "attached"
        ctx.pending_ctx_setup = True
        esm = nas.pack_activate_default_bearer_request(
            ebi=ctx.ebi, pti=ctx.pti, apn=ctx.apn,
            addr=bytes(int(x) for x in ctx.ue_ip.split(".")),
            qci=9, apn_ambr=(254, 254))
        acc = nas.pack_attach_accept(esm=esm, tai_list=self._tai_list(),
                                     t3412=(2, 30), guti=guti)
        return self._dl(ctx, acc)

    # -- main entry ----------------------------------------------------------

    def handle_ul_nas(self, pdu: bytes, enb_teid: int = 0) -> bytes | None:
        """Process one uplink NAS message; returns the downlink response
        (or None)."""
        if nas.is_service_request(pdu):
            return self._service_request(pdu, enb_teid)

        if nas.is_plain_emm(pdu):
            if pdu[1] == nas.MSG_ATTACH_REQUEST:
                return self._attach_request(pdu)
            if pdu[1] == nas.MSG_AUTH_RESPONSE:
                return self._auth_response(pdu)
            if pdu[1] == nas.MSG_AUTH_FAILURE:
                return self._auth_failure(pdu)
            if pdu[1] == nas.MSG_IDENTITY_RESPONSE:
                ident = nas.unpack_identity_response(pdu)
                if "imsi" in ident:
                    return self._start_auth(ident["imsi"])
                return None
            return None

        # integrity-protected uplink: find the owning context by MAC
        for ctx in list(self._by_imsi.values()):
            if not ctx.k_nas_int:
                continue
            inner = nas.unprotect(pdu, ctx.k_nas_int, ctx.ul_count, 0)
            if inner is None:
                continue
            ctx.ul_count = ((ctx.ul_count & ~0xFF) | pdu[5]) + 1
            self.last_ctx = ctx
            return self._protected_ul(ctx, inner, enb_teid)
        return None

    # -- EMM procedures -------------------------------------------------------

    def _start_auth(self, imsi: str) -> bytes | None:
        av = self.hss.generate_av(imsi)
        if av is None:
            # srsepc nas.cc: unknown IMSI -> Attach Reject (EMM cause 2)
            return nas.pack_attach_reject(nas.CAUSE_IMSI_UNKNOWN_IN_HSS)
        ctx = self._by_imsi.get(imsi) or UeContext(imsi=imsi)
        ctx.state = "auth"
        ctx.xres, ctx.kasme = av["xres"], av["kasme"]
        self._by_imsi[imsi] = ctx
        self.last_ctx = ctx
        return nas.pack_auth_request(av["rand"], av["autn"])

    def _attach_request(self, pdu: bytes) -> bytes | None:
        req = nas.unpack_attach_request(pdu)
        esm = nas.unpack_pdn_connectivity_request(req["esm"]) \
            if req["esm"] else {}
        if "imsi" in req:
            imsi = req["imsi"]
        else:
            ctx = self._by_guti(req.get("guti"))
            if ctx is None:
                # GUTI unknown: ask for the IMSI (srsepc nas.cc
                # handle_guti_attach -> pack_identity_request)
                return nas.pack_identity_request(nas.MOBILE_ID_IMSI)
            imsi = ctx.imsi
        resp = self._start_auth(imsi)
        if resp is not None and self.last_ctx is not None \
                and self.last_ctx.imsi == imsi:
            ctx = self.last_ctx
            ctx.pti = esm.get("pti", 1)
            ctx.esm_info_pending = bool(esm.get("esm_info_transfer"))
            if esm.get("apn"):
                ctx.apn = esm["apn"]
        return resp

    def _auth_response(self, pdu: bytes) -> bytes | None:
        ctx = self._ctx_in_state("auth")
        if ctx is None:
            return None
        self.last_ctx = ctx
        res = nas.unpack_auth_response(pdu)["res"]
        if res != ctx.xres:
            ctx.state = "idle"
            return nas.pack_auth_reject()
        ctx.k_nas_enc, ctx.k_nas_int = kdf_nas_keys(ctx.kasme)
        ctx.state = "smc"
        cmd = nas.pack_security_mode_command(eea=0, eia=2)
        # SMC uses the new-context security header (24.301 9.3.1)
        return self._dl(ctx, cmd, sh=nas.SH_INTEGRITY_NEW_CTX)

    def _auth_failure(self, pdu: bytes) -> bytes | None:
        v = nas.unpack_auth_failure(pdu)
        ctx = self._ctx_in_state("auth")
        if ctx is None:
            return None
        self.last_ctx = ctx
        if v["cause"] == nas.CAUSE_SYNCH_FAILURE and "auts" in v:
            # resynchronise the HSS SQN from AUTS and retry
            # (srsepc hss.cc resync_sqn)
            if hasattr(self.hss, "resync_sqn"):
                self.hss.resync_sqn(ctx.imsi, v["auts"])
            return self._start_auth(ctx.imsi)
        ctx.state = "idle"
        return None

    def _service_request(self, pdu: bytes, enb_teid: int) -> bytes | None:
        # ECM-idle -> connected (srsepc nas.cc service request): find
        # the attached context whose short MAC verifies, re-activate
        # its bearers (session persists; same IP/TEID)
        for ctx in self._by_imsi.values():
            if ctx.state == "attached" and nas.verify_service_request(
                    pdu, ctx.k_nas_int, ctx.ul_count):
                ctx.ul_count = (ctx.ul_count & ~0x1F) | (pdu[1] & 0x1F)
                ctx.ul_count += 1
                self.last_ctx = ctx
                if enb_teid:
                    # refresh the eNB S1-U endpoint (modify bearer)
                    self.gtpc.modify_bearer(ctx.spgw_teid, enb_teid)
                # ECM-idle -> connected: the radio bearers are rebuilt
                # via a fresh InitialContextSetup (srsepc s1ap ICS on
                # service request)
                ctx.pending_ctx_setup = True
                return self._dl(ctx, nas.pack_service_accept())
        return None

    def _protected_ul(self, ctx: UeContext, inner: bytes,
                      enb_teid: int) -> bytes | None:
        if nas.is_esm(inner):
            return self._esm_ul(ctx, inner, enb_teid)
        mt = inner[1]
        if mt == nas.MSG_SECURITY_MODE_COMPLETE and ctx.state == "smc":
            if ctx.esm_info_pending:
                ctx.state = "esm_info"
                return self._dl(ctx,
                                nas.pack_esm_information_request(ctx.pti))
            return self._attach_accept(ctx, enb_teid)
        if mt == nas.MSG_ATTACH_COMPLETE and ctx.state == "attached":
            # contains Activate Default EPS Bearer Context Accept
            esm = nas.unpack_attach_complete(inner)["esm"]
            _, _, emt = nas.esm_header(esm)
            if emt == nas.ESM_ACTIVATE_DEFAULT_BEARER_ACCEPT:
                ctx.attach_complete = True
                return self._dl(ctx, nas.pack_emm_information(
                    full_name=NETWORK_FULL_NAME,
                    short_name=NETWORK_SHORT_NAME, local_tz=0x40))
            return None
        if mt == nas.MSG_DETACH_REQUEST and ctx.state == "attached":
            # srsepc nas.cc detach handling: tear the session down
            v = nas.unpack_detach_request_ue(inner)
            if ctx.spgw_teid:
                self.gtpc.delete_session(ctx.spgw_teid)
            ctx.state = "deregistered"
            ctx.spgw_teid = 0
            if v["switch_off"]:
                return None          # no accept for switch-off (24.301)
            return self._dl(ctx, nas.pack_detach_accept())
        if mt == nas.MSG_DETACH_ACCEPT and ctx.state == "detaching":
            ctx.state = "deregistered"
            return None
        if mt == nas.MSG_TAU_REQUEST and ctx.state == "attached":
            # TAU accept with a fresh GUTI + current TAI list
            guti = self._alloc_guti(ctx)
            ctx.state = "tau"
            return self._dl(ctx, nas.pack_tau_accept(
                t3412=(2, 30), guti=guti, tai_list=self._tai_list()))
        if mt == nas.MSG_TAU_COMPLETE and ctx.state == "tau":
            ctx.state = "attached"
            return None
        if mt == nas.MSG_GUTI_REALLOCATION_COMPLETE:
            return None
        if mt == nas.MSG_EMM_STATUS:
            return None
        return None

    def _esm_ul(self, ctx: UeContext, inner: bytes,
                enb_teid: int) -> bytes | None:
        _, _, emt = nas.esm_header(inner)
        if emt == nas.ESM_INFORMATION_RESPONSE and ctx.state == "esm_info":
            v = nas.unpack_esm_information_response(inner)
            if v.get("apn"):
                ctx.apn = v["apn"]
            ctx.esm_info_pending = False
            return self._attach_accept(ctx, enb_teid)
        if emt == nas.ESM_PDN_DISCONNECT_REQUEST:
            v = nas.unpack_pdn_disconnect_request(inner)
            if ctx.spgw_teid:
                self.gtpc.delete_session(ctx.spgw_teid)
                ctx.spgw_teid = 0
            return self._dl(ctx, nas.pack_deactivate_bearer_request(
                v["linked_ebi"], v["pti"],
                nas.ESM_CAUSE_REGULAR_DEACTIVATION))
        if emt == nas.ESM_DEACTIVATE_BEARER_ACCEPT:
            return None
        return None

    # -- network-initiated procedures -----------------------------------------

    def detach_ue(self, imsi: str,
                  detach_type: int = nas.DETACH_REATTACH_NOT_REQUIRED,
                  ) -> bytes | None:
        """Network-initiated detach (srsepc nas.cc): tears the session
        down and returns the protected Detach Request for downlink."""
        ctx = self._by_imsi.get(imsi)
        if ctx is None or ctx.state != "attached":
            return None
        if ctx.spgw_teid:
            self.gtpc.delete_session(ctx.spgw_teid)
            ctx.spgw_teid = 0
        ctx.state = "detaching"
        return self._dl(ctx, nas.pack_detach_request_net(detach_type))

    def reallocate_guti(self, imsi: str) -> bytes | None:
        """GUTI reallocation command (24.301 5.4.1)."""
        ctx = self._by_imsi.get(imsi)
        if ctx is None or ctx.state != "attached":
            return None
        guti = self._alloc_guti(ctx)
        return self._dl(ctx, nas.pack_guti_reallocation_command(
            guti, tai_list=[(PLMN, TAC)]))

    def _ctx_in_state(self, state: str) -> UeContext | None:
        for ctx in self._by_imsi.values():
            if ctx.state == state:
                return ctx
        return None

    def context(self, imsi: str) -> UeContext | None:
        return self._by_imsi.get(imsi)


@dataclass
class UeNas:
    """UE-side NAS endpoint (srsue/src/upper/nas.cc + usim.cc analog).

    Sans-IO: attach_request()/service_request()/detach_request() produce
    uplink PDUs; handle_dl_nas() consumes downlink PDUs and returns the
    uplink response. tick_ms() drives the 24.301 retry timers (T3410
    attach, T3411 retry, T3421 detach) and returns a retransmission PDU
    on expiry, mirroring srsue nas.cc timer_expired.
    """

    imsi: str
    key: bytes
    opc: bytes
    k_nas_int: bytes = b""
    k_nas_enc: bytes = b""
    kasme: bytes = b""
    ul_count: int = 0
    dl_count: int = 0
    ue_ip: str = ""
    guti: Guti | None = None
    attached: bool = False
    state: str = "deregistered"
    apn: str = ""
    network_name: str = ""
    ebi: int = 0
    reject_cause: int | None = None
    # 24.301 11.2: T3410 = 15 s (attach), T3411 = 10 s (retry),
    # T3421 = 15 s (detach)
    t3410_ms: int = 0
    t3411_ms: int = 0
    t3421_ms: int = 0
    #: periodic TAU timer (24.301 5.3.5; armed from the accept's T3412)
    t3412_ms: int = 0
    #: wall scale applied to T3412 (tests shrink hours to milliseconds)
    t3412_scale: float = 1.0
    #: T3412 expired while registered: run TAU at the next connection
    pending_tau: bool = False
    #: registered TAI list from the last attach/TAU accept (24.301
    #: 5.5.3.2.2: entering a TA outside it triggers a normal TAU)
    tai_list: list = field(default_factory=list)
    attach_attempts: int = 0
    events: list = field(default_factory=list)

    # -- uplink initiators ----------------------------------------------------

    def attach_request(self) -> bytes:
        esm = nas.pack_pdn_connectivity_request(pti=1)
        self.state = "attaching"
        self.t3410_ms = 15_000
        self.attach_attempts += 1
        if self.guti is not None and self.k_nas_int:
            return nas.pack_attach_request(guti=self.guti, esm=esm,
                                           guti_type_native=True)
        return nas.pack_attach_request(imsi=self.imsi, esm=esm)

    def service_request(self) -> bytes:
        """ECM-idle -> connected (nas.cc send_service_request)."""
        pdu = nas.pack_service_request(self.k_nas_int, self.ul_count)
        self.ul_count += 1
        return pdu

    def detach_request(self, switch_off: bool = True) -> bytes:
        """UE-initiated detach (nas.cc:175 detach_request / :1164
        send_detach_request)."""
        req = nas.pack_detach_request_ue(
            self.guti or Guti(PLMN, 0, 0, 0), switch_off)
        pdu = self._ul(req)
        self.attached = False
        self.state = "deregistered" if switch_off else "detaching"
        if not switch_off:
            self.t3421_ms = 15_000
        return pdu

    def tau_request(self) -> bytes:
        assert self.guti is not None
        self.state = "tau"
        self.pending_tau = False
        return self._ul(nas.pack_tau_request(self.guti))

    def pdn_disconnect(self) -> bytes:
        return self._ul(nas.pack_pdn_disconnect_request(2, self.ebi or 5))

    # -- timers ----------------------------------------------------------------

    def tick_ms(self, ms: int = 1) -> bytes | None:
        """Advance the NAS timers; returns a PDU to (re)transmit on
        expiry (T3410 -> retry via T3411; T3421 -> local detach)."""
        if self.t3410_ms > 0:
            self.t3410_ms -= ms
            if self.t3410_ms <= 0 and self.state == "attaching":
                self.events.append("t3410_expired")
                self.t3411_ms = 10_000
        if self.t3411_ms > 0:
            self.t3411_ms -= ms
            if self.t3411_ms <= 0 and self.state == "attaching" \
                    and self.attach_attempts < 5:
                self.events.append("t3411_retry")
                return self.attach_request()
        if self.t3421_ms > 0:
            self.t3421_ms -= ms
            if self.t3421_ms <= 0 and self.state == "detaching":
                self.events.append("t3421_local_detach")
                self.state = "deregistered"
        if self.t3412_ms > 0:
            self.t3412_ms -= ms
            if self.t3412_ms <= 0 and self.state == "attached":
                # periodic TAU (24.301 5.3.5; srsue nas.cc t3412 expiry):
                # the request itself rides the next RRC connection
                self.events.append("t3412_expired")
                self.pending_tau = True
        return None

    # -- downlink handling -------------------------------------------------------

    def _ul(self, msg: bytes, sh: int = nas.SH_INTEGRITY_CIPHERED) -> bytes:
        pdu = nas.protect(msg, self.k_nas_int, self.ul_count, 0, sh=sh)
        self.ul_count += 1
        return pdu

    def handle_dl_nas(self, pdu: bytes,
                      plmn: bytes = b"\x00\xf1\x10") -> bytes | None:
        if nas.is_plain_emm(pdu):
            mt = pdu[1]
            if mt == nas.MSG_AUTH_REQUEST:
                return self._auth_request(pdu, plmn)
            if mt == nas.MSG_IDENTITY_REQUEST:
                v = nas.unpack_identity_request(pdu)
                if v["id_type"] == nas.MOBILE_ID_IMSI:
                    return nas.pack_identity_response(imsi=self.imsi)
                return None
            if mt == nas.MSG_ATTACH_REJECT:
                self.reject_cause = nas.unpack_attach_reject(pdu)["cause"]
                self.state = "deregistered"
                self.t3410_ms = 0
                self.events.append(f"attach_reject_{self.reject_cause}")
                return None
            if mt == nas.MSG_AUTH_REJECT:
                self.state = "deregistered"
                self.events.append("auth_reject")
                return None
            if mt == nas.MSG_SERVICE_REJECT:
                self.reject_cause = nas.unpack_service_reject(pdu)["cause"]
                self.events.append(f"service_reject_{self.reject_cause}")
                return None
            if mt == nas.MSG_TAU_REJECT:
                self.reject_cause = nas.unpack_tau_reject(pdu)["cause"]
                self.state = "attached" if self.attached else "deregistered"
                return None
            return None

        inner = nas.unprotect(pdu, self.k_nas_int, self.dl_count, 1)
        if inner is None:
            return None
        self.dl_count = ((self.dl_count & ~0xFF) | pdu[5]) + 1
        if nas.is_esm(inner):
            return self._esm_dl(inner)
        mt = inner[1]
        if mt == nas.MSG_SECURITY_MODE_COMMAND:
            v = nas.unpack_security_mode_command(inner)
            # replay check: the echoed capabilities must match ours
            if v["cap_eea"] != 0xE0 or v["cap_eia"] != 0x60:
                return nas.pack_security_mode_reject(0x18)
            return self._ul(nas.pack_security_mode_complete(),
                            sh=nas.SH_INTEGRITY_CIPHERED_NEW_CTX)
        if mt == nas.MSG_ATTACH_ACCEPT:
            return self._attach_accept(inner)
        if mt == nas.MSG_EMM_INFORMATION:
            v = nas.unpack_emm_information(inner)
            self.network_name = v.get("full_name", "")
            self.events.append("emm_information")
            return None
        if mt == nas.MSG_DETACH_REQUEST:
            # network-initiated detach (nas.cc:974 parse_detach_request)
            self.attached = False
            self.state = "deregistered"
            return self._ul(nas.pack_detach_accept())
        if mt == nas.MSG_DETACH_ACCEPT and self.state == "detaching":
            self.state = "deregistered"
            self.t3421_ms = 0
            return None
        if mt == nas.MSG_SERVICE_ACCEPT:
            self.events.append("service_accept")
            return None
        if mt == nas.MSG_TAU_ACCEPT:
            v = nas.unpack_tau_accept(inner)
            if "guti" in v:
                self.guti = v["guti"]
            if "tai_list" in v:
                self.tai_list = list(v["tai_list"])
            self.state = "attached"
            if "t3412" in v:
                self.t3412_ms = int(
                    nas.gprs_timer_ms(*v["t3412"]) * self.t3412_scale)
            self.events.append("tau_accept")
            return self._ul(nas.pack_tau_complete())
        if mt == nas.MSG_GUTI_REALLOCATION_COMMAND:
            v = nas.unpack_guti_reallocation_command(inner)
            self.guti = v["guti"]
            self.events.append("guti_reallocated")
            return self._ul(nas.pack_guti_reallocation_complete())
        return None

    def _auth_request(self, pdu: bytes, plmn: bytes) -> bytes | None:
        v = nas.unpack_auth_request(pdu)
        rand, autn = v["rand"], v["autn"]
        res, ck, ik, ak = security.milenage_f2345(self.key, self.opc, rand)
        # verify network MAC-A (AUTN = SQN^AK | AMF | MAC)
        sqn = bytes(a ^ b for a, b in zip(autn[:6], ak))
        mac_a, _ = security.milenage_f1(self.key, self.opc, rand, sqn,
                                        autn[6:8])
        if mac_a != autn[8:]:
            # network authentication failed (nas.cc send_auth_failure)
            return nas.pack_auth_failure(nas.CAUSE_MAC_FAILURE)
        from .hss import kasme_derive

        self.kasme = kasme_derive(ck, ik, plmn, autn[:6])
        self.k_nas_enc, self.k_nas_int = kdf_nas_keys(self.kasme)
        return nas.pack_auth_response(res)

    def _attach_accept(self, inner: bytes) -> bytes | None:
        v = nas.unpack_attach_accept(inner)
        if "guti" in v:
            self.guti = v["guti"]
        self.tai_list = list(v.get("tai_list") or [])
        esm = nas.unpack_activate_default_bearer_request(v["esm"])
        self.ue_ip = ".".join(str(b) for b in esm["addr"][:4])
        self.apn = esm["apn"]
        self.ebi = esm["ebi"]
        self.attached = True
        self.state = "attached"
        self.t3410_ms = self.t3411_ms = 0
        self.t3412_ms = int(
            nas.gprs_timer_ms(*v["t3412"]) * self.t3412_scale)
        accept = nas.pack_activate_default_bearer_accept(esm["ebi"],
                                                         esm["pti"])
        return self._ul(nas.pack_attach_complete(accept))

    def _esm_dl(self, inner: bytes) -> bytes | None:
        _, pti, emt = nas.esm_header(inner)
        if emt == nas.ESM_INFORMATION_REQUEST:
            return self._ul(nas.pack_esm_information_response(
                pti, apn=self.apn or APN))
        if emt == nas.ESM_DEACTIVATE_BEARER_REQUEST:
            v = nas.unpack_deactivate_bearer_request(inner)
            self.events.append("bearer_deactivated")
            return self._ul(nas.pack_deactivate_bearer_accept(
                v["ebi"], v["pti"]))
        if emt == nas.ESM_ACTIVATE_DEDICATED_BEARER_REQUEST:
            v = nas.unpack_activate_dedicated_bearer_request(inner)
            self.events.append(f"dedicated_bearer_{v['ebi']}")
            return self._ul(nas.pack_activate_dedicated_bearer_accept(
                v["ebi"], v["pti"]))
        return None
