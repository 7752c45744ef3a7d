"""S1AP message codecs (36.413; liblte_s1ap.cc parity for the procedure
subset the reference apps exercise: S1 Setup, Initial UE Message,
UL/DL NAS Transport, Initial Context Setup, UE Context Release, Paging).

Values are plain dicts; every message is a ProtocolIE container encoded
with the exact envelope layout of the reference's generated codec
(PDU: ext(1)+choice(2)+align; InitiatingMessage: procedureCode(8)+
criticality(2)+align+length+body; IE: id(16)+criticality(2)+align+
length+value — liblte_s1ap.cc:43003-43024, 43973-44008).
"""

from __future__ import annotations

from .per import AReader, AWriter

# 36.413 procedure codes
PROC_INITIAL_CONTEXT_SETUP = 9
PROC_PAGING = 10
PROC_DOWNLINK_NAS = 11
PROC_INITIAL_UE_MESSAGE = 12
PROC_UPLINK_NAS = 13
PROC_S1_SETUP = 17
PROC_UE_CONTEXT_RELEASE_REQUEST = 18
PROC_UE_CONTEXT_RELEASE = 23

# PDU choices
INITIATING, SUCCESSFUL, UNSUCCESSFUL = 0, 1, 2

# IE ids (liblte_s1ap.h values = 36.413 9.0)
IE_MME_UE_S1AP_ID = 0
IE_CAUSE = 2
IE_ENB_UE_S1AP_ID = 8
IE_ERAB_TO_SETUP_LIST_CTXT = 24
IE_NAS_PDU = 26
IE_ERAB_SETUP_ITEM_CTXT = 50
IE_ERAB_SETUP_LIST_CTXT = 51
IE_ERAB_TO_SETUP_ITEM_CTXT = 52
IE_GLOBAL_ENB_ID = 59
IE_ENB_NAME = 60
IE_MME_NAME = 61
IE_SUPPORTED_TAS = 64
IE_UE_AMBR = 66
IE_TAI = 67
IE_SECURITY_KEY = 73
IE_RELATIVE_MME_CAPACITY = 87
IE_UE_S1AP_IDS = 99
IE_EUTRAN_CGI = 100
IE_SERVED_GUMMEIS = 105
IE_UE_SECURITY_CAPABILITIES = 107
IE_RRC_ESTABLISHMENT_CAUSE = 134
IE_DEFAULT_PAGING_DRX = 137
IE_UE_PAGING_ID = 80
IE_CN_DOMAIN = 109
IE_TAI_LIST = 46

CRIT_REJECT, CRIT_IGNORE, CRIT_NOTIFY = 0, 1, 2


def _plmn_bytes(mcc: str, mnc: str) -> bytes:
    d = [int(c) for c in mcc] + ([0xF] if len(mnc) == 2 else []) \
        + [int(c) for c in mnc]
    return bytes([d[1] << 4 | d[0], d[3] << 4 | d[2], d[5] << 4 | d[4]])


def _plmn_parse(b: bytes) -> tuple[str, str]:
    # inverse of _plmn_bytes: digits packed low-nibble-first
    d = [b[0] & 0xF, b[0] >> 4, b[1] & 0xF, b[1] >> 4, b[2] & 0xF,
         b[2] >> 4]
    mcc = f"{d[0]}{d[1]}{d[2]}"
    mnc = (f"{d[4]}{d[5]}" if d[3] == 0xF else f"{d[3]}{d[4]}{d[5]}")
    return mcc, mnc


# --- IE value codecs ----------------------------------------------------------


def _enc_ies(ies: list[tuple[int, int, bytes]]) -> bytes:
    """Message body: ext(1)+align, IE count (16), then each IE."""
    w = AWriter()
    w.put(0, 1)
    w.align()
    w.put(len(ies), 16)
    for ie_id, crit, val in ies:
        w.put(ie_id, 16)
        w.put(crit, 2)
        w.align()
        w.put_open(val)
    return w.to_bytes()


def _dec_ies(data: bytes) -> dict[int, bytes]:
    r = AReader(data)
    if r.get(1):
        raise ValueError("extended S1AP message")
    r.align()
    n = r.get(16)
    out = {}
    for _ in range(n):
        ie_id = r.get(16)
        r.get(2)
        val = r.get_open()
        out[ie_id] = val
    return out


def _enc_big(v: int) -> bytes:
    w = AWriter()
    w.put_big_int(v)
    return w.to_bytes()


def _dec_big(b: bytes) -> int:
    return AReader(b).get_big_int()


def _enc_nas(pdu: bytes) -> bytes:
    w = AWriter()
    w.put_open(pdu)
    return w.to_bytes()


def _dec_nas(b: bytes) -> bytes:
    return AReader(b).get_open()


def enc_tai(mcc: str, mnc: str, tac: int) -> bytes:
    # TAI ::= SEQ {pLMNidentity OCTET STRING(3), tAC OCTET STRING(2), ext}
    w = AWriter()
    w.put(0, 1)   # ext
    w.put(0, 1)   # iE-Extensions absent
    w.put_bytes(_plmn_bytes(mcc, mnc))
    w.put_bytes(tac.to_bytes(2, "big"))
    return w.to_bytes()


def dec_tai(b: bytes) -> tuple[str, str, int]:
    r = AReader(b)
    r.get(2)
    plmn = r.get_bytes(3)
    tac = int.from_bytes(r.get_bytes(2), "big")
    return (*_plmn_parse(plmn), tac)


def enc_cgi(mcc: str, mnc: str, cell_id: int) -> bytes:
    # EUTRAN-CGI ::= SEQ {pLMNidentity, cell-ID BIT STRING(28), ext}
    w = AWriter()
    w.put(0, 1)
    w.put(0, 1)
    w.put_bytes(_plmn_bytes(mcc, mnc))
    w.align()
    w.put(cell_id, 28)
    return w.to_bytes()


def dec_cgi(b: bytes) -> tuple[str, str, int]:
    r = AReader(b)
    r.get(2)
    plmn = r.get_bytes(3)
    r.align()
    cell = r.get(28)
    return (*_plmn_parse(plmn), cell)


# --- message builders ---------------------------------------------------------


def _pdu(kind: int, proc: int, crit: int, body: bytes) -> bytes:
    w = AWriter()
    w.put(0, 1)          # ext
    w.put(kind, 2)       # initiating/successful/unsuccessful
    w.align()
    w.put(proc, 8)
    w.put(crit, 2)
    w.align()
    w.put_open(body)
    return w.to_bytes()


def unpack_pdu(data: bytes) -> tuple[int, int, dict[int, bytes]]:
    """-> (kind, procedureCode, {ie_id: value_bytes})."""
    r = AReader(data)
    if r.get(1):
        raise ValueError("extended S1AP PDU")
    kind = r.get(2)
    r.align()
    proc = r.get(8)
    r.get(2)
    body = r.get_open()
    return kind, proc, _dec_ies(body)


def pack_s1_setup_request(mcc: str, mnc: str, enb_id: int, enb_name: str,
                          tac: int) -> bytes:
    # Global-ENB-ID ::= SEQ {pLMNidentity, eNB-ID CHOICE{macro BIT(20),
    # home BIT(28)}, ext}
    w = AWriter()
    w.put(0, 1)
    w.put(0, 1)
    w.put_bytes(_plmn_bytes(mcc, mnc))
    w.put(0, 1)          # choice ext
    w.put(0, 1)          # macroENB-ID
    w.align()
    w.put(enb_id, 20)
    gid = w.to_bytes()
    w2 = AWriter()       # SupportedTAs ::= SEQ (1..256) OF SupportedTAs-Item
    w2.put(0, 8)         # count-1
    w2.put(0, 1)
    w2.put(0, 1)
    w2.put_bytes(tac.to_bytes(2, "big"))
    w2.put(0, 8)         # BPLMNs count-1
    w2.put_bytes(_plmn_bytes(mcc, mnc))
    tas = w2.to_bytes()
    name = enb_name.encode()
    ies = [(IE_GLOBAL_ENB_ID, CRIT_REJECT, gid),
           (IE_ENB_NAME, CRIT_IGNORE, bytes([len(name)]) + name),
           (IE_SUPPORTED_TAS, CRIT_REJECT, tas),
           (IE_DEFAULT_PAGING_DRX, CRIT_IGNORE, b"\x40")]
    return _pdu(INITIATING, PROC_S1_SETUP, CRIT_REJECT, _enc_ies(ies))


def unpack_s1_setup_request(ies: dict[int, bytes]) -> dict:
    r = AReader(ies[IE_GLOBAL_ENB_ID])
    r.get(2)
    plmn = r.get_bytes(3)
    r.get(2)
    r.align()
    enb_id = r.get(20)
    name_b = ies.get(IE_ENB_NAME, b"\x00")
    mcc, mnc = _plmn_parse(plmn)
    return {"mcc": mcc, "mnc": mnc, "enb_id": enb_id,
            "enb_name": name_b[1 : 1 + name_b[0]].decode()}


def pack_s1_setup_response(mme_name: str, mcc: str, mnc: str,
                           mme_group: int, mme_code: int,
                           capacity: int = 50) -> bytes:
    name = mme_name.encode()
    w = AWriter()        # ServedGUMMEIs ::= SEQ(1..8) OF item
    w.put(0, 3)          # count-1
    w.put(0, 1)
    w.put(0, 1)
    w.put(0, 8)          # served PLMNs count-1
    w.put_bytes(_plmn_bytes(mcc, mnc))
    w.put(0, 16)         # groups count-1 (16 bits per SEQ(1..65535)?)
    w.put_bytes(mme_group.to_bytes(2, "big"))
    w.put(0, 8)          # codes count-1
    w.put_bytes(bytes([mme_code]))
    gummeis = w.to_bytes()
    ies = [(IE_MME_NAME, CRIT_IGNORE, bytes([len(name)]) + name),
           (IE_SERVED_GUMMEIS, CRIT_REJECT, gummeis),
           (IE_RELATIVE_MME_CAPACITY, CRIT_IGNORE, bytes([capacity]))]
    return _pdu(SUCCESSFUL, PROC_S1_SETUP, CRIT_REJECT, _enc_ies(ies))


def pack_initial_ue_message(enb_ue_id: int, nas_pdu: bytes, mcc: str,
                            mnc: str, tac: int, cell_id: int,
                            cause: int = 3) -> bytes:
    ies = [(IE_ENB_UE_S1AP_ID, CRIT_REJECT, _enc_big(enb_ue_id)),
           (IE_NAS_PDU, CRIT_REJECT, _enc_nas(nas_pdu)),
           (IE_TAI, CRIT_REJECT, enc_tai(mcc, mnc, tac)),
           (IE_EUTRAN_CGI, CRIT_IGNORE, enc_cgi(mcc, mnc, cell_id)),
           (IE_RRC_ESTABLISHMENT_CAUSE, CRIT_IGNORE, bytes([cause << 5]))]
    return _pdu(INITIATING, PROC_INITIAL_UE_MESSAGE, CRIT_IGNORE,
                _enc_ies(ies))


def pack_ul_nas_transport(mme_ue_id: int, enb_ue_id: int, nas_pdu: bytes,
                          mcc: str, mnc: str, tac: int,
                          cell_id: int) -> bytes:
    ies = [(IE_MME_UE_S1AP_ID, CRIT_REJECT, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_REJECT, _enc_big(enb_ue_id)),
           (IE_NAS_PDU, CRIT_REJECT, _enc_nas(nas_pdu)),
           (IE_EUTRAN_CGI, CRIT_IGNORE, enc_cgi(mcc, mnc, cell_id)),
           (IE_TAI, CRIT_IGNORE, enc_tai(mcc, mnc, tac))]
    return _pdu(INITIATING, PROC_UPLINK_NAS, CRIT_IGNORE, _enc_ies(ies))


def pack_dl_nas_transport(mme_ue_id: int, enb_ue_id: int,
                          nas_pdu: bytes) -> bytes:
    ies = [(IE_MME_UE_S1AP_ID, CRIT_REJECT, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_REJECT, _enc_big(enb_ue_id)),
           (IE_NAS_PDU, CRIT_REJECT, _enc_nas(nas_pdu))]
    return _pdu(INITIATING, PROC_DOWNLINK_NAS, CRIT_IGNORE, _enc_ies(ies))


def pack_initial_context_setup_request(mme_ue_id: int, enb_ue_id: int,
                                       erab_id: int, teid: int,
                                       gtp_addr: bytes,
                                       security_key: bytes,
                                       nas_pdu: bytes | None = None
                                       ) -> bytes:
    # UEAggregateMaximumBitrate ::= SEQ {dl BitRate, ul BitRate, ext}
    w = AWriter()
    w.put(0, 1)
    w.put(0, 1)
    w.put_big_int(10_000_000)
    w.put_big_int(10_000_000)
    ambr = w.to_bytes()
    # E-RABToBeSetupListCtxtSUReq ::= SEQ(1..256) OF ProtocolIE
    # (each item is itself an IE-framed open type — liblte layout)
    wi = AWriter()
    wi.put(0, 1)                           # item ext
    wi.put(1 if nas_pdu else 0, 1)         # nas-PDU present
    wi.put(0, 1)                           # iE-Extensions absent
    wi.put(erab_id, 4)                     # E-RAB-ID (0..15)
    wi.put(0, 1)                           # qci seq ext... (level of detail:
    wi.align()
    wi.put(9, 8)                           # QCI
    wi.put(15, 4)                          # priority level
    wi.put(0, 2)                           # pre-emption cap/vuln
    wi.put_bytes(bytes([len(gtp_addr) * 8 - 1]) + gtp_addr)  # transport addr
    wi.put_bytes(teid.to_bytes(4, "big"))
    if nas_pdu:
        wi.put_length(len(nas_pdu))
        wi.put_bytes(nas_pdu)
    item = wi.to_bytes()
    wl = AWriter()
    wl.put(0, 8)                           # count-1
    wl.put(IE_ERAB_TO_SETUP_ITEM_CTXT, 16)
    wl.put(CRIT_REJECT, 2)
    wl.align()
    wl.put_open(item)
    erabs = wl.to_bytes()
    # UESecurityCapabilities: 16-bit EEA + 16-bit EIA bitmaps
    sec = b"\x00" + b"\x60\x00" + b"\x60\x00"
    ies = [(IE_MME_UE_S1AP_ID, CRIT_REJECT, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_REJECT, _enc_big(enb_ue_id)),
           (IE_UE_AMBR, CRIT_REJECT, ambr),
           (IE_ERAB_TO_SETUP_LIST_CTXT, CRIT_REJECT, erabs),
           (IE_UE_SECURITY_CAPABILITIES, CRIT_REJECT, sec),
           (IE_SECURITY_KEY, CRIT_REJECT, security_key)]
    return _pdu(INITIATING, PROC_INITIAL_CONTEXT_SETUP, CRIT_REJECT,
                _enc_ies(ies))


def unpack_erab_setup_item(ies: dict[int, bytes],
                           with_nas: bool) -> dict:
    r = AReader(ies[IE_ERAB_TO_SETUP_LIST_CTXT])
    r.get(8)            # count-1
    r.get(16)
    r.get(2)
    item = r.get_open()
    ri = AReader(item)
    ri.get(1)
    nas_present = ri.get(1)
    ri.get(1)
    erab_id = ri.get(4)
    ri.get(1)
    ri.align()
    qci = ri.get(8)
    ri.get(4)
    ri.get(2)
    addr_len_bits = ri.get_bytes(1)[0] + 1
    addr = ri.get_bytes(addr_len_bits // 8)
    teid = int.from_bytes(ri.get_bytes(4), "big")
    nas = None
    if nas_present:
        nas = ri.get_bytes(ri.get_length())
    return {"erab_id": erab_id, "qci": qci, "addr": addr, "teid": teid,
            "nas_pdu": nas}


def pack_initial_context_setup_response(mme_ue_id: int, enb_ue_id: int,
                                        erab_id: int, teid: int,
                                        gtp_addr: bytes) -> bytes:
    wi = AWriter()
    wi.put(0, 1)
    wi.put(0, 1)
    wi.put(erab_id, 4)
    wi.put_bytes(bytes([len(gtp_addr) * 8 - 1]) + gtp_addr)
    wi.put_bytes(teid.to_bytes(4, "big"))
    item = wi.to_bytes()
    wl = AWriter()
    wl.put(0, 8)
    wl.put(IE_ERAB_SETUP_ITEM_CTXT, 16)
    wl.put(CRIT_IGNORE, 2)
    wl.align()
    wl.put_open(item)
    ies = [(IE_MME_UE_S1AP_ID, CRIT_IGNORE, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_IGNORE, _enc_big(enb_ue_id)),
           (IE_ERAB_SETUP_LIST_CTXT, CRIT_IGNORE, wl.to_bytes())]
    return _pdu(SUCCESSFUL, PROC_INITIAL_CONTEXT_SETUP, CRIT_REJECT,
                _enc_ies(ies))


def pack_ue_context_release_command(mme_ue_id: int, enb_ue_id: int,
                                    cause: int = 0) -> bytes:
    # UE-S1AP-IDs ::= CHOICE {uE-S1AP-ID-pair, mME-UE-S1AP-ID}
    w = AWriter()
    w.put(0, 1)          # choice ext
    w.put(0, 1)          # pair
    w.put(0, 1)          # pair seq ext
    w.put(0, 1)          # iE-ext absent
    w.put_big_int(mme_ue_id)
    w.put_big_int(enb_ue_id)
    ids = w.to_bytes()
    # Cause ::= CHOICE {radioNetwork ENUM, transport, nas, protocol, misc}
    wc = AWriter()
    wc.put(0, 1)
    wc.put(2, 3)         # nas
    wc.put(cause, 2)     # normal-release etc. (4 values + ext)
    ies = [(IE_UE_S1AP_IDS, CRIT_REJECT, ids),
           (IE_CAUSE, CRIT_IGNORE, wc.to_bytes())]
    return _pdu(INITIATING, PROC_UE_CONTEXT_RELEASE, CRIT_REJECT,
                _enc_ies(ies))


def pack_ue_context_release_complete(mme_ue_id: int,
                                     enb_ue_id: int) -> bytes:
    ies = [(IE_MME_UE_S1AP_ID, CRIT_IGNORE, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_IGNORE, _enc_big(enb_ue_id))]
    return _pdu(SUCCESSFUL, PROC_UE_CONTEXT_RELEASE, CRIT_REJECT,
                _enc_ies(ies))


def pack_paging(ue_paging_id_mtmsi: int, mmec: int, mcc: str, mnc: str,
                tac: int) -> bytes:
    # UEPagingID ::= CHOICE {s-TMSI, iMSI}
    w = AWriter()
    w.put(0, 1)          # choice ext
    w.put(0, 1)          # s-TMSI
    w.put(0, 1)          # s-TMSI seq ext
    w.put(0, 1)          # iE-ext absent
    w.put_bytes(bytes([mmec]))
    w.put_bytes(b"\x03" + ue_paging_id_mtmsi.to_bytes(4, "big"))
    pid = w.to_bytes()
    wt = AWriter()       # TAIList ::= SEQ(1..256) OF TAIItem (IE-framed)
    wt.put(0, 8)
    wt.put(IE_TAI, 16)
    wt.put(CRIT_IGNORE, 2)
    wt.align()
    wt.put_open(enc_tai(mcc, mnc, tac))
    ies = [(IE_UE_PAGING_ID, CRIT_IGNORE, pid),
           (IE_CN_DOMAIN, CRIT_IGNORE, b"\x00"),   # ps
           (IE_TAI_LIST, CRIT_IGNORE, wt.to_bytes())]
    return _pdu(INITIATING, PROC_PAGING, CRIT_IGNORE, _enc_ies(ies))


# helper getters over the generic IE dict

def get_nas(ies: dict[int, bytes]) -> bytes:
    return _dec_nas(ies[IE_NAS_PDU])


def get_ue_ids(ies: dict[int, bytes]) -> tuple[int | None, int | None]:
    mme = _dec_big(ies[IE_MME_UE_S1AP_ID]) \
        if IE_MME_UE_S1AP_ID in ies else None
    enb = _dec_big(ies[IE_ENB_UE_S1AP_ID]) \
        if IE_ENB_UE_S1AP_ID in ies else None
    return mme, enb


# --- additions beyond the initial subset: the remaining procedures the
# --- reference eNB/MME exercise (srsenb/src/upper/s1ap.cc:409-443
# --- handle_erabsetuprequest/send_erab_setup_response/send_ue_capabilities/
# --- send_initial_ctxt_setup_failure/send_uectxtreleaserequest)

PROC_ERAB_SETUP = 5
PROC_UE_CAPABILITY_INFO_IND = 22

IE_ERAB_TO_SETUP_LIST_BEARER = 16
IE_ERAB_TO_SETUP_ITEM_BEARER = 17
IE_ERAB_SETUP_LIST_BEARER = 28
IE_ERAB_FAILED_SETUP_LIST_BEARER = 29
IE_ERAB_SETUP_ITEM_BEARER = 39
IE_ERAB_ITEM = 35
IE_UE_RADIO_CAPABILITY = 74


def _enc_cause(group: int, value: int) -> bytes:
    """Cause ::= CHOICE {radioNetwork(0), transport(1), nas(2),
    protocol(3), misc(4)} of extensible ENUMERATEDs."""
    w = AWriter()
    w.put(0, 1)          # choice ext
    w.put(group, 3)
    w.put(0, 1)          # enum ext
    width = {0: 5, 1: 1, 2: 2, 3: 3, 4: 3}[group]
    w.put(value, width)
    return w.to_bytes()


def _dec_cause(b: bytes) -> tuple[int, int]:
    r = AReader(b)
    r.get(1)
    group = r.get(3)
    r.get(1)
    width = {0: 5, 1: 1, 2: 2, 3: 3, 4: 3}[group]
    return group, r.get(width)


def pack_erab_setup_request(mme_ue_id: int, enb_ue_id: int, erab_id: int,
                            qci: int, teid: int, gtp_addr: bytes,
                            nas_pdu: bytes) -> bytes:
    """E-RAB SETUP REQUEST (MME->eNB, additional bearer establishment).

    E-RABToBeSetupItemBearerSUReq carries a *mandatory* nAS-PDU (unlike
    the Ctxt variant) — srsenb handle_erabsetuprequest forwards it on the
    new DRB.
    """
    wi = AWriter()
    wi.put(0, 1)                           # item ext
    wi.put(0, 1)                           # iE-Extensions absent
    wi.put(erab_id, 4)
    wi.put(0, 1)                           # qos seq ext
    wi.align()
    wi.put(qci, 8)
    wi.put(15, 4)                          # allocation/retention priority
    wi.put(0, 2)
    wi.put_bytes(bytes([len(gtp_addr) * 8 - 1]) + gtp_addr)
    wi.put_bytes(teid.to_bytes(4, "big"))
    wi.put_length(len(nas_pdu))
    wi.put_bytes(nas_pdu)
    wl = AWriter()
    wl.put(0, 8)                           # count-1
    wl.put(IE_ERAB_TO_SETUP_ITEM_BEARER, 16)
    wl.put(CRIT_REJECT, 2)
    wl.align()
    wl.put_open(wi.to_bytes())
    ies = [(IE_MME_UE_S1AP_ID, CRIT_REJECT, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_REJECT, _enc_big(enb_ue_id)),
           (IE_ERAB_TO_SETUP_LIST_BEARER, CRIT_REJECT, wl.to_bytes())]
    return _pdu(INITIATING, PROC_ERAB_SETUP, CRIT_REJECT, _enc_ies(ies))


def unpack_erab_setup_request(ies: dict[int, bytes]) -> dict:
    r = AReader(ies[IE_ERAB_TO_SETUP_LIST_BEARER])
    r.get(8)
    r.get(16)
    r.get(2)
    ri = AReader(r.get_open())
    ri.get(1)
    ri.get(1)
    erab_id = ri.get(4)
    ri.get(1)
    ri.align()
    qci = ri.get(8)
    ri.get(4)
    ri.get(2)
    addr_len_bits = ri.get_bytes(1)[0] + 1
    addr = ri.get_bytes(addr_len_bits // 8)
    teid = int.from_bytes(ri.get_bytes(4), "big")
    nas = ri.get_bytes(ri.get_length())
    return {"erab_id": erab_id, "qci": qci, "addr": addr, "teid": teid,
            "nas_pdu": nas}


def pack_erab_setup_response(mme_ue_id: int, enb_ue_id: int, erab_id: int,
                             teid: int, gtp_addr: bytes,
                             failed_erab_id: int | None = None,
                             failed_cause: tuple[int, int] = (0, 13)
                             ) -> bytes:
    """E-RAB SETUP RESPONSE (eNB->MME; srsenb send_erab_setup_response)."""
    wi = AWriter()
    wi.put(0, 1)
    wi.put(0, 1)
    wi.put(erab_id, 4)
    wi.put_bytes(bytes([len(gtp_addr) * 8 - 1]) + gtp_addr)
    wi.put_bytes(teid.to_bytes(4, "big"))
    wl = AWriter()
    wl.put(0, 8)
    wl.put(IE_ERAB_SETUP_ITEM_BEARER, 16)
    wl.put(CRIT_IGNORE, 2)
    wl.align()
    wl.put_open(wi.to_bytes())
    ies = [(IE_MME_UE_S1AP_ID, CRIT_IGNORE, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_IGNORE, _enc_big(enb_ue_id)),
           (IE_ERAB_SETUP_LIST_BEARER, CRIT_IGNORE, wl.to_bytes())]
    if failed_erab_id is not None:
        # E-RABList ::= SEQ(1..256) OF IE-framed E-RABItem {id, cause}
        wf = AWriter()
        wf.put(0, 1)
        wf.put(0, 1)
        wf.put(failed_erab_id, 4)
        wf.put_bytes(_enc_cause(*failed_cause))
        wfl = AWriter()
        wfl.put(0, 8)
        wfl.put(IE_ERAB_ITEM, 16)
        wfl.put(CRIT_IGNORE, 2)
        wfl.align()
        wfl.put_open(wf.to_bytes())
        ies.append((IE_ERAB_FAILED_SETUP_LIST_BEARER, CRIT_IGNORE,
                    wfl.to_bytes()))
    return _pdu(SUCCESSFUL, PROC_ERAB_SETUP, CRIT_REJECT, _enc_ies(ies))



def unpack_erab_setup_response(ies: dict[int, bytes]) -> dict:
    r = AReader(ies[IE_ERAB_SETUP_LIST_BEARER])
    r.get(8)
    r.get(16)
    r.get(2)
    ri = AReader(r.get_open())
    ri.get(1)
    ri.get(1)
    erab_id = ri.get(4)
    addr_len_bits = ri.get_bytes(1)[0] + 1
    addr = ri.get_bytes(addr_len_bits // 8)
    teid = int.from_bytes(ri.get_bytes(4), "big")
    out = {"erab_id": erab_id, "addr": addr, "teid": teid, "failed": None}
    if IE_ERAB_FAILED_SETUP_LIST_BEARER in ies:
        rf = AReader(ies[IE_ERAB_FAILED_SETUP_LIST_BEARER])
        rf.get(8)
        rf.get(16)
        rf.get(2)
        rfi = AReader(rf.get_open())
        rfi.get(1)
        rfi.get(1)
        out["failed"] = rfi.get(4)
    return out


def pack_ue_capability_info_indication(mme_ue_id: int, enb_ue_id: int,
                                       ue_radio_cap: bytes) -> bytes:
    """UE CAPABILITY INFO INDICATION (eNB->MME; srsenb
    send_ue_capabilities forwards the UECapabilityInformation container).
    UERadioCapability is an unconstrained OCTET STRING."""
    w = AWriter()
    w.put_length(len(ue_radio_cap))
    w.put_bytes(ue_radio_cap)
    ies = [(IE_MME_UE_S1AP_ID, CRIT_REJECT, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_REJECT, _enc_big(enb_ue_id)),
           (IE_UE_RADIO_CAPABILITY, CRIT_IGNORE, w.to_bytes())]
    return _pdu(INITIATING, PROC_UE_CAPABILITY_INFO_IND, CRIT_IGNORE,
                _enc_ies(ies))


def get_ue_radio_capability(ies: dict[int, bytes]) -> bytes:
    r = AReader(ies[IE_UE_RADIO_CAPABILITY])
    return r.get_bytes(r.get_length())


def pack_initial_context_setup_failure(mme_ue_id: int, enb_ue_id: int,
                                       cause: tuple[int, int] = (0, 26)
                                       ) -> bytes:
    """INITIAL CONTEXT SETUP FAILURE (eNB->MME, unsuccessful outcome;
    srsenb send_initial_ctxt_setup_failure). Default cause:
    radioNetwork/failure-in-radio-interface-procedure."""
    ies = [(IE_MME_UE_S1AP_ID, CRIT_IGNORE, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_IGNORE, _enc_big(enb_ue_id)),
           (IE_CAUSE, CRIT_IGNORE, _enc_cause(*cause))]
    return _pdu(UNSUCCESSFUL, PROC_INITIAL_CONTEXT_SETUP, CRIT_REJECT,
                _enc_ies(ies))


def pack_ue_context_release_request(mme_ue_id: int, enb_ue_id: int,
                                    cause: tuple[int, int] = (0, 21)
                                    ) -> bytes:
    """UE CONTEXT RELEASE REQUEST (eNB-initiated; srsenb
    send_uectxtreleaserequest). Default cause:
    radioNetwork/radio-connection-with-ue-lost."""
    ies = [(IE_MME_UE_S1AP_ID, CRIT_REJECT, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_REJECT, _enc_big(enb_ue_id)),
           (IE_CAUSE, CRIT_IGNORE, _enc_cause(*cause))]
    return _pdu(INITIATING, PROC_UE_CONTEXT_RELEASE_REQUEST, CRIT_IGNORE,
                _enc_ies(ies))


# --- S1 handover procedure family (36.413 8.4; liblte_s1ap.h proc ids
# --- 0/1/2/24/25). The reference ships these codecs unused (its apps do
# --- intra-eNB handover over RRC only); here they complete the S1
# --- interface so handover can relay through the MME.

PROC_HANDOVER_PREPARATION = 0
PROC_HANDOVER_RESOURCE_ALLOC = 1
PROC_HANDOVER_NOTIFICATION = 2
PROC_ENB_STATUS_TRANSFER = 24
PROC_MME_STATUS_TRANSFER = 25

IE_HANDOVER_TYPE = 1
IE_TARGET_ID = 4
IE_ERAB_ADMITTED_LIST = 18
IE_ERAB_ADMITTED_ITEM = 20
IE_ERAB_TO_SETUP_ITEM_HO = 27
IE_SECURITY_CONTEXT = 40
IE_ERAB_TO_SETUP_LIST_HO = 53
IE_BEARERS_STATUS_ITEM = 89
IE_ENB_STATUS_CONTAINER = 90
IE_SOURCE_TO_TARGET_CONTAINER = 104
IE_TARGET_TO_SOURCE_CONTAINER = 123

HANDOVER_TYPE_INTRALTE = 0


def _enc_handover_type(ht: int = HANDOVER_TYPE_INTRALTE) -> bytes:
    w = AWriter()
    w.put(0, 1)          # enum ext
    w.put(ht, 3)
    return w.to_bytes()


def _enc_container(data: bytes) -> bytes:
    w = AWriter()
    w.put_length(len(data))
    w.put_bytes(data)
    return w.to_bytes()


def _dec_container(b: bytes) -> bytes:
    r = AReader(b)
    return r.get_bytes(r.get_length())


def enc_target_enb_id(mcc: str, mnc: str, enb_id: int, tac: int) -> bytes:
    """TargetID ::= CHOICE {targeteNB-ID {Global-ENB-ID (macro 20-bit),
    selected-TAI}, ...}."""
    w = AWriter()
    w.put(0, 1)                      # choice ext
    w.put(0, 2)                      # targeteNB-ID
    w.put(0, 1)                      # seq ext
    w.put(0, 1)                      # iE-Extensions absent
    w.put(0, 1)                      # global-enb-id seq ext
    w.put(0, 1)                      # its iE-Extensions absent
    w.put_bytes(_plmn_bytes(mcc, mnc))
    w.put(0, 1)                      # eNB-ID choice ext
    w.put(0, 1)                      # macroENB-ID
    w.align()
    w.put(enb_id << 4, 24)           # 20-bit id, octet-aligned bitstring
    w.put_bytes(enc_tai(mcc, mnc, tac))
    return w.to_bytes()


def dec_target_enb_id(b: bytes) -> dict:
    r = AReader(b)
    r.get(2 + 4)
    plmn = r.get_bytes(3)
    r.get(2)
    r.align()
    enb_id = r.get(24) >> 4
    mcc, mnc = _plmn_parse(plmn)
    t_mcc, t_mnc, tac = dec_tai(r.get_bytes(6))
    return {"mcc": mcc, "mnc": mnc, "enb_id": enb_id, "tac": tac}


def pack_handover_required(mme_ue_id: int, enb_ue_id: int, mcc: str,
                           mnc: str, target_enb_id: int, tac: int,
                           rrc_container: bytes,
                           cause: tuple[int, int] = (0, 2)) -> bytes:
    """HANDOVER REQUIRED (source eNB -> MME). Default cause:
    radioNetwork/handover-desirable-for-radio-reason."""
    ies = [(IE_MME_UE_S1AP_ID, CRIT_REJECT, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_REJECT, _enc_big(enb_ue_id)),
           (IE_HANDOVER_TYPE, CRIT_REJECT, _enc_handover_type()),
           (IE_CAUSE, CRIT_IGNORE, _enc_cause(*cause)),
           (IE_TARGET_ID, CRIT_REJECT,
            enc_target_enb_id(mcc, mnc, target_enb_id, tac)),
           (IE_SOURCE_TO_TARGET_CONTAINER, CRIT_REJECT,
            _enc_container(rrc_container))]
    return _pdu(INITIATING, PROC_HANDOVER_PREPARATION, CRIT_REJECT,
                _enc_ies(ies))


def pack_handover_command(mme_ue_id: int, enb_ue_id: int,
                          rrc_container: bytes) -> bytes:
    """HANDOVER COMMAND (MME -> source eNB, successful outcome)."""
    ies = [(IE_MME_UE_S1AP_ID, CRIT_REJECT, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_REJECT, _enc_big(enb_ue_id)),
           (IE_HANDOVER_TYPE, CRIT_REJECT, _enc_handover_type()),
           (IE_TARGET_TO_SOURCE_CONTAINER, CRIT_REJECT,
            _enc_container(rrc_container))]
    return _pdu(SUCCESSFUL, PROC_HANDOVER_PREPARATION, CRIT_REJECT,
                _enc_ies(ies))


def pack_handover_request(mme_ue_id: int, erab_id: int, qci: int,
                          teid: int, gtp_addr: bytes,
                          rrc_container: bytes, nh: bytes, ncc: int,
                          cause: tuple[int, int] = (0, 2)) -> bytes:
    """HANDOVER REQUEST (MME -> target eNB): bearer context + security
    context {NCC, NH} for K_eNB* derivation + the source RRC container."""
    wi = AWriter()
    wi.put(0, 1)                     # item ext
    wi.put(0, 1)                     # iE-Extensions absent
    wi.put(erab_id, 4)
    wi.put_bytes(bytes([len(gtp_addr) * 8 - 1]) + gtp_addr)
    wi.put_bytes(teid.to_bytes(4, "big"))
    wi.put(0, 1)                     # qos seq ext
    wi.align()
    wi.put(qci, 8)
    wi.put(15, 4)
    wi.put(0, 2)
    wl = AWriter()
    wl.put(0, 8)
    wl.put(IE_ERAB_TO_SETUP_ITEM_HO, 16)
    wl.put(CRIT_REJECT, 2)
    wl.align()
    wl.put_open(wi.to_bytes())
    # SecurityContext ::= SEQ {nextHopChainingCount (0..7), nextHopParameter
    # BIT STRING(256)}
    ws = AWriter()
    ws.put(0, 1)
    ws.put(0, 1)                     # iE-Extensions absent
    ws.put(ncc, 3)
    ws.align()
    ws.put_bytes(nh)
    ies = [(IE_MME_UE_S1AP_ID, CRIT_REJECT, _enc_big(mme_ue_id)),
           (IE_HANDOVER_TYPE, CRIT_REJECT, _enc_handover_type()),
           (IE_CAUSE, CRIT_IGNORE, _enc_cause(*cause)),
           (IE_ERAB_TO_SETUP_LIST_HO, CRIT_REJECT, wl.to_bytes()),
           (IE_SOURCE_TO_TARGET_CONTAINER, CRIT_REJECT,
            _enc_container(rrc_container)),
           (IE_SECURITY_CONTEXT, CRIT_REJECT, ws.to_bytes())]
    return _pdu(INITIATING, PROC_HANDOVER_RESOURCE_ALLOC, CRIT_REJECT,
                _enc_ies(ies))


def unpack_handover_request(ies: dict[int, bytes]) -> dict:
    r = AReader(ies[IE_ERAB_TO_SETUP_LIST_HO])
    r.get(8)
    r.get(16)
    r.get(2)
    ri = AReader(r.get_open())
    ri.get(2)
    erab_id = ri.get(4)
    addr_len_bits = ri.get_bytes(1)[0] + 1
    addr = ri.get_bytes(addr_len_bits // 8)
    teid = int.from_bytes(ri.get_bytes(4), "big")
    ri.get(1)
    ri.align()
    qci = ri.get(8)
    rs = AReader(ies[IE_SECURITY_CONTEXT])
    rs.get(2)
    ncc = rs.get(3)
    rs.align()
    nh = rs.get_bytes(32)
    return {"erab_id": erab_id, "qci": qci, "addr": addr, "teid": teid,
            "container": _dec_container(
                ies[IE_SOURCE_TO_TARGET_CONTAINER]),
            "nh": nh, "ncc": ncc}


def pack_handover_request_ack(mme_ue_id: int, enb_ue_id: int,
                              erab_id: int, teid: int, gtp_addr: bytes,
                              rrc_container: bytes) -> bytes:
    """HANDOVER REQUEST ACKNOWLEDGE (target eNB -> MME)."""
    wi = AWriter()
    wi.put(0, 1)
    wi.put(0, 3)                     # dl/ul forwarding + iE-ext absent
    wi.put(erab_id, 4)
    wi.put_bytes(bytes([len(gtp_addr) * 8 - 1]) + gtp_addr)
    wi.put_bytes(teid.to_bytes(4, "big"))
    wl = AWriter()
    wl.put(0, 8)
    wl.put(IE_ERAB_ADMITTED_ITEM, 16)
    wl.put(CRIT_IGNORE, 2)
    wl.align()
    wl.put_open(wi.to_bytes())
    ies = [(IE_MME_UE_S1AP_ID, CRIT_IGNORE, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_IGNORE, _enc_big(enb_ue_id)),
           (IE_ERAB_ADMITTED_LIST, CRIT_IGNORE, wl.to_bytes()),
           (IE_TARGET_TO_SOURCE_CONTAINER, CRIT_REJECT,
            _enc_container(rrc_container))]
    return _pdu(SUCCESSFUL, PROC_HANDOVER_RESOURCE_ALLOC, CRIT_REJECT,
                _enc_ies(ies))


def unpack_handover_request_ack(ies: dict[int, bytes]) -> dict:
    r = AReader(ies[IE_ERAB_ADMITTED_LIST])
    r.get(8)
    r.get(16)
    r.get(2)
    ri = AReader(r.get_open())
    ri.get(4)
    erab_id = ri.get(4)
    addr_len_bits = ri.get_bytes(1)[0] + 1
    addr = ri.get_bytes(addr_len_bits // 8)
    teid = int.from_bytes(ri.get_bytes(4), "big")
    return {"erab_id": erab_id, "addr": addr, "teid": teid,
            "container": _dec_container(
                ies[IE_TARGET_TO_SOURCE_CONTAINER])}


def pack_handover_notify(mme_ue_id: int, enb_ue_id: int, mcc: str,
                         mnc: str, tac: int, cell_id: int) -> bytes:
    """HANDOVER NOTIFY (target eNB -> MME after UE arrival)."""
    ies = [(IE_MME_UE_S1AP_ID, CRIT_REJECT, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_REJECT, _enc_big(enb_ue_id)),
           (IE_EUTRAN_CGI, CRIT_IGNORE, enc_cgi(mcc, mnc, cell_id)),
           (IE_TAI, CRIT_IGNORE, enc_tai(mcc, mnc, tac))]
    return _pdu(INITIATING, PROC_HANDOVER_NOTIFICATION, CRIT_IGNORE,
                _enc_ies(ies))


def pack_status_transfer(mme_ue_id: int, enb_ue_id: int,
                         bearers: list[tuple[int, int, int, int, int]],
                         direction_mme: bool = False) -> bytes:
    """eNB/MME STATUS TRANSFER: per-bearer PDCP COUNT continuity.

    bearers: [(erab_id, ul_sn, ul_hfn, dl_sn, dl_hfn)].
    """
    wl = AWriter()
    wl.put(len(bearers) - 1, 8)
    for erab_id, ul_sn, ul_hfn, dl_sn, dl_hfn in bearers:
        wi = AWriter()
        wi.put(0, 1)                 # item ext
        wi.put(0, 1)                 # receiveStatus absent
        wi.put(0, 1)                 # iE-Extensions absent
        wi.put(erab_id, 4)
        for sn, hfn in ((ul_sn, ul_hfn), (dl_sn, dl_hfn)):
            wi.put(0, 1)             # COUNTvalue seq ext
            wi.put(0, 1)             # its iE-Extensions absent
            wi.put(sn, 12)
            wi.put(hfn, 20)
        wl.put(IE_BEARERS_STATUS_ITEM, 16)
        wl.put(CRIT_IGNORE, 2)
        wl.align()
        wl.put_open(wi.to_bytes())
    wc = AWriter()
    wc.put(0, 1)                     # container seq ext
    wc.put_bytes(wl.to_bytes())
    ies = [(IE_MME_UE_S1AP_ID, CRIT_REJECT, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_REJECT, _enc_big(enb_ue_id)),
           (IE_ENB_STATUS_CONTAINER, CRIT_REJECT, wc.to_bytes())]
    return _pdu(INITIATING,
                PROC_MME_STATUS_TRANSFER if direction_mme
                else PROC_ENB_STATUS_TRANSFER,
                CRIT_IGNORE, _enc_ies(ies))


def unpack_status_transfer(ies: dict[int, bytes]) -> list[dict]:
    r = AReader(ies[IE_ENB_STATUS_CONTAINER])
    r.get(1)
    r.align()
    n = r.get(8) + 1
    out = []
    for _ in range(n):
        r.get(16)
        r.get(2)
        ri = AReader(r.get_open())
        ri.get(3)
        erab_id = ri.get(4)
        counts = []
        for _ in range(2):
            ri.get(2)
            counts.append((ri.get(12), ri.get(20)))
        out.append({"erab_id": erab_id, "ul_count": counts[0],
                    "dl_count": counts[1]})
    return out


# --- interface management + bearer management completion ---------------------
# (liblte_s1ap.h procedure codes 14/15 and 6/7; these round out the
# 36.413 elementary-procedure families the reference's codec library
# generates — srsenb/srsepc themselves only originate the subset above,
# but liblte_s1ap.cc carries the full codec surface.)

PROC_ERAB_MODIFY = 6
PROC_ERAB_RELEASE = 7
PROC_RESET = 14
PROC_ERROR_INDICATION = 15

IE_ERAB_RELEASE_ITEM_BEARER_REL_COMP = 15
IE_ERAB_TO_BE_MODIFIED_LIST = 30
IE_ERAB_MODIFY_LIST = 31
IE_ERAB_TO_BE_RELEASED_LIST = 33
IE_ERAB_TO_BE_MODIFIED_ITEM = 36
IE_ERAB_MODIFY_ITEM = 37
IE_CRITICALITY_DIAGNOSTICS = 58
IE_ERAB_RELEASE_LIST_BEARER_REL_COMP = 69
IE_UE_ASSOCIATED_LOGICAL_S1_CONNECTION_ITEM = 91
IE_RESET_TYPE = 92
IE_UE_ASSOCIATED_LOGICAL_S1_CONNECTION_LIST_RES_ACK = 93

RESET_ALL, RESET_PARTIAL = 0, 1


def _enc_s1_conn_item(mme_ue_id: int | None,
                      enb_ue_id: int | None) -> bytes:
    """UE-associatedLogicalS1-ConnectionItem: both ids OPTIONAL."""
    w = AWriter()
    w.put(0, 1)                            # ext
    w.put(1 if mme_ue_id is not None else 0, 1)
    w.put(1 if enb_ue_id is not None else 0, 1)
    w.put(0, 1)                            # iE-Extensions absent
    w.align()
    if mme_ue_id is not None:
        w.put_bytes(_enc_big(mme_ue_id))
    if enb_ue_id is not None:
        w.put_bytes(_enc_big(enb_ue_id))
    return w.to_bytes()


def _dec_s1_conn_item(b: bytes) -> tuple[int | None, int | None]:
    r = AReader(b)
    r.get(1)
    has_mme = r.get(1)
    has_enb = r.get(1)
    r.get(1)
    r.align()
    mme_ue = r.get_big_int() if has_mme else None
    enb_ue = r.get_big_int() if has_enb else None
    return mme_ue, enb_ue


def _enc_conn_list(pairs) -> bytes:
    """SEQUENCE OF ProtocolIE-SingleContainer of connection items."""
    w = AWriter()
    w.put(len(pairs) - 1, 8)               # SIZE(1..256)
    for mme_ue, enb_ue in pairs:
        w.put(IE_UE_ASSOCIATED_LOGICAL_S1_CONNECTION_ITEM, 16)
        w.put(CRIT_REJECT, 2)
        w.align()
        w.put_open(_enc_s1_conn_item(mme_ue, enb_ue))
    return w.to_bytes()


def _dec_conn_list(b: bytes) -> list:
    r = AReader(b)
    n = r.get(8) + 1
    out = []
    for _ in range(n):
        r.get(16)
        r.get(2)
        r.align()
        out.append(_dec_s1_conn_item(r.get_open()))
    return out


def pack_reset(cause: tuple[int, int] = (4, 1),
               partial: list | None = None) -> bytes:
    """RESET (36.413 8.7.1). partial = list of (mme_ue_id, enb_ue_id)
    pairs for partOfS1-Interface; None = s1-Interface reset-all."""
    wt = AWriter()
    if partial is None:
        wt.put(0, 1)                       # choice ext
        wt.put(RESET_ALL, 1)
        wt.put(0, 1)                       # ENUM reset-all ext bit
        # ENUMERATED{reset-all} has one value: zero more bits
    else:
        wt.put(0, 1)
        wt.put(RESET_PARTIAL, 1)
        wt.put_bytes(_enc_conn_list(partial))
    ies = [(IE_CAUSE, CRIT_IGNORE, _enc_cause(*cause)),
           (IE_RESET_TYPE, CRIT_REJECT, wt.to_bytes())]
    return _pdu(INITIATING, PROC_RESET, CRIT_REJECT, _enc_ies(ies))


def unpack_reset(ies: dict[int, bytes]) -> dict:
    cause = _dec_cause(ies[IE_CAUSE])
    r = AReader(ies[IE_RESET_TYPE])
    r.get(1)
    kind = r.get(1)
    if kind == RESET_ALL:
        return dict(cause=cause, reset_all=True, partial=None)
    r.align()
    n = r.get(8) + 1
    partial = []
    for _ in range(n):
        r.get(16)
        r.get(2)
        r.align()
        partial.append(_dec_s1_conn_item(r.get_open()))
    return dict(cause=cause, reset_all=False, partial=partial)


def pack_reset_ack(partial: list | None = None) -> bytes:
    """RESET ACKNOWLEDGE."""
    ies = []
    if partial is not None:
        ies.append((IE_UE_ASSOCIATED_LOGICAL_S1_CONNECTION_LIST_RES_ACK,
                    CRIT_IGNORE, _enc_conn_list(partial)))
    return _pdu(SUCCESSFUL, PROC_RESET, CRIT_REJECT, _enc_ies(ies))


def unpack_reset_ack(ies: dict[int, bytes]) -> dict:
    part = ies.get(IE_UE_ASSOCIATED_LOGICAL_S1_CONNECTION_LIST_RES_ACK)
    return dict(partial=_dec_conn_list(part) if part is not None else None)


def pack_error_indication(mme_ue_id: int | None = None,
                          enb_ue_id: int | None = None,
                          cause: tuple[int, int] | None = (3, 2)) -> bytes:
    """ERROR INDICATION (36.413 8.7.3) — every IE optional."""
    ies = []
    if mme_ue_id is not None:
        ies.append((IE_MME_UE_S1AP_ID, CRIT_IGNORE, _enc_big(mme_ue_id)))
    if enb_ue_id is not None:
        ies.append((IE_ENB_UE_S1AP_ID, CRIT_IGNORE, _enc_big(enb_ue_id)))
    if cause is not None:
        ies.append((IE_CAUSE, CRIT_IGNORE, _enc_cause(*cause)))
    return _pdu(INITIATING, PROC_ERROR_INDICATION, CRIT_IGNORE,
                _enc_ies(ies))


def unpack_error_indication(ies: dict[int, bytes]) -> dict:
    mme_ue, enb_ue = get_ue_ids(ies)
    c = ies.get(IE_CAUSE)
    return dict(mme_ue_id=mme_ue, enb_ue_id=enb_ue,
                cause=_dec_cause(c) if c is not None else None)


def _enc_erab_list(items: list, item_ie: int, body_fn) -> bytes:
    """E-RABList-style SEQUENCE OF ProtocolIE-SingleContainer."""
    w = AWriter()
    w.put(len(items) - 1, 8)
    for it in items:
        w.put(item_ie, 16)
        w.put(CRIT_REJECT if item_ie != IE_ERAB_ITEM else CRIT_IGNORE, 2)
        w.align()
        w.put_open(body_fn(it))
    return w.to_bytes()


def _dec_erab_list(b: bytes, body_fn) -> list:
    r = AReader(b)
    n = r.get(8) + 1
    out = []
    for _ in range(n):
        r.get(16)
        r.get(2)
        r.align()
        out.append(body_fn(AReader(r.get_open())))
    return out


def pack_erab_release_command(mme_ue_id: int, enb_ue_id: int,
                              erabs: list, nas_pdu: bytes | None = None
                              ) -> bytes:
    """E-RAB RELEASE COMMAND. erabs = [(erab_id, (cause_group, cause))]."""
    def body(it):
        erab_id, cause = it
        w = AWriter()
        w.put(0, 1)                        # item ext
        w.put(0, 1)                        # iE-Extensions absent
        w.put(erab_id, 4)
        w.put_bytes(_enc_cause(*cause))
        return w.to_bytes()

    ies = [(IE_MME_UE_S1AP_ID, CRIT_REJECT, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_REJECT, _enc_big(enb_ue_id)),
           (IE_ERAB_TO_BE_RELEASED_LIST, CRIT_REJECT,
            _enc_erab_list(erabs, IE_ERAB_ITEM, body))]
    if nas_pdu is not None:
        ies.append((IE_NAS_PDU, CRIT_IGNORE, _enc_nas(nas_pdu)))
    return _pdu(INITIATING, PROC_ERAB_RELEASE, CRIT_REJECT, _enc_ies(ies))


def unpack_erab_release_command(ies: dict[int, bytes]) -> dict:
    def body(r: AReader):
        r.get(1)
        r.get(1)
        erab_id = r.get(4)
        r.align()                          # cause written via put_bytes
        r.get(1)
        group = r.get(3)
        r.get(1)
        width = {0: 5, 1: 1, 2: 2, 3: 3, 4: 3}[group]
        return erab_id, (group, r.get(width))

    mme_ue, enb_ue = get_ue_ids(ies)
    nas = ies.get(IE_NAS_PDU)
    return dict(
        mme_ue_id=mme_ue, enb_ue_id=enb_ue,
        erabs=_dec_erab_list(ies[IE_ERAB_TO_BE_RELEASED_LIST], body),
        nas_pdu=_dec_nas(nas) if nas is not None else None)


def pack_erab_release_response(mme_ue_id: int, enb_ue_id: int,
                               released: list[int]) -> bytes:
    """E-RAB RELEASE RESPONSE with E-RABReleaseListBearerRelComp."""
    def body(erab_id):
        w = AWriter()
        w.put(0, 1)
        w.put(0, 1)
        w.put(erab_id, 4)
        return w.to_bytes()

    ies = [(IE_MME_UE_S1AP_ID, CRIT_IGNORE, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_IGNORE, _enc_big(enb_ue_id)),
           (IE_ERAB_RELEASE_LIST_BEARER_REL_COMP, CRIT_IGNORE,
            _enc_erab_list(released,
                           IE_ERAB_RELEASE_ITEM_BEARER_REL_COMP, body))]
    return _pdu(SUCCESSFUL, PROC_ERAB_RELEASE, CRIT_REJECT, _enc_ies(ies))


def unpack_erab_release_response(ies: dict[int, bytes]) -> dict:
    def body(r: AReader):
        r.get(1)
        r.get(1)
        return r.get(4)

    mme_ue, enb_ue = get_ue_ids(ies)
    return dict(mme_ue_id=mme_ue, enb_ue_id=enb_ue,
                released=_dec_erab_list(
                    ies[IE_ERAB_RELEASE_LIST_BEARER_REL_COMP], body))


def pack_erab_modify_request(mme_ue_id: int, enb_ue_id: int,
                             erabs: list) -> bytes:
    """E-RAB MODIFY REQUEST. erabs = [(erab_id, qci, nas_pdu)]."""
    def body(it):
        erab_id, qci, nas = it
        w = AWriter()
        w.put(0, 1)
        w.put(0, 1)                        # iE-Extensions absent
        w.put(erab_id, 4)
        w.put(0, 1)                        # qos seq ext
        w.align()
        w.put(qci, 8)
        w.put(15, 4)                       # allocation/retention priority
        w.put(0, 2)
        w.put_length(len(nas))
        w.put_bytes(nas)
        return w.to_bytes()

    ies = [(IE_MME_UE_S1AP_ID, CRIT_REJECT, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_REJECT, _enc_big(enb_ue_id)),
           (IE_ERAB_TO_BE_MODIFIED_LIST, CRIT_REJECT,
            _enc_erab_list(erabs, IE_ERAB_TO_BE_MODIFIED_ITEM, body))]
    return _pdu(INITIATING, PROC_ERAB_MODIFY, CRIT_REJECT, _enc_ies(ies))


def unpack_erab_modify_request(ies: dict[int, bytes]) -> dict:
    def body(r: AReader):
        r.get(1)
        r.get(1)
        erab_id = r.get(4)
        r.get(1)
        r.align()
        qci = r.get(8)
        r.get(4)
        r.get(2)
        ln = r.get_length()
        return erab_id, qci, r.get_bytes(ln)

    mme_ue, enb_ue = get_ue_ids(ies)
    return dict(mme_ue_id=mme_ue, enb_ue_id=enb_ue,
                erabs=_dec_erab_list(ies[IE_ERAB_TO_BE_MODIFIED_LIST],
                                     body))


def pack_erab_modify_response(mme_ue_id: int, enb_ue_id: int,
                              modified: list[int]) -> bytes:
    def body(erab_id):
        w = AWriter()
        w.put(0, 1)
        w.put(0, 1)
        w.put(erab_id, 4)
        return w.to_bytes()

    ies = [(IE_MME_UE_S1AP_ID, CRIT_IGNORE, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_IGNORE, _enc_big(enb_ue_id)),
           (IE_ERAB_MODIFY_LIST, CRIT_IGNORE,
            _enc_erab_list(modified, IE_ERAB_MODIFY_ITEM, body))]
    return _pdu(SUCCESSFUL, PROC_ERAB_MODIFY, CRIT_REJECT, _enc_ies(ies))


def unpack_erab_modify_response(ies: dict[int, bytes]) -> dict:
    def body(r: AReader):
        r.get(1)
        r.get(1)
        return r.get(4)

    mme_ue, enb_ue = get_ue_ids(ies)
    return dict(mme_ue_id=mme_ue, enb_ue_id=enb_ue,
                modified=_dec_erab_list(ies[IE_ERAB_MODIFY_LIST], body))


# --- configuration update / overload / warning / NAS non-delivery -----------
# (36.413 8.7.4-8.7.7, 8.6.2.4; procedure codes from liblte_s1ap.h:89-109)

PROC_NAS_NON_DELIVERY = 16
PROC_ENB_CONFIGURATION_UPDATE = 29
PROC_MME_CONFIGURATION_UPDATE = 30
PROC_OVERLOAD_START = 34
PROC_OVERLOAD_STOP = 35
PROC_WRITE_REPLACE_WARNING = 36

IE_OVERLOAD_RESPONSE = 101          # liblte_s1ap.h:285
IE_MESSAGE_IDENTIFIER = 111         # liblte_s1ap.h:295
IE_SERIAL_NUMBER = 112
IE_REPETITION_PERIOD = 114
IE_NUMBER_OF_BROADCAST_REQUEST = 115
IE_DATA_CODING_SCHEME = 118
IE_WARNING_MESSAGE_CONTENTS = 119
IE_BROADCAST_COMPLETED_AREA_LIST = 120

#: OverloadAction (36.413 9.2.3.19): reject all / reject non-emergency MO
#: data / permit emergency and MT only
OVERLOAD_REJECT_ALL = 0
OVERLOAD_REJECT_NON_EMERGENCY_MO = 1
OVERLOAD_PERMIT_EMERGENCY_AND_MT = 2


def pack_nas_non_delivery_indication(mme_ue_id: int, enb_ue_id: int,
                                     nas_pdu: bytes,
                                     cause: tuple[int, int] = (0, 25)
                                     ) -> bytes:
    """NAS NON DELIVERY INDICATION (36.413 8.6.2.4; eNB -> MME when a
    DownlinkNASTransport PDU could not be delivered to the UE)."""
    ies = [(IE_MME_UE_S1AP_ID, CRIT_REJECT, _enc_big(mme_ue_id)),
           (IE_ENB_UE_S1AP_ID, CRIT_REJECT, _enc_big(enb_ue_id)),
           (IE_NAS_PDU, CRIT_IGNORE, _enc_nas(nas_pdu)),
           (IE_CAUSE, CRIT_IGNORE, _enc_cause(*cause))]
    return _pdu(INITIATING, PROC_NAS_NON_DELIVERY, CRIT_IGNORE,
                _enc_ies(ies))


def unpack_nas_non_delivery_indication(ies: dict[int, bytes]) -> dict:
    mme_ue, enb_ue = get_ue_ids(ies)
    return dict(mme_ue_id=mme_ue, enb_ue_id=enb_ue,
                nas_pdu=_dec_nas(ies[IE_NAS_PDU]),
                cause=_dec_cause(ies[IE_CAUSE]))


def pack_enb_configuration_update(enb_name: str | None = None,
                                  tac: int | None = None,
                                  mcc: str = "001", mnc: str = "01",
                                  paging_drx: int | None = None) -> bytes:
    """ENB CONFIGURATION UPDATE (36.413 8.7.4; all IEs optional)."""
    ies = []
    if enb_name is not None:
        nb = enb_name.encode()
        ies.append((IE_ENB_NAME, CRIT_IGNORE, bytes([len(nb)]) + nb))
    if tac is not None:
        w = AWriter()
        w.put(0, 8)
        w.put(0, 1)
        w.put(0, 1)
        w.put_bytes(tac.to_bytes(2, "big"))
        w.put(0, 8)
        w.put_bytes(_plmn_bytes(mcc, mnc))
        ies.append((IE_SUPPORTED_TAS, CRIT_REJECT, w.to_bytes()))
    if paging_drx is not None:
        ies.append((IE_DEFAULT_PAGING_DRX, CRIT_IGNORE,
                    bytes([paging_drx])))
    return _pdu(INITIATING, PROC_ENB_CONFIGURATION_UPDATE, CRIT_REJECT,
                _enc_ies(ies))


def unpack_enb_configuration_update(ies: dict[int, bytes]) -> dict:
    out: dict = {}
    if IE_ENB_NAME in ies:
        nb = ies[IE_ENB_NAME]
        out["enb_name"] = nb[1 : 1 + nb[0]].decode()
    if IE_SUPPORTED_TAS in ies:
        r = AReader(ies[IE_SUPPORTED_TAS])
        r.get(8)
        r.get(2)
        out["tac"] = int.from_bytes(r.get_bytes(2), "big")
        r.get(8)
        out["mcc"], out["mnc"] = _plmn_parse(r.get_bytes(3))
    if IE_DEFAULT_PAGING_DRX in ies:
        out["paging_drx"] = ies[IE_DEFAULT_PAGING_DRX][0]
    return out


def pack_enb_configuration_update_ack() -> bytes:
    return _pdu(SUCCESSFUL, PROC_ENB_CONFIGURATION_UPDATE, CRIT_REJECT,
                _enc_ies([]))


def pack_mme_configuration_update(mme_name: str | None = None,
                                  mcc: str | None = None,
                                  mnc: str | None = None,
                                  mme_group: int = 1, mme_code: int = 1,
                                  capacity: int | None = None) -> bytes:
    """MME CONFIGURATION UPDATE (36.413 8.7.5; all IEs optional)."""
    ies = []
    if mme_name is not None:
        nb = mme_name.encode()
        ies.append((IE_MME_NAME, CRIT_IGNORE, bytes([len(nb)]) + nb))
    if mcc is not None:
        w = AWriter()
        w.put(0, 3)
        w.put(0, 1)
        w.put(0, 1)
        w.put(0, 8)
        w.put_bytes(_plmn_bytes(mcc, mnc))
        w.put(0, 16)
        w.put_bytes(mme_group.to_bytes(2, "big"))
        w.put(0, 8)
        w.put_bytes(bytes([mme_code]))
        ies.append((IE_SERVED_GUMMEIS, CRIT_REJECT, w.to_bytes()))
    if capacity is not None:
        ies.append((IE_RELATIVE_MME_CAPACITY, CRIT_IGNORE,
                    bytes([capacity])))
    return _pdu(INITIATING, PROC_MME_CONFIGURATION_UPDATE, CRIT_REJECT,
                _enc_ies(ies))


def unpack_mme_configuration_update(ies: dict[int, bytes]) -> dict:
    out: dict = {}
    if IE_MME_NAME in ies:
        nb = ies[IE_MME_NAME]
        out["mme_name"] = nb[1 : 1 + nb[0]].decode()
    if IE_SERVED_GUMMEIS in ies:
        r = AReader(ies[IE_SERVED_GUMMEIS])
        r.get(3)
        r.get(2)
        r.get(8)
        out["mcc"], out["mnc"] = _plmn_parse(r.get_bytes(3))
        r.get(16)
        out["mme_group"] = int.from_bytes(r.get_bytes(2), "big")
        r.get(8)
        out["mme_code"] = r.get_bytes(1)[0]
    if IE_RELATIVE_MME_CAPACITY in ies:
        out["capacity"] = ies[IE_RELATIVE_MME_CAPACITY][0]
    return out


def pack_mme_configuration_update_ack() -> bytes:
    return _pdu(SUCCESSFUL, PROC_MME_CONFIGURATION_UPDATE, CRIT_REJECT,
                _enc_ies([]))


def pack_overload_start(action: int = OVERLOAD_REJECT_NON_EMERGENCY_MO
                        ) -> bytes:
    """OVERLOAD START (36.413 8.7.6): OverloadResponse ::= CHOICE
    {overloadAction ENUMERATED{...,ext}}."""
    w = AWriter()
    w.put(0, 1)          # choice ext
    # single choice alternative: no index bits; ENUM(3, ext)
    w.put(0, 1)          # enum ext
    w.put(action, 2)
    ies = [(IE_OVERLOAD_RESPONSE, CRIT_REJECT, w.to_bytes())]
    return _pdu(INITIATING, PROC_OVERLOAD_START, CRIT_IGNORE,
                _enc_ies(ies))


def unpack_overload_start(ies: dict[int, bytes]) -> dict:
    r = AReader(ies[IE_OVERLOAD_RESPONSE])
    r.get(2)
    return dict(action=r.get(2))


def pack_overload_stop() -> bytes:
    """OVERLOAD STOP (36.413 8.7.7): no mandatory IEs."""
    return _pdu(INITIATING, PROC_OVERLOAD_STOP, CRIT_REJECT, _enc_ies([]))


def pack_write_replace_warning_request(message_id: int, serial: int,
                                       repetition_period: int = 0,
                                       num_broadcast: int = 1,
                                       coding_scheme: int | None = None,
                                       contents: bytes | None = None
                                       ) -> bytes:
    """WRITE-REPLACE WARNING REQUEST (36.413 9.1.13.1; PWS/ETWS/CMAS).

    message_id/serial are 16-bit BIT STRINGs (liblte_s1ap.cc:2824
    static bit string), repetition period INTEGER(0..4095), number of
    broadcasts INTEGER(0..65535)."""
    ies = [(IE_MESSAGE_IDENTIFIER, CRIT_REJECT,
            message_id.to_bytes(2, "big")),
           (IE_SERIAL_NUMBER, CRIT_REJECT, serial.to_bytes(2, "big")),
           (IE_REPETITION_PERIOD, CRIT_REJECT,
            repetition_period.to_bytes(2, "big")),
           (IE_NUMBER_OF_BROADCAST_REQUEST, CRIT_REJECT,
            num_broadcast.to_bytes(2, "big"))]
    if coding_scheme is not None:
        ies.append((IE_DATA_CODING_SCHEME, CRIT_IGNORE,
                    bytes([coding_scheme])))
    if contents is not None:
        w = AWriter()
        w.put_open(contents)
        ies.append((IE_WARNING_MESSAGE_CONTENTS, CRIT_IGNORE,
                    w.to_bytes()))
    return _pdu(INITIATING, PROC_WRITE_REPLACE_WARNING, CRIT_REJECT,
                _enc_ies(ies))


def unpack_write_replace_warning_request(ies: dict[int, bytes]) -> dict:
    out = dict(
        message_id=int.from_bytes(ies[IE_MESSAGE_IDENTIFIER], "big"),
        serial=int.from_bytes(ies[IE_SERIAL_NUMBER], "big"),
        repetition_period=int.from_bytes(ies[IE_REPETITION_PERIOD], "big"),
        num_broadcast=int.from_bytes(
            ies[IE_NUMBER_OF_BROADCAST_REQUEST], "big"))
    if IE_DATA_CODING_SCHEME in ies:
        out["coding_scheme"] = ies[IE_DATA_CODING_SCHEME][0]
    if IE_WARNING_MESSAGE_CONTENTS in ies:
        out["contents"] = AReader(ies[IE_WARNING_MESSAGE_CONTENTS]).get_open()
    return out


def pack_write_replace_warning_response(message_id: int,
                                        serial: int) -> bytes:
    ies = [(IE_MESSAGE_IDENTIFIER, CRIT_REJECT,
            message_id.to_bytes(2, "big")),
           (IE_SERIAL_NUMBER, CRIT_REJECT, serial.to_bytes(2, "big"))]
    return _pdu(SUCCESSFUL, PROC_WRITE_REPLACE_WARNING, CRIT_REJECT,
                _enc_ies(ies))


def unpack_write_replace_warning_response(ies: dict[int, bytes]) -> dict:
    return dict(
        message_id=int.from_bytes(ies[IE_MESSAGE_IDENTIFIER], "big"),
        serial=int.from_bytes(ies[IE_SERIAL_NUMBER], "big"))
