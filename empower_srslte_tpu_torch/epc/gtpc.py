"""GTPv2-C (S11) between MME and SP-GW — 29.274 subset.

Capability parity with srsepc/src/mme/mme_gtpc.cc + the srslte::gtpc_*
structs (lib/include/srslte/asn1/gtpc_msg.h): create session, modify
bearer, delete session, release access bearers. The reference passes C
structs between in-process singletons (mme_gtpc.cc:162
``m_spgw->handle_create_session_request(...)``); here the same
procedures are real serialized GTPv2-C PDUs (version-2 header + TLIV
IEs), so the S11 leg can also run over a socket.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

# message types (29.274 table 6.1-1)
CREATE_SESSION_REQ = 32
CREATE_SESSION_RESP = 33
MODIFY_BEARER_REQ = 34
MODIFY_BEARER_RESP = 35
DELETE_SESSION_REQ = 36
DELETE_SESSION_RESP = 37
RELEASE_ACCESS_BEARERS_REQ = 170
RELEASE_ACCESS_BEARERS_RESP = 171

# IE types
IE_IMSI = 1
IE_CAUSE = 2
IE_APN = 71
IE_EBI = 73
IE_PAA = 79
IE_RAT_TYPE = 82
IE_FTEID = 87

CAUSE_ACCEPTED = 16

# F-TEID interface types (29.274 8.22)
FTEID_S1U_ENB = 0
FTEID_S1U_SGW = 1
FTEID_S11_MME = 10
FTEID_S11_SGW = 11


def _tbcd(digits: str) -> bytes:
    if len(digits) % 2:
        digits = digits + "f"
    return bytes(int(digits[i + 1], 16) << 4 | int(digits[i], 16)
                 for i in range(0, len(digits), 2))


def _tbcd_parse(b: bytes) -> str:
    out = []
    for byte in b:
        out.append(f"{byte & 0xF:x}")
        hi = byte >> 4
        if hi != 0xF:
            out.append(f"{hi:x}")
    return "".join(out)


def enc_fteid(iface: int, teid: int, ipv4: bytes) -> bytes:
    return bytes([0x80 | iface]) + struct.pack(">I", teid) + ipv4


def dec_fteid(v: bytes) -> tuple[int, int, bytes]:
    return v[0] & 0x3F, struct.unpack(">I", v[1:5])[0], v[5:9]


def _ies(items: list) -> bytes:
    """items: (type, value) or (type, instance, value)."""
    out = bytearray()
    for item in items:
        typ, inst, val = item if len(item) == 3 else (item[0], 0, item[1])
        out += struct.pack(">BHB", typ, len(val), inst)
        out += val
    return bytes(out)


def pack(msg_type: int, teid: int, seq: int,
         ies: list[tuple[int, bytes]]) -> bytes:
    body = struct.pack(">I", teid) + struct.pack(">I", seq << 8)[0:3] \
        + b"\x00" + _ies(ies)
    return bytes([0x48, msg_type]) + struct.pack(">H", len(body)) + body


def unpack(data: bytes) -> tuple[int, int, int, dict[int, bytes]]:
    """-> (msg_type, teid, seq, {ie_type: value}) (first instance wins)."""
    if len(data) < 12 or (data[0] >> 5) != 2 or not data[0] & 0x08:
        raise ValueError("not a GTPv2-C PDU with TEID")
    msg_type = data[1]
    length = struct.unpack(">H", data[2:4])[0]
    teid = struct.unpack(">I", data[4:8])[0]
    seq = struct.unpack(">I", b"\x00" + data[8:11])[0]
    # keyed both by bare type (instance 0 / first seen) and by
    # (type, instance) — multi-instance IEs like the two F-TEIDs in a
    # CreateSessionRequest (S11 MME inst 0, S1-U eNB inst 1) need the
    # qualified key
    ies: dict = {}
    pos = 12
    end = 4 + length
    while pos + 4 <= end:
        typ, ln, inst = struct.unpack(">BHB", data[pos:pos + 4])
        inst &= 0x0F
        val = data[pos + 4:pos + 4 + ln]
        ies.setdefault(typ, val)
        ies[(typ, inst)] = val
        pos += 4 + ln
    return msg_type, teid, seq, ies


@dataclass
class MmeGtpc:
    """mme_gtpc analog: drives the SP-GW's S11 endpoint with serialized
    GTPv2-C. ``transport`` is a callable pdu -> response pdu (in-memory:
    SpGwGtpc.handle; or a socket round-trip)."""

    transport: object
    mme_s11_teid: int = 1
    _seq: int = 0

    def _next_seq(self) -> int:
        self._seq += 1
        return self._seq

    def create_session(self, imsi: str, enb_teid: int = 0,
                       enb_addr: bytes = bytes(4),
                       apn: str = "srsapn") -> dict:
        """mme_gtpc.cc:95 send_create_session_request. Returns
        {ue_ip, spgw_teid}."""
        ies = [(IE_IMSI, _tbcd(imsi)),
               (IE_RAT_TYPE, bytes([6])),                 # EUTRAN
               (IE_APN, apn.encode()),
               (IE_FTEID, enc_fteid(FTEID_S11_MME, self.mme_s11_teid,
                                    bytes(4))),
               (IE_PAA, bytes([1]) + bytes(4)),           # ipv4, dynamic
               (IE_EBI, bytes([5]))]
        if enb_teid:
            ies.append((IE_FTEID, 1, enc_fteid(FTEID_S1U_ENB, enb_teid,
                                               enb_addr)))
        resp = self.transport(pack(CREATE_SESSION_REQ, 0,
                                   self._next_seq(), ies))
        mt, _, _, ries = unpack(resp)
        assert mt == CREATE_SESSION_RESP
        if ries.get(IE_CAUSE, b"\x00")[0] != CAUSE_ACCEPTED:
            return {"cause": ries[IE_CAUSE][0]}
        paa = ries[IE_PAA]
        _, spgw_teid, _ = dec_fteid(ries[IE_FTEID])
        return {"ue_ip": ".".join(str(b) for b in paa[1:5]),
                "spgw_teid": spgw_teid, "cause": CAUSE_ACCEPTED}

    def modify_bearer(self, spgw_teid: int, enb_teid: int,
                      enb_addr: bytes = bytes(4)) -> bool:
        """mme_gtpc.cc:262 send_modify_bearer_request — installs the
        eNB's S1-U F-TEID after InitialContextSetupResponse."""
        resp = self.transport(pack(
            MODIFY_BEARER_REQ, spgw_teid, self._next_seq(),
            [(IE_EBI, bytes([5])),
             (IE_FTEID, enc_fteid(FTEID_S1U_ENB, enb_teid, enb_addr))]))
        mt, _, _, ries = unpack(resp)
        return mt == MODIFY_BEARER_RESP \
            and ries.get(IE_CAUSE, b"\x00")[0] == CAUSE_ACCEPTED

    def delete_session(self, spgw_teid: int) -> bool:
        """mme_gtpc.cc:316 send_delete_session_request (detach)."""
        resp = self.transport(pack(DELETE_SESSION_REQ, spgw_teid,
                                   self._next_seq(), [(IE_EBI, bytes([5]))]))
        return unpack(resp)[0] == DELETE_SESSION_RESP

    def release_access_bearers(self, spgw_teid: int) -> bool:
        """mme_gtpc.cc:366 send_release_access_bearers_request (S1
        release: drop the eNB F-TEID, keep the session)."""
        resp = self.transport(pack(RELEASE_ACCESS_BEARERS_REQ, spgw_teid,
                                   self._next_seq(), []))
        return unpack(resp)[0] == RELEASE_ACCESS_BEARERS_RESP


class SpGwGtpc:
    """SP-GW S11 endpoint (spgw.cc handle_create_session_request /
    handle_modify_bearer_request / handle_delete_session_request /
    handle_release_access_bearers_request analog) over the wire codec."""

    def __init__(self, spgw, spgw_addr: bytes = bytes([172, 16, 255, 1])):
        self.spgw = spgw
        self.spgw_addr = spgw_addr
        self._teid_by_imsi: dict[str, int] = {}

    def handle(self, data: bytes) -> bytes:
        mt, teid, seq, ies = unpack(data)
        if mt == CREATE_SESSION_REQ:
            imsi = _tbcd_parse(ies[IE_IMSI])
            enb_teid, enb_addr = 0, None
            if (IE_FTEID, 1) in ies:
                iface, ft, addr = dec_fteid(ies[(IE_FTEID, 1)])
                if iface == FTEID_S1U_ENB:
                    enb_teid, enb_addr = ft, tuple(addr)
            sess = self.spgw.create_session(imsi, enb_teid)
            self._teid_by_imsi[imsi] = sess.teid_in
            return pack(CREATE_SESSION_RESP, teid, seq, [
                (IE_CAUSE, bytes([CAUSE_ACCEPTED, 0])),
                (IE_FTEID, enc_fteid(FTEID_S1U_SGW, sess.teid_in,
                                     self.spgw_addr)),
                (IE_PAA, bytes([1]) + bytes(
                    int(x) for x in sess.ue_ip.split(".")))])
        if mt == MODIFY_BEARER_REQ:
            sess = self.spgw.session_by_teid(teid)
            ok = sess is not None
            if ok and IE_FTEID in ies:
                _, enb_teid, addr = dec_fteid(ies[IE_FTEID])
                sess.teid_out = enb_teid
                sess.enb_addr = tuple(addr)
            return pack(MODIFY_BEARER_RESP, teid, seq, [
                (IE_CAUSE, bytes([CAUSE_ACCEPTED if ok else 64, 0]))])
        if mt == DELETE_SESSION_REQ:
            sess = self.spgw.session_by_teid(teid)
            if sess is not None:
                self.spgw.delete_session(sess.imsi)
            return pack(DELETE_SESSION_RESP, teid, seq, [
                (IE_CAUSE, bytes([CAUSE_ACCEPTED, 0]))])
        if mt == RELEASE_ACCESS_BEARERS_REQ:
            sess = self.spgw.session_by_teid(teid)
            if sess is not None:
                sess.teid_out = 0
                sess.enb_addr = None
            return pack(RELEASE_ACCESS_BEARERS_RESP, teid, seq, [
                (IE_CAUSE, bytes([CAUSE_ACCEPTED, 0]))])
        raise ValueError(f"unhandled GTP-C message {mt}")
