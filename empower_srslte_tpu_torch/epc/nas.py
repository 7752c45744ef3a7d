"""24.301 NAS EMM/ESM wire-format codecs.

Real TS 24.301 byte layouts (EMM mobility management + ESM session
management), byte-exact against the reference codec
(lib/src/asn1/liblte_mme.cc — e.g. liblte_mme_pack_attach_accept_msg at
liblte_mme.cc:5101): golden vectors are generated by tools/nas_oracle.cc
(compiled against the reference as an executable oracle) and frozen into
tests/test_nas.py.

Structure: information-element helpers (PLMN/BCD identities, GUTI, TAI
lists, capabilities, timers, QoS, APN, PDN address, PCO, TFT, GSM-7bit
network names) -> per-message pack_*/unpack_* functions -> the security
header layer (integrity MAC per 33.401, optional ciphering) used by the
MME/UE endpoints in epc/mme.py.

Known reference quirks preserved for byte-parity (marked inline): the
TMSI mobile-identity length byte (liblte_mme.cc pack_mobile_id_ie writes
len=4 for a 5-byte body) — everything else follows 24.301/24.008.
"""

from __future__ import annotations

from typing import NamedTuple

from ..upper import security

#: Protocol discriminators (24.007 11.2.3.1.1).
PD_EMM = 0x07
PD_ESM = 0x02

#: Security header types (24.301 9.3.1).
SH_PLAIN = 0x0
SH_INTEGRITY = 0x1
SH_INTEGRITY_CIPHERED = 0x2
SH_INTEGRITY_NEW_CTX = 0x3
SH_INTEGRITY_CIPHERED_NEW_CTX = 0x4
SH_SERVICE_REQUEST = 0xC

# EMM message types (24.301 table 9.8.1)
MSG_ATTACH_REQUEST = 0x41
MSG_ATTACH_ACCEPT = 0x42
MSG_ATTACH_COMPLETE = 0x43
MSG_ATTACH_REJECT = 0x44
MSG_DETACH_REQUEST = 0x45
MSG_DETACH_ACCEPT = 0x46
MSG_TAU_REQUEST = 0x48
MSG_TAU_ACCEPT = 0x49
MSG_TAU_COMPLETE = 0x4A
MSG_TAU_REJECT = 0x4B
MSG_EXTENDED_SERVICE_REQUEST = 0x4C
MSG_SERVICE_REJECT = 0x4E
MSG_SERVICE_ACCEPT = 0x4F          # Rel-9 addition, spec layout
MSG_GUTI_REALLOCATION_COMMAND = 0x50
MSG_GUTI_REALLOCATION_COMPLETE = 0x51
MSG_AUTH_REQUEST = 0x52
MSG_AUTH_RESPONSE = 0x53
MSG_AUTH_REJECT = 0x54
MSG_IDENTITY_REQUEST = 0x55
MSG_IDENTITY_RESPONSE = 0x56
MSG_AUTH_FAILURE = 0x5C
MSG_SECURITY_MODE_COMMAND = 0x5D
MSG_SECURITY_MODE_COMPLETE = 0x5E
MSG_SECURITY_MODE_REJECT = 0x5F
MSG_EMM_STATUS = 0x60
MSG_EMM_INFORMATION = 0x61
MSG_DL_NAS_TRANSPORT = 0x62
MSG_UL_NAS_TRANSPORT = 0x63

# ESM message types (24.301 table 9.8.2)
ESM_ACTIVATE_DEFAULT_BEARER_REQUEST = 0xC1
ESM_ACTIVATE_DEFAULT_BEARER_ACCEPT = 0xC2
ESM_ACTIVATE_DEFAULT_BEARER_REJECT = 0xC3
ESM_ACTIVATE_DEDICATED_BEARER_REQUEST = 0xC5
ESM_ACTIVATE_DEDICATED_BEARER_ACCEPT = 0xC6
ESM_ACTIVATE_DEDICATED_BEARER_REJECT = 0xC7
ESM_DEACTIVATE_BEARER_REQUEST = 0xCD
ESM_DEACTIVATE_BEARER_ACCEPT = 0xCE
ESM_PDN_CONNECTIVITY_REQUEST = 0xD0
ESM_PDN_CONNECTIVITY_REJECT = 0xD1
ESM_PDN_DISCONNECT_REQUEST = 0xD2
ESM_PDN_DISCONNECT_REJECT = 0xD3
ESM_INFORMATION_REQUEST = 0xD9
ESM_INFORMATION_RESPONSE = 0xDA
ESM_STATUS = 0xE8

# EMM causes (24.301 9.9.3.9, the subset the procedures use)
CAUSE_IMSI_UNKNOWN_IN_HSS = 0x02
CAUSE_ILLEGAL_UE = 0x03
CAUSE_UE_ID_CANNOT_BE_DERIVED = 0x09
CAUSE_MAC_FAILURE = 0x14
CAUSE_SYNCH_FAILURE = 0x15
CAUSE_NO_EPS_BEARER_CONTEXT = 0x27
# ESM causes (24.301 9.9.4.4)
ESM_CAUSE_UNKNOWN_APN = 0x1B
ESM_CAUSE_REGULAR_DEACTIVATION = 0x24
ESM_CAUSE_PTI_ALREADY_IN_USE = 0x23
ESM_CAUSE_MSG_TYPE_NONEXISTENT = 0x62

# PDN / request types (24.301 9.9.4.10 / 9.9.4.14)
PDN_TYPE_IPV4 = 0x1
PDN_TYPE_IPV6 = 0x2
PDN_TYPE_IPV4V6 = 0x3
REQUEST_TYPE_INITIAL = 0x1
# detach types (24.301 9.9.3.7)
DETACH_EPS = 0x1
DETACH_IMSI = 0x2
DETACH_COMBINED = 0x3
DETACH_REATTACH_REQUIRED = 0x1   # network-originating
DETACH_REATTACH_NOT_REQUIRED = 0x2


class Guti(NamedTuple):
    """Globally Unique Temporary Identity (23.003 2.8)."""

    plmn: str            # mcc+mnc digit string, e.g. "00101"
    mme_group: int
    mme_code: int
    m_tmsi: int


# --------------------------------------------------------------------------
# IE building blocks
# --------------------------------------------------------------------------


def pack_plmn(plmn: str) -> bytes:
    """PLMN digit string (mcc 3 digits + mnc 2/3) -> 3-byte BCD
    (24.008 10.5.1.3: mcc2|mcc1, mnc3|mcc3, mnc2|mnc1; 2-digit MNC fills
    0xF)."""
    d = [int(c) for c in plmn]
    mnc3 = d[5] if len(d) == 6 else 0xF
    return bytes([(d[1] << 4) | d[0], (mnc3 << 4) | d[2],
                  (d[4] << 4) | d[3]])


def unpack_plmn(b: bytes) -> str:
    mcc = f"{b[0] & 0xF}{b[0] >> 4}{b[1] & 0xF}"
    mnc3 = b[1] >> 4
    mnc = f"{b[2] & 0xF}{b[2] >> 4}" + ("" if mnc3 == 0xF else str(mnc3))
    return mcc + mnc


def _pack_bcd_digits(digits: str) -> bytes:
    """15-digit identity -> 8 bytes with odd-indicator nibble layout
    (first byte carries digit 1 in the caller's type nibble)."""
    d = [int(c) for c in digits]
    out = []
    for i in range(1, len(d) - 1, 2):
        out.append((d[i + 1] << 4) | d[i])
    if len(d) % 2 == 0:                      # even count: pad last nibble
        out.append(0xF0 | d[-1])
    return bytes(out)


def _unpack_bcd_digits(first_digit: int, rest: bytes, odd: bool) -> str:
    digits = [str(first_digit)]
    for byte in rest:
        digits.append(str(byte & 0xF))
        digits.append(str(byte >> 4))
    if not odd:
        digits.pop()                          # strip 0xF filler
    return "".join(digits)


#: EPS mobile identity type-of-identity values (24.301 9.9.3.12).
EPS_ID_IMSI = 0x1
EPS_ID_GUTI = 0x6
#: 24.008 mobile identity types (10.5.1.4).
MOBILE_ID_IMSI = 0x1
MOBILE_ID_IMEI = 0x2
MOBILE_ID_IMEISV = 0x3
MOBILE_ID_TMSI = 0x4


def pack_eps_mobile_id(imsi: str | None = None,
                       guti: Guti | None = None) -> bytes:
    """EPS mobile identity LV (24.301 9.9.3.12)."""
    if guti is not None:
        body = (bytes([0xF0 | EPS_ID_GUTI]) + pack_plmn(guti.plmn)
                + guti.mme_group.to_bytes(2, "big")
                + bytes([guti.mme_code]) + guti.m_tmsi.to_bytes(4, "big"))
        return bytes([len(body)]) + body
    assert imsi is not None and len(imsi) == 15
    d0 = int(imsi[0])
    body = bytes([(d0 << 4) | (1 << 3) | EPS_ID_IMSI]) + _pack_bcd_digits(imsi)
    return bytes([len(body)]) + body


def unpack_eps_mobile_id(lv: bytes) -> tuple[dict, int]:
    """-> ({'imsi': str} | {'guti': Guti}, bytes consumed incl. len)."""
    n = lv[0]
    body = lv[1 : 1 + n]
    type_of_id = body[0] & 0x7
    if type_of_id == EPS_ID_GUTI:
        guti = Guti(unpack_plmn(body[1:4]),
                    int.from_bytes(body[4:6], "big"), body[6],
                    int.from_bytes(body[7:11], "big"))
        return {"guti": guti}, 1 + n
    odd = bool(body[0] & 0x8)
    return {"imsi": _unpack_bcd_digits(body[0] >> 4, body[1:], odd)}, 1 + n


def pack_mobile_id(imsi: str | None = None, tmsi: int | None = None,
                   imeisv: str | None = None) -> bytes:
    """24.008 mobile identity LV (10.5.1.4).

    Reference quirk preserved: pack_mobile_id_ie (liblte_mme.cc) writes
    length 4 for TMSI although the body (0xF4 + 4 TMSI bytes) is 5 bytes.
    """
    if tmsi is not None:
        return bytes([4, 0xF0 | MOBILE_ID_TMSI]) + tmsi.to_bytes(4, "big")
    if imeisv is not None:
        assert len(imeisv) == 16
        d0 = int(imeisv[0])
        body = (bytes([(d0 << 4) | MOBILE_ID_IMEISV])
                + _pack_bcd_digits(imeisv))
        return bytes([len(body)]) + body
    assert imsi is not None
    d0 = int(imsi[0])
    body = (bytes([(d0 << 4) | (1 << 3) | MOBILE_ID_IMSI])
            + _pack_bcd_digits(imsi))
    return bytes([len(body)]) + body


def unpack_mobile_id(lv: bytes) -> tuple[dict, int]:
    n = lv[0]
    type_of_id = lv[1] & 0x7
    if type_of_id == MOBILE_ID_TMSI:
        # reference writes len=4 but the body is 5 bytes (see pack)
        return {"tmsi": int.from_bytes(lv[2:6], "big")}, 6
    body = lv[1 : 1 + n]
    odd = bool(body[0] & 0x8)
    key = {MOBILE_ID_IMSI: "imsi", MOBILE_ID_IMEI: "imei",
           MOBILE_ID_IMEISV: "imeisv"}[type_of_id]
    return {key: _unpack_bcd_digits(body[0] >> 4, body[1:], odd)}, 1 + n


def pack_tai(plmn: str, tac: int) -> bytes:
    """Tracking area identity V (24.301 9.9.3.32): PLMN + TAC."""
    return pack_plmn(plmn) + tac.to_bytes(2, "big")


def unpack_tai(b: bytes) -> tuple[str, int]:
    return unpack_plmn(b[0:3]), int.from_bytes(b[3:5], "big")


#: TAI-list types (24.301 9.9.3.33).
TAI_LIST_ONE_PLMN_NONCONSEC = 0
TAI_LIST_DIFFERENT_PLMNS = 2


def pack_tai_list(tais: list[tuple[str, int]]) -> bytes:
    """Tracking area identity list LV. Mirrors the reference's layout
    (one partial list; type 0 for a single TAI, type 2 otherwise —
    liblte_mme.cc pack_tracking_area_identity_list_ie)."""
    typ = (TAI_LIST_ONE_PLMN_NONCONSEC if len(tais) == 1
           else TAI_LIST_DIFFERENT_PLMNS)
    body = bytes([(typ << 5) | (len(tais) - 1)])
    for plmn, tac in tais:
        body += pack_tai(plmn, tac)
    return bytes([len(body)]) + body


def unpack_tai_list(lv: bytes) -> tuple[list[tuple[str, int]], int]:
    n = lv[0]
    count = (lv[1] & 0x1F) + 1
    tais = [unpack_tai(lv[2 + 5 * i : 7 + 5 * i]) for i in range(count)]
    return tais, 1 + n


def pack_ue_net_cap(eea: int = 0xE0, eia: int = 0x60,
                    uea: int | None = None, uia: int | None = None) -> bytes:
    """UE network capability LV (24.301 9.9.3.34). eea/eia are bitmasks
    with bit7 = algorithm 0 (matching the reference's bool[8] order)."""
    body = bytes([eea, eia])
    if uea is not None:
        body += bytes([uea])
        if uia is not None:
            body += bytes([uia & 0x7F])
    return bytes([len(body)]) + body


def unpack_ue_net_cap(lv: bytes) -> tuple[dict, int]:
    n = lv[0]
    out = {"eea": lv[1], "eia": lv[2]}
    if n >= 3:
        out["uea"] = lv[3]
    if n >= 4:
        out["uia"] = lv[4] & 0x7F
    return out, 1 + n


def pack_gprs_timer(unit: int, value: int) -> bytes:
    """GPRS timer V (24.008 10.5.7.3): unit in bits 6-8."""
    return bytes([((unit & 0x7) << 5) | (value & 0x1F)])


def unpack_gprs_timer(b: int) -> tuple[int, int]:
    return (b >> 5) & 0x7, b & 0x1F


def gprs_timer_ms(unit: int, value: int) -> int:
    """GPRS Timer (24.008 10.5.7.3) to milliseconds; unit 7 =
    deactivated."""
    scale = {0: 2_000, 1: 60_000, 2: 360_000}.get(unit)
    return 0 if scale is None else value * scale


def pack_eps_qos(qci: int, mbr_ul: int | None = None, mbr_dl: int = 0,
                 gbr_ul: int = 0, gbr_dl: int = 0) -> bytes:
    """EPS quality of service LV (24.301 9.9.4.3)."""
    body = bytes([qci])
    if mbr_ul is not None:
        body += bytes([mbr_ul, mbr_dl, gbr_ul, gbr_dl])
    return bytes([len(body)]) + body


def unpack_eps_qos(lv: bytes) -> tuple[dict, int]:
    n = lv[0]
    out = {"qci": lv[1]}
    if n >= 5:
        out.update(mbr_ul=lv[2], mbr_dl=lv[3], gbr_ul=lv[4], gbr_dl=lv[5])
    return out, 1 + n


def pack_apn(apn: str) -> bytes:
    """Access point name LV (24.008 10.5.6.1: DNS label encoding)."""
    body = b""
    for label in apn.split("."):
        body += bytes([len(label)]) + label.encode()
    return bytes([len(body)]) + body


def unpack_apn(lv: bytes) -> tuple[str, int]:
    n = lv[0]
    body, labels, i = lv[1 : 1 + n], [], 0
    while i < len(body):
        ln = body[i]
        labels.append(body[i + 1 : i + 1 + ln].decode())
        i += 1 + ln
    return ".".join(labels), 1 + n


def pack_pdn_address(pdn_type: int, addr: bytes) -> bytes:
    """PDN address LV (24.301 9.9.4.9)."""
    body = bytes([pdn_type & 0x7]) + addr
    return bytes([len(body)]) + body


def unpack_pdn_address(lv: bytes) -> tuple[dict, int]:
    n = lv[0]
    return {"pdn_type": lv[1] & 0x7, "addr": bytes(lv[2 : 1 + n])}, 1 + n


# protocol configuration options (24.008 10.5.6.3)
PCO_IPV4_VIA_NAS = 0x000A
PCO_DNS_IPV4_REQUEST = 0x000D
PCO_DNS_IPV4_ADDRESS = 0x000D
PCO_IPCP = 0x8021


def pack_pco(opts: list[tuple[int, bytes]]) -> bytes:
    """Protocol configuration options LV: config-proto octet (0x80 =
    ext|PPP) then (id, len, contents) triplets."""
    body = bytes([0x80])
    for cid, content in opts:
        body += cid.to_bytes(2, "big") + bytes([len(content)]) + content
    return bytes([len(body)]) + body


def unpack_pco(lv: bytes) -> tuple[list[tuple[int, bytes]], int]:
    n = lv[0]
    body, opts, i = lv[1 : 1 + n], [], 1
    while i + 3 <= len(body):
        cid = int.from_bytes(body[i : i + 2], "big")
        ln = body[i + 2]
        opts.append((cid, bytes(body[i + 3 : i + 3 + ln])))
        i += 3 + ln
    return opts, 1 + n


# traffic flow template (24.008 10.5.6.12)
TFT_OP_CREATE = 1
TFT_DIR_BIDIRECTIONAL = 3
TFT_FILTER_SINGLE_REMOTE_PORT = 0x50


def pack_tft(op_code: int,
             filters: list[tuple[int, int, int, bytes]]) -> bytes:
    """TFT LV; filters are (direction, id, precedence, components)."""
    body = bytes([(op_code << 5) | (len(filters) & 0xF)])
    for direction, fid, precedence, comps in filters:
        body += bytes([((direction & 0x3) << 4) | (fid & 0xF), precedence,
                       len(comps)]) + comps
    return bytes([len(body)]) + body


def unpack_tft(lv: bytes) -> tuple[dict, int]:
    n = lv[0]
    body = lv[1 : 1 + n]
    out = {"op_code": body[0] >> 5, "filters": []}
    i, count = 1, body[0] & 0xF
    for _ in range(count):
        direction, fid = (body[i] >> 4) & 0x3, body[i] & 0xF
        precedence, ln = body[i + 1], body[i + 2]
        out["filters"].append((direction, fid, precedence,
                               bytes(body[i + 3 : i + 3 + ln])))
        i += 3 + ln
    return out, 1 + n


# GSM 7-bit default alphabet packing for network names (23.038 6.1.2.1)


def gsm7_pack(text: str) -> bytes:
    """Pack ASCII text as GSM 7-bit septets (subset: ASCII-compatible
    characters, which is what network names use)."""
    bits = 0
    acc = 0
    out = bytearray()
    for ch in text:
        acc |= (ord(ch) & 0x7F) << bits
        bits += 7
        while bits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            bits -= 8
    if bits:
        out.append(acc & 0xFF)
    return bytes(out)


def gsm7_unpack(data: bytes, nchars: int) -> str:
    acc = int.from_bytes(data, "little")
    return "".join(chr((acc >> (7 * i)) & 0x7F) for i in range(nchars))


def pack_network_name(name: str, add_ci: bool = False) -> bytes:
    """Network name LV (24.008 10.5.3.5a, GSM default alphabet)."""
    packed = gsm7_pack(name)
    spare = (8 * len(packed) - 7 * len(name)) % 8
    body = bytes([0x80 | (int(add_ci) << 3) | spare]) + packed
    return bytes([len(body)]) + body


def unpack_network_name(lv: bytes) -> tuple[str, int]:
    n = lv[0]
    spare = lv[1] & 0x7
    packed = lv[2 : 1 + n]
    nchars = (8 * len(packed) - spare) // 7
    return gsm7_unpack(packed, nchars), 1 + n


# --------------------------------------------------------------------------
# optional-IE scanning helper (TV/TLV tails)
# --------------------------------------------------------------------------

#: IE formats for optional-tail scanning: maps IEI -> ('tv1'|'tlv'|'tv_nib').
#: tv1 = 1-byte value after IEI; tlv = len byte + body; tv_nib = value in
#: the IEI's own low nibble (half-octet IEs like GUTI type).


def scan_optional(buf: bytes, pos: int, spec: dict[int, str]) -> dict:
    """Generic optional-IE tail scan. spec maps full-octet IEIs to 'tv1' /
    'tlv' / 'tv4' (4-byte value) and high-nibble IEIs (0x1-0xF) to
    'nib'. Unknown IEs are skipped as TLV (best effort)."""
    out: dict[int, bytes | int] = {}
    while pos < len(buf):
        iei = buf[pos]
        if iei >> 4 in spec and spec[iei >> 4] == "nib":
            out[iei >> 4] = iei & 0x0F
            pos += 1
            continue
        fmt = spec.get(iei)
        if fmt == "tv1":
            out[iei] = buf[pos + 1]
            pos += 2
        elif fmt == "tv4":
            out[iei] = bytes(buf[pos + 1 : pos + 5])
            pos += 5
        elif fmt == "tv5":
            out[iei] = bytes(buf[pos + 1 : pos + 6])
            pos += 6
        elif fmt == "tlv":
            n = buf[pos + 1]
            out[iei] = bytes(buf[pos + 1 : pos + 2 + n])
            pos += 2 + n
        else:                                  # unknown: assume TLV
            n = buf[pos + 1] if pos + 1 < len(buf) else 0
            pos += 2 + n
    return out


# --------------------------------------------------------------------------
# EMM messages
# --------------------------------------------------------------------------

ATTACH_TYPE_EPS = 0x1
ATTACH_RESULT_EPS_ONLY = 0x1
UPDATE_RESULT_TA = 0x0
UPDATE_TYPE_TA = 0x0

# optional IEIs
IEI_GUTI = 0x50
IEI_TAI_LIST = 0x54
IEI_LAST_VISITED_TAI = 0x52
IEI_T3402 = 0x17
IEI_T3412_TAU = 0x5A
IEI_T3423 = 0x59
IEI_T3442 = 0x5B
IEI_EMM_CAUSE = 0x53
IEI_AUTH_FAIL_PARAM = 0x30
IEI_FULL_NET_NAME = 0x43
IEI_SHORT_NET_NAME = 0x45
IEI_LOCAL_TIME_ZONE = 0x46
IEI_UE_NET_CAP_TAU = 0x58
IEI_EPS_BEARER_STATUS = 0x57
IEI_ESM_MSG_CONTAINER = 0x78


def pack_attach_request(imsi: str | None = None, guti: Guti | None = None,
                        esm: bytes = b"", ksi: int = 0,
                        attach_type: int = ATTACH_TYPE_EPS,
                        eea: int = 0xE0, eia: int = 0x60,
                        last_tai: tuple[str, int] | None = None,
                        guti_type_native: bool | None = None) -> bytes:
    """ATTACH REQUEST (24.301 8.2.4)."""
    out = bytearray([PD_EMM, MSG_ATTACH_REQUEST,
                     ((ksi & 0x7) << 4) | (attach_type & 0x7)])
    out += pack_eps_mobile_id(imsi=imsi, guti=guti)
    out += pack_ue_net_cap(eea, eia)
    out += len(esm).to_bytes(2, "big") + esm
    if last_tai is not None:
        out += bytes([IEI_LAST_VISITED_TAI]) + pack_tai(*last_tai)
    if guti_type_native is not None:
        out += bytes([(0xE << 4) | (0 if guti_type_native else 1)])
    return bytes(out)


def unpack_attach_request(msg: bytes) -> dict:
    assert msg[1] == MSG_ATTACH_REQUEST
    out: dict = {"ksi": (msg[2] >> 4) & 0x7, "attach_type": msg[2] & 0x7}
    pos = 3
    ident, used = unpack_eps_mobile_id(msg[pos:])
    out.update(ident)
    pos += used
    cap, used = unpack_ue_net_cap(msg[pos:])
    out["ue_net_cap"] = cap
    pos += used
    esm_len = int.from_bytes(msg[pos : pos + 2], "big")
    out["esm"] = bytes(msg[pos + 2 : pos + 2 + esm_len])
    pos += 2 + esm_len
    tail = scan_optional(msg, pos, {IEI_LAST_VISITED_TAI: "tv5",
                                    0xE: "nib"})
    if IEI_LAST_VISITED_TAI in tail:
        out["last_tai"] = unpack_tai(tail[IEI_LAST_VISITED_TAI])
    if 0xE in tail:
        out["guti_type_native"] = tail[0xE] == 0
    return out


def pack_attach_accept(esm: bytes, tai_list: list[tuple[str, int]],
                       t3412: tuple[int, int] = (2, 30),
                       guti: Guti | None = None,
                       result: int = ATTACH_RESULT_EPS_ONLY) -> bytes:
    """ATTACH ACCEPT (24.301 8.2.1; liblte_mme.cc:5101 layout)."""
    out = bytearray([PD_EMM, MSG_ATTACH_ACCEPT, result & 0xF])
    out += pack_gprs_timer(*t3412)
    out += pack_tai_list(tai_list)
    out += len(esm).to_bytes(2, "big") + esm
    if guti is not None:
        out += bytes([IEI_GUTI]) + pack_eps_mobile_id(guti=guti)
    return bytes(out)


def unpack_attach_accept(msg: bytes) -> dict:
    assert msg[1] == MSG_ATTACH_ACCEPT
    out: dict = {"result": msg[2] & 0xF,
                 "t3412": unpack_gprs_timer(msg[3])}
    pos = 4
    out["tai_list"], used = unpack_tai_list(msg[pos:])
    pos += used
    esm_len = int.from_bytes(msg[pos : pos + 2], "big")
    out["esm"] = bytes(msg[pos + 2 : pos + 2 + esm_len])
    pos += 2 + esm_len
    tail = scan_optional(msg, pos, {IEI_GUTI: "tlv", IEI_T3402: "tv1",
                                    IEI_T3423: "tv1"})
    if IEI_GUTI in tail:
        out["guti"] = unpack_eps_mobile_id(tail[IEI_GUTI])[0]["guti"]
    if IEI_T3402 in tail:
        out["t3402"] = unpack_gprs_timer(tail[IEI_T3402])
    return out


def pack_attach_complete(esm: bytes) -> bytes:
    return (bytes([PD_EMM, MSG_ATTACH_COMPLETE])
            + len(esm).to_bytes(2, "big") + esm)


def unpack_attach_complete(msg: bytes) -> dict:
    assert msg[1] == MSG_ATTACH_COMPLETE
    n = int.from_bytes(msg[2:4], "big")
    return {"esm": bytes(msg[4 : 4 + n])}


def pack_attach_reject(cause: int, esm: bytes = b"") -> bytes:
    out = bytearray([PD_EMM, MSG_ATTACH_REJECT, cause])
    if esm:
        out += bytes([IEI_ESM_MSG_CONTAINER])
        out += len(esm).to_bytes(2, "big") + esm
    return bytes(out)


def unpack_attach_reject(msg: bytes) -> dict:
    assert msg[1] == MSG_ATTACH_REJECT
    return {"cause": msg[2]}


def pack_auth_request(rand: bytes, autn: bytes, ksi: int = 0) -> bytes:
    """AUTHENTICATION REQUEST (24.301 8.2.7)."""
    assert len(rand) == 16
    return (bytes([PD_EMM, MSG_AUTH_REQUEST, ksi & 0x7]) + rand
            + bytes([len(autn)]) + autn)


def unpack_auth_request(msg: bytes) -> dict:
    assert msg[1] == MSG_AUTH_REQUEST
    n = msg[19]
    return {"ksi": msg[2] & 0x7, "rand": bytes(msg[3:19]),
            "autn": bytes(msg[20 : 20 + n])}


def pack_auth_response(res: bytes) -> bytes:
    return bytes([PD_EMM, MSG_AUTH_RESPONSE, len(res)]) + res


def unpack_auth_response(msg: bytes) -> dict:
    assert msg[1] == MSG_AUTH_RESPONSE
    return {"res": bytes(msg[3 : 3 + msg[2]])}


def pack_auth_failure(cause: int, auts: bytes | None = None) -> bytes:
    out = bytearray([PD_EMM, MSG_AUTH_FAILURE, cause])
    if auts is not None:
        out += bytes([IEI_AUTH_FAIL_PARAM, len(auts)]) + auts
    return bytes(out)


def unpack_auth_failure(msg: bytes) -> dict:
    assert msg[1] == MSG_AUTH_FAILURE
    out: dict = {"cause": msg[2]}
    tail = scan_optional(msg, 3, {IEI_AUTH_FAIL_PARAM: "tlv"})
    if IEI_AUTH_FAIL_PARAM in tail:
        out["auts"] = tail[IEI_AUTH_FAIL_PARAM][1:]
    return out


def pack_auth_reject() -> bytes:
    return bytes([PD_EMM, MSG_AUTH_REJECT])


def pack_identity_request(id_type: int = MOBILE_ID_IMSI) -> bytes:
    return bytes([PD_EMM, MSG_IDENTITY_REQUEST, id_type & 0xF])


def unpack_identity_request(msg: bytes) -> dict:
    assert msg[1] == MSG_IDENTITY_REQUEST
    return {"id_type": msg[2] & 0xF}


def pack_identity_response(imsi: str | None = None,
                           imeisv: str | None = None) -> bytes:
    return (bytes([PD_EMM, MSG_IDENTITY_RESPONSE])
            + pack_mobile_id(imsi=imsi, imeisv=imeisv))


def unpack_identity_response(msg: bytes) -> dict:
    assert msg[1] == MSG_IDENTITY_RESPONSE
    return unpack_mobile_id(msg[2:])[0]


def pack_security_mode_command(eea: int = 0, eia: int = 2, ksi: int = 0,
                               cap_eea: int = 0xE0, cap_eia: int = 0x60,
                               imeisv_request: bool = True) -> bytes:
    """SECURITY MODE COMMAND (24.301 8.2.20): selected algorithms,
    KSI, replayed UE security capabilities."""
    out = bytearray([PD_EMM, MSG_SECURITY_MODE_COMMAND,
                     ((eea & 0x7) << 4) | (eia & 0x7), ksi & 0x7,
                     2, cap_eea, cap_eia])
    if imeisv_request:
        out += bytes([(0xC << 4) | 1])
    return bytes(out)


def unpack_security_mode_command(msg: bytes) -> dict:
    assert msg[1] == MSG_SECURITY_MODE_COMMAND
    out: dict = {"eea": (msg[2] >> 4) & 0x7, "eia": msg[2] & 0x7,
                 "ksi": msg[3] & 0x7}
    n = msg[4]
    out["cap_eea"], out["cap_eia"] = msg[5], msg[6]
    pos = 5 + n
    tail = scan_optional(msg, pos, {0xC: "nib"})
    out["imeisv_request"] = tail.get(0xC) == 1
    return out


def pack_security_mode_complete(imeisv: str | None = None) -> bytes:
    out = bytearray([PD_EMM, MSG_SECURITY_MODE_COMPLETE])
    if imeisv is not None:
        out += bytes([0x23]) + pack_mobile_id(imeisv=imeisv)
    return bytes(out)


def pack_security_mode_reject(cause: int) -> bytes:
    return bytes([PD_EMM, MSG_SECURITY_MODE_REJECT, cause])


def pack_emm_information(full_name: str | None = None,
                         short_name: str | None = None,
                         local_tz: int | None = None) -> bytes:
    """EMM INFORMATION (24.301 8.2.13)."""
    out = bytearray([PD_EMM, MSG_EMM_INFORMATION])
    if full_name is not None:
        out += bytes([IEI_FULL_NET_NAME]) + pack_network_name(full_name)
    if short_name is not None:
        out += bytes([IEI_SHORT_NET_NAME]) + pack_network_name(short_name)
    if local_tz is not None:
        out += bytes([IEI_LOCAL_TIME_ZONE, local_tz])
    return bytes(out)


def unpack_emm_information(msg: bytes) -> dict:
    assert msg[1] == MSG_EMM_INFORMATION
    tail = scan_optional(msg, 2, {IEI_FULL_NET_NAME: "tlv",
                                  IEI_SHORT_NET_NAME: "tlv",
                                  IEI_LOCAL_TIME_ZONE: "tv1"})
    out: dict = {}
    if IEI_FULL_NET_NAME in tail:
        out["full_name"] = unpack_network_name(tail[IEI_FULL_NET_NAME])[0]
    if IEI_SHORT_NET_NAME in tail:
        out["short_name"] = unpack_network_name(tail[IEI_SHORT_NET_NAME])[0]
    if IEI_LOCAL_TIME_ZONE in tail:
        out["local_tz"] = tail[IEI_LOCAL_TIME_ZONE]
    return out


def pack_emm_status(cause: int) -> bytes:
    return bytes([PD_EMM, MSG_EMM_STATUS, cause])


def pack_detach_request_ue(guti: Guti, switch_off: bool = True,
                           detach_type: int = DETACH_EPS,
                           ksi: int = 0) -> bytes:
    """UE-originating DETACH REQUEST (24.301 8.2.11.1)."""
    dt = (int(switch_off) << 3) | (detach_type & 0x7)
    return (bytes([PD_EMM, MSG_DETACH_REQUEST, ((ksi & 0x7) << 4) | dt])
            + pack_eps_mobile_id(guti=guti))


def unpack_detach_request_ue(msg: bytes) -> dict:
    assert msg[1] == MSG_DETACH_REQUEST
    out: dict = {"switch_off": bool(msg[2] & 0x8),
                 "detach_type": msg[2] & 0x7, "ksi": (msg[2] >> 4) & 0x7}
    out.update(unpack_eps_mobile_id(msg[3:])[0])
    return out


def pack_detach_request_net(
        detach_type: int = DETACH_REATTACH_NOT_REQUIRED) -> bytes:
    """Network-originating DETACH REQUEST (24.301 8.2.11.2)."""
    return bytes([PD_EMM, MSG_DETACH_REQUEST, detach_type & 0x7])


def pack_detach_accept() -> bytes:
    return bytes([PD_EMM, MSG_DETACH_ACCEPT])


def pack_service_reject(cause: int,
                        t3442: tuple[int, int] | None = None) -> bytes:
    out = bytearray([PD_EMM, MSG_SERVICE_REJECT, cause])
    if t3442 is not None:
        out += bytes([IEI_T3442]) + pack_gprs_timer(*t3442)
    return bytes(out)


def unpack_service_reject(msg: bytes) -> dict:
    assert msg[1] == MSG_SERVICE_REJECT
    out: dict = {"cause": msg[2]}
    tail = scan_optional(msg, 3, {IEI_T3442: "tv1"})
    if IEI_T3442 in tail:
        out["t3442"] = unpack_gprs_timer(tail[IEI_T3442])
    return out


def pack_service_accept() -> bytes:
    return bytes([PD_EMM, MSG_SERVICE_ACCEPT])


def pack_tau_request(guti: Guti, ksi: int = 0,
                     update_type: int = UPDATE_TYPE_TA, active: bool = False,
                     eea: int | None = None, eia: int | None = None,
                     last_tai: tuple[str, int] | None = None) -> bytes:
    """TRACKING AREA UPDATE REQUEST (24.301 8.2.29; the reference codec
    has no TAU-request pack — liblte_mme.h:3327 'FIXME' — so this follows
    the spec layout directly, validated by round-trip tests)."""
    ut = (int(active) << 3) | (update_type & 0x7)
    out = bytearray([PD_EMM, MSG_TAU_REQUEST, ((ksi & 0x7) << 4) | ut])
    out += pack_eps_mobile_id(guti=guti)
    if eea is not None and eia is not None:
        out += bytes([IEI_UE_NET_CAP_TAU]) + pack_ue_net_cap(eea, eia)
    if last_tai is not None:
        out += bytes([IEI_LAST_VISITED_TAI]) + pack_tai(*last_tai)
    return bytes(out)


def unpack_tau_request(msg: bytes) -> dict:
    assert msg[1] == MSG_TAU_REQUEST
    out: dict = {"ksi": (msg[2] >> 4) & 0x7, "update_type": msg[2] & 0x7,
                 "active": bool(msg[2] & 0x8)}
    ident, used = unpack_eps_mobile_id(msg[3:])
    out.update(ident)
    tail = scan_optional(msg, 3 + used, {IEI_UE_NET_CAP_TAU: "tlv",
                                         IEI_LAST_VISITED_TAI: "tv5"})
    if IEI_UE_NET_CAP_TAU in tail:
        out["ue_net_cap"] = unpack_ue_net_cap(tail[IEI_UE_NET_CAP_TAU])[0]
    if IEI_LAST_VISITED_TAI in tail:
        out["last_tai"] = unpack_tai(tail[IEI_LAST_VISITED_TAI])
    return out


def pack_tau_accept(result: int = UPDATE_RESULT_TA,
                    t3412: tuple[int, int] | None = None,
                    guti: Guti | None = None,
                    tai_list: list[tuple[str, int]] | None = None) -> bytes:
    """TRACKING AREA UPDATE ACCEPT (24.301 8.2.26)."""
    out = bytearray([PD_EMM, MSG_TAU_ACCEPT, result & 0xF])
    if t3412 is not None:
        out += bytes([IEI_T3412_TAU]) + pack_gprs_timer(*t3412)
    if guti is not None:
        out += bytes([IEI_GUTI]) + pack_eps_mobile_id(guti=guti)
    if tai_list is not None:
        out += bytes([IEI_TAI_LIST]) + pack_tai_list(tai_list)
    return bytes(out)


def unpack_tau_accept(msg: bytes) -> dict:
    assert msg[1] == MSG_TAU_ACCEPT
    out: dict = {"result": msg[2] & 0xF}
    tail = scan_optional(msg, 3, {IEI_T3412_TAU: "tv1", IEI_GUTI: "tlv",
                                  IEI_TAI_LIST: "tlv"})
    if IEI_T3412_TAU in tail:
        out["t3412"] = unpack_gprs_timer(tail[IEI_T3412_TAU])
    if IEI_GUTI in tail:
        out["guti"] = unpack_eps_mobile_id(tail[IEI_GUTI])[0]["guti"]
    if IEI_TAI_LIST in tail:
        out["tai_list"] = unpack_tai_list(tail[IEI_TAI_LIST])[0]
    return out


def pack_tau_complete() -> bytes:
    return bytes([PD_EMM, MSG_TAU_COMPLETE])


def pack_tau_reject(cause: int) -> bytes:
    return bytes([PD_EMM, MSG_TAU_REJECT, cause])


def unpack_tau_reject(msg: bytes) -> dict:
    assert msg[1] == MSG_TAU_REJECT
    return {"cause": msg[2]}


def pack_guti_reallocation_command(
        guti: Guti,
        tai_list: list[tuple[str, int]] | None = None) -> bytes:
    out = bytearray([PD_EMM, MSG_GUTI_REALLOCATION_COMMAND])
    out += pack_eps_mobile_id(guti=guti)
    if tai_list is not None:
        out += bytes([IEI_TAI_LIST]) + pack_tai_list(tai_list)
    return bytes(out)


def unpack_guti_reallocation_command(msg: bytes) -> dict:
    assert msg[1] == MSG_GUTI_REALLOCATION_COMMAND
    ident, used = unpack_eps_mobile_id(msg[2:])
    out: dict = dict(ident)
    tail = scan_optional(msg, 2 + used, {IEI_TAI_LIST: "tlv"})
    if IEI_TAI_LIST in tail:
        out["tai_list"] = unpack_tai_list(tail[IEI_TAI_LIST])[0]
    return out


def pack_guti_reallocation_complete() -> bytes:
    return bytes([PD_EMM, MSG_GUTI_REALLOCATION_COMPLETE])


def pack_extended_service_request(tmsi: int, service_type: int = 0,
                                  ksi: int = 0) -> bytes:
    """EXTENDED SERVICE REQUEST (24.301 8.2.15)."""
    return (bytes([PD_EMM, MSG_EXTENDED_SERVICE_REQUEST,
                   ((ksi & 0x7) << 4) | (service_type & 0xF)])
            + pack_mobile_id(tmsi=tmsi))


def unpack_extended_service_request(msg: bytes) -> dict:
    assert msg[1] == MSG_EXTENDED_SERVICE_REQUEST
    out: dict = {"ksi": (msg[2] >> 4) & 0x7, "service_type": msg[2] & 0xF}
    out.update(unpack_mobile_id(msg[3:])[0])
    return out


def pack_nas_transport(nas_msg: bytes, downlink: bool = True) -> bytes:
    """DL/UL NAS TRANSPORT (24.301 8.2.12 / 8.2.30: SMS container)."""
    mt = MSG_DL_NAS_TRANSPORT if downlink else MSG_UL_NAS_TRANSPORT
    return bytes([PD_EMM, mt, len(nas_msg)]) + nas_msg


def unpack_nas_transport(msg: bytes) -> dict:
    assert msg[1] in (MSG_DL_NAS_TRANSPORT, MSG_UL_NAS_TRANSPORT)
    return {"nas_msg": bytes(msg[3 : 3 + msg[2]])}


# --------------------------------------------------------------------------
# ESM messages
# --------------------------------------------------------------------------


def _esm_header(ebi: int, pti: int, msg_type: int) -> bytes:
    return bytes([((ebi & 0xF) << 4) | PD_ESM, pti, msg_type])


def esm_header(msg: bytes) -> tuple[int, int, int]:
    """-> (eps_bearer_id, proc_transaction_id, msg_type)."""
    return (msg[0] >> 4) & 0xF, msg[1], msg[2]


def pack_pdn_connectivity_request(pti: int = 1,
                                  pdn_type: int = PDN_TYPE_IPV4,
                                  request_type: int = REQUEST_TYPE_INITIAL,
                                  esm_info_transfer: bool | None = None,
                                  apn: str | None = None,
                                  pco: list | None = None) -> bytes:
    """PDN CONNECTIVITY REQUEST (24.301 8.3.20)."""
    out = bytearray(_esm_header(0, pti, ESM_PDN_CONNECTIVITY_REQUEST))
    out += bytes([((pdn_type & 0x7) << 4) | (request_type & 0x7)])
    if esm_info_transfer is not None:
        out += bytes([(0xD << 4) | int(esm_info_transfer)])
    if apn is not None:
        out += bytes([0x28]) + pack_apn(apn)
    if pco is not None:
        out += bytes([0x27]) + pack_pco(pco)
    return bytes(out)


def unpack_pdn_connectivity_request(msg: bytes) -> dict:
    ebi, pti, mt = esm_header(msg)
    assert mt == ESM_PDN_CONNECTIVITY_REQUEST
    out: dict = {"pti": pti, "pdn_type": (msg[3] >> 4) & 0x7,
                 "request_type": msg[3] & 0x7}
    tail = scan_optional(msg, 4, {0xD: "nib", 0x28: "tlv", 0x27: "tlv"})
    if 0xD in tail:
        out["esm_info_transfer"] = bool(tail[0xD])
    if 0x28 in tail:
        out["apn"] = unpack_apn(tail[0x28])[0]
    if 0x27 in tail:
        out["pco"] = unpack_pco(tail[0x27])[0]
    return out


def pack_pdn_connectivity_reject(pti: int, cause: int) -> bytes:
    return (_esm_header(0, pti, ESM_PDN_CONNECTIVITY_REJECT)
            + bytes([cause]))


def pack_esm_information_request(pti: int = 1) -> bytes:
    return _esm_header(0, pti, ESM_INFORMATION_REQUEST)


def pack_esm_information_response(pti: int = 1, apn: str | None = None,
                                  pco: list | None = None) -> bytes:
    out = bytearray(_esm_header(0, pti, ESM_INFORMATION_RESPONSE))
    if apn is not None:
        out += bytes([0x28]) + pack_apn(apn)
    if pco is not None:
        out += bytes([0x27]) + pack_pco(pco)
    return bytes(out)


def unpack_esm_information_response(msg: bytes) -> dict:
    _, pti, mt = esm_header(msg)
    assert mt == ESM_INFORMATION_RESPONSE
    out: dict = {"pti": pti}
    tail = scan_optional(msg, 3, {0x28: "tlv", 0x27: "tlv"})
    if 0x28 in tail:
        out["apn"] = unpack_apn(tail[0x28])[0]
    if 0x27 in tail:
        out["pco"] = unpack_pco(tail[0x27])[0]
    return out


def pack_activate_default_bearer_request(
        ebi: int, pti: int, apn: str, addr: bytes, qci: int = 9,
        pdn_type: int = PDN_TYPE_IPV4,
        apn_ambr: tuple[int, int] | None = None,
        pco: list | None = None) -> bytes:
    """ACTIVATE DEFAULT EPS BEARER CONTEXT REQUEST (24.301 8.3.6)."""
    out = bytearray(_esm_header(ebi, pti,
                                ESM_ACTIVATE_DEFAULT_BEARER_REQUEST))
    out += pack_eps_qos(qci)
    out += pack_apn(apn)
    out += pack_pdn_address(pdn_type, addr)
    if apn_ambr is not None:
        dl, ul = apn_ambr
        out += bytes([0x5E, 2, dl, ul])
    if pco is not None:
        out += bytes([0x27]) + pack_pco(pco)
    return bytes(out)


def unpack_activate_default_bearer_request(msg: bytes) -> dict:
    ebi, pti, mt = esm_header(msg)
    assert mt == ESM_ACTIVATE_DEFAULT_BEARER_REQUEST
    out: dict = {"ebi": ebi, "pti": pti}
    pos = 3
    qos, used = unpack_eps_qos(msg[pos:])
    out["qci"] = qos["qci"]
    pos += used
    out["apn"], used = unpack_apn(msg[pos:])
    pos += used
    pdn, used = unpack_pdn_address(msg[pos:])
    out.update(pdn_type=pdn["pdn_type"], addr=pdn["addr"])
    pos += used
    tail = scan_optional(msg, pos, {0x5E: "tlv", 0x27: "tlv"})
    if 0x5E in tail:
        out["apn_ambr"] = (tail[0x5E][1], tail[0x5E][2])
    if 0x27 in tail:
        out["pco"] = unpack_pco(tail[0x27])[0]
    return out


def pack_activate_default_bearer_accept(ebi: int, pti: int) -> bytes:
    return _esm_header(ebi, pti, ESM_ACTIVATE_DEFAULT_BEARER_ACCEPT)


def pack_activate_default_bearer_reject(ebi: int, pti: int,
                                        cause: int) -> bytes:
    return (_esm_header(ebi, pti, ESM_ACTIVATE_DEFAULT_BEARER_REJECT)
            + bytes([cause]))


def pack_activate_dedicated_bearer_request(
        ebi: int, pti: int, linked_ebi: int,
        qci: int, mbr_ul: int, mbr_dl: int, gbr_ul: int, gbr_dl: int,
        tft_filters: list[tuple[int, int, int, bytes]],
        tft_op: int = TFT_OP_CREATE) -> bytes:
    """ACTIVATE DEDICATED EPS BEARER CONTEXT REQUEST (24.301 8.3.3)."""
    out = bytearray(_esm_header(ebi, pti,
                                ESM_ACTIVATE_DEDICATED_BEARER_REQUEST))
    out += bytes([linked_ebi & 0xF])
    out += pack_eps_qos(qci, mbr_ul, mbr_dl, gbr_ul, gbr_dl)
    out += pack_tft(tft_op, tft_filters)
    return bytes(out)


def unpack_activate_dedicated_bearer_request(msg: bytes) -> dict:
    ebi, pti, mt = esm_header(msg)
    assert mt == ESM_ACTIVATE_DEDICATED_BEARER_REQUEST
    out: dict = {"ebi": ebi, "pti": pti, "linked_ebi": msg[3] & 0xF}
    pos = 4
    qos, used = unpack_eps_qos(msg[pos:])
    out["qos"] = qos
    pos += used
    tft, used = unpack_tft(msg[pos:])
    out["tft"] = tft
    return out


def pack_activate_dedicated_bearer_accept(ebi: int, pti: int) -> bytes:
    return _esm_header(ebi, pti, ESM_ACTIVATE_DEDICATED_BEARER_ACCEPT)


def pack_deactivate_bearer_request(ebi: int, pti: int,
                                   cause: int) -> bytes:
    return (_esm_header(ebi, pti, ESM_DEACTIVATE_BEARER_REQUEST)
            + bytes([cause]))


def unpack_deactivate_bearer_request(msg: bytes) -> dict:
    ebi, pti, mt = esm_header(msg)
    assert mt == ESM_DEACTIVATE_BEARER_REQUEST
    return {"ebi": ebi, "pti": pti, "cause": msg[3]}


def pack_deactivate_bearer_accept(ebi: int, pti: int) -> bytes:
    return _esm_header(ebi, pti, ESM_DEACTIVATE_BEARER_ACCEPT)


def pack_pdn_disconnect_request(pti: int, linked_ebi: int) -> bytes:
    return (_esm_header(0, pti, ESM_PDN_DISCONNECT_REQUEST)
            + bytes([linked_ebi & 0xF]))


def unpack_pdn_disconnect_request(msg: bytes) -> dict:
    _, pti, mt = esm_header(msg)
    assert mt == ESM_PDN_DISCONNECT_REQUEST
    return {"pti": pti, "linked_ebi": msg[3] & 0xF}


def pack_esm_status(ebi: int, pti: int, cause: int) -> bytes:
    return _esm_header(ebi, pti, ESM_STATUS) + bytes([cause])


# --------------------------------------------------------------------------
# security header (24.301 9.1/9.2 + 9.3; MAC computed as the reference
# does in srsue nas.cc integrity_generate: EIA over SEQ|message)
# --------------------------------------------------------------------------


def add_sec_header(inner: bytes, sh: int, seq: int) -> bytes:
    """Security-protected framing with a zeroed MAC (what the reference's
    liblte_mme_pack_security_protected_nas_msg emits before the caller
    fills the MAC)."""
    return (bytes([(sh << 4) | PD_EMM]) + b"\x00\x00\x00\x00"
            + bytes([seq & 0xFF]) + inner)


def nas_mac(k_nas_int: bytes, count: int, direction: int,
            data: bytes, eia: int = 2) -> bytes:
    """EPS NAS integrity MAC (33.401; EIA1=SNOW3G, EIA2=AES-CMAC)."""
    if eia == 1:
        return security.eia1(k_nas_int, count, 0, direction, data)
    return security.eia2(k_nas_int, count, 0, direction, data)


def protect(msg: bytes, k_nas_int: bytes, count: int, direction: int,
            sh: int = SH_INTEGRITY_CIPHERED, eia: int = 2,
            k_nas_enc: bytes | None = None, eea: int = 0) -> bytes:
    """Wrap a plain NAS message with the security header: [SH|PD, MAC(4),
    SEQ, inner]; inner optionally ciphered (EEA1/EEA2) before the MAC is
    computed over SEQ|inner, as the reference stack does."""
    seq = count & 0xFF
    body = msg
    if eea and k_nas_enc is not None:
        cipher = security.eea1 if eea == 1 else security.eea2
        body = cipher(k_nas_enc, count, 0, direction, msg)
    mac = nas_mac(k_nas_int, count, direction, bytes([seq]) + body, eia)
    return bytes([(sh << 4) | PD_EMM]) + mac + bytes([seq]) + body


def unprotect(pdu: bytes, k_nas_int: bytes, count: int, direction: int,
              eia: int = 2, k_nas_enc: bytes | None = None,
              eea: int = 0) -> bytes | None:
    """Verify + strip the security header; None on MAC failure. Plain
    messages pass through. The receiver substitutes the received SEQ
    into its local count estimate (24.301 4.4.3.3)."""
    sh = pdu[0] >> 4
    if sh == SH_PLAIN:
        return pdu
    mac, seq, body = pdu[1:5], pdu[5], pdu[6:]
    est = (count & ~0xFF) | seq
    exp = nas_mac(k_nas_int, est, direction, bytes([seq]) + body, eia)
    if mac != exp:
        return None
    if eea and k_nas_enc is not None and sh in (
            SH_INTEGRITY_CIPHERED, SH_INTEGRITY_CIPHERED_NEW_CTX):
        cipher = security.eea1 if eea == 1 else security.eea2
        body = cipher(k_nas_enc, est, 0, direction, body)
    return body


def sec_header_type(pdu: bytes) -> int:
    return pdu[0] >> 4


def is_plain_emm(pdu: bytes) -> bool:
    return (pdu[0] & 0xF) == PD_EMM and (pdu[0] >> 4) == SH_PLAIN


def is_esm(pdu: bytes) -> bool:
    return (pdu[0] & 0xF) == PD_ESM


# --- Service Request (24.301 9.1: its own compact security header) --------


def service_request_mac(k_nas_int: bytes, count: int, ksi: int = 0) -> bytes:
    """Short MAC (2 bytes): truncated EIA2 over the KSI|SEQ byte
    (24.301 9.9.3.28: the short MAC covers the message's first two
    octets sans MAC)."""
    seq = count & 0x1F
    mac = security.eia2(k_nas_int, count, 0, 0,
                        bytes([(SH_SERVICE_REQUEST << 4) | PD_EMM,
                               ((ksi & 0x7) << 5) | seq]))
    return mac[2:4]


def pack_service_request(k_nas_int: bytes, count: int, ksi: int = 0) -> bytes:
    """SERVICE REQUEST: [SH_SERVICE_REQUEST|PD, KSI<<5|SEQ(5 bits),
    short MAC(2)] (24.301 8.2.25)."""
    seq = count & 0x1F
    return (bytes([(SH_SERVICE_REQUEST << 4) | PD_EMM,
                   ((ksi & 0x7) << 5) | seq])
            + service_request_mac(k_nas_int, count, ksi))


def is_service_request(pdu: bytes) -> bool:
    return (len(pdu) == 4 and (pdu[0] >> 4) == SH_SERVICE_REQUEST
            and (pdu[0] & 0xF) == PD_EMM)


def verify_service_request(pdu: bytes, k_nas_int: bytes, count: int) -> bool:
    """Checks the short MAC against the expected UL count (the receiver
    substitutes the 5-bit SEQ into its local count estimate)."""
    seq = pdu[1] & 0x1F
    ksi = (pdu[1] >> 5) & 0x7
    est = (count & ~0x1F) | seq
    return service_request_mac(k_nas_int, est, ksi) == pdu[2:]


def pack_service_request_raw(ksi: int, seq: int, short_mac: int) -> bytes:
    """Raw field variant (for oracle parity tests)."""
    return (bytes([(SH_SERVICE_REQUEST << 4) | PD_EMM,
                   ((ksi & 0x7) << 5) | (seq & 0x1F)])
            + short_mac.to_bytes(2, "big"))
