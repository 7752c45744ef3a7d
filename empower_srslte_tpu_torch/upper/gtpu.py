"""GTP-U user-plane header encode/decode (lib/src/upper/gtpu.cc parity;
29.281 v8): version 1, PT=1, message type 255 (G-PDU), TEID addressing.
"""

from __future__ import annotations

import struct

GTPU_VERSION = 1
GTPU_PT = 1
MSG_GPDU = 0xFF
GTPU_PORT = 2152
HEADER_LEN = 8


def gtpu_pack(teid: int, payload: bytes, msg_type: int = MSG_GPDU) -> bytes:
    """Prepend the 8-byte GTP-U header (gtpu_write_header analog)."""
    flags = (GTPU_VERSION << 5) | (GTPU_PT << 4)
    return struct.pack("!BBHI", flags, msg_type, len(payload), teid) + payload


def gtpu_unpack(pdu: bytes) -> tuple[int, bytes]:
    """GTP-U PDU -> (teid, payload); raises on malformed headers
    (gtpu_read_header analog)."""
    if len(pdu) < HEADER_LEN:
        raise ValueError("GTP-U PDU too short")
    flags, msg_type, length, teid = struct.unpack("!BBHI", pdu[:HEADER_LEN])
    if (flags >> 5) != GTPU_VERSION:
        raise ValueError(f"unsupported GTP version {flags >> 5}")
    if not flags & 0x10:
        raise ValueError("GTP' not supported")
    if msg_type != MSG_GPDU:
        raise ValueError(f"unsupported message type {msg_type:#x}")
    payload = pdu[HEADER_LEN : HEADER_LEN + length]
    if len(payload) != length:
        raise ValueError("truncated GTP-U payload")
    return teid, payload
