"""Wireshark pcap writers for MAC/NAS/RLC/S1AP frames.

Capability parity with lib/src/common/{mac,nas,rlc,s1ap}_pcap.cc and the
write helpers in lib/include/srslte/common/pcap.h: user DLTs 147-150,
mac-lte / rlc-lte context framing as Wireshark's heuristic dissectors
expect.
"""

from __future__ import annotations

import struct
import time

#: User DLTs (pcap.h:35-38): MAC 147, NAS 148, RLC 149, S1AP 150.
DLT_USER0 = 147
NAS_LTE_DLT = 148
RLC_LTE_DLT = 149
S1AP_LTE_DLT = 150

MAC_LTE_START = b"mac-lte"
#: mac-lte-framed tags (packet-mac-lte.h)
MAC_LTE_RNTI_TAG = 0x02
MAC_LTE_FRAME_SUBFRAME_TAG = 0x04
MAC_LTE_PAYLOAD_TAG = 0x01

RADIO_DL = 1
RADIO_UL = 2
RNTI_TYPE_C = 3


class MacPcap:
    """MAC-LTE pcap writer (srslte::mac_pcap analog)."""

    def __init__(self, path: str, ue_id: int = 0):
        self._f = open(path, "wb")
        self.ue_id = ue_id
        # pcap global header, DLT 147
        self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0,
                                  65535, DLT_USER0))

    def _packet(self, payload: bytes) -> None:
        ts = time.time()
        sec = int(ts)
        usec = int((ts - sec) * 1e6)
        self._f.write(struct.pack("<IIII", sec, usec, len(payload),
                                  len(payload)))
        self._f.write(payload)
        self._f.flush()

    def write_pdu(self, pdu: bytes, rnti: int, tti: int,
                  direction: int = RADIO_DL,
                  rnti_type: int = RNTI_TYPE_C) -> None:
        """One MAC PDU with context (mac_pcap::pack_and_write analog)."""
        ctx = bytearray()
        ctx += MAC_LTE_START
        ctx += bytes([RADIO_DL if direction == RADIO_DL else RADIO_UL,
                      rnti_type])
        ctx += bytes([MAC_LTE_RNTI_TAG]) + struct.pack(">H", rnti)
        ctx += bytes([MAC_LTE_FRAME_SUBFRAME_TAG]) + struct.pack(
            ">H", ((tti // 10) << 4) | (tti % 10))
        ctx += bytes([MAC_LTE_PAYLOAD_TAG]) + pdu
        self._packet(bytes(ctx))

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _RawPcap:
    """Base for the context-less writers (NAS DLT 148 / S1AP DLT 150 —
    pcap.h LTE_PCAP_NAS_WritePDU / LTE_PCAP_S1AP_WritePDU write the bare
    PDU after the record header)."""

    DLT = 0

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0,
                                  65535, self.DLT))

    def write_pdu(self, pdu: bytes) -> None:
        ts = time.time()
        sec = int(ts)
        usec = int((ts - sec) * 1e6)
        self._f.write(struct.pack("<IIII", sec, usec, len(pdu), len(pdu)))
        self._f.write(pdu)
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NasPcap(_RawPcap):
    """NAS-EPS pcap writer (srslte::nas_pcap analog, DLT 148)."""

    DLT = NAS_LTE_DLT


class S1apPcap(_RawPcap):
    """S1AP pcap writer (srslte::s1ap_pcap analog, DLT 150)."""

    DLT = S1AP_LTE_DLT


#: rlc-lte framing (packet-rlc-lte.h via pcap.h:156-165)
RLC_LTE_START = b"rlc-lte"
RLC_LTE_SN_LENGTH_TAG = 0x02
RLC_LTE_DIRECTION_TAG = 0x03
RLC_LTE_PRIORITY_TAG = 0x04
RLC_LTE_UEID_TAG = 0x05
RLC_LTE_CHANNEL_TYPE_TAG = 0x06
RLC_LTE_CHANNEL_ID_TAG = 0x07
RLC_LTE_PAYLOAD_TAG = 0x01

RLC_TM_MODE, RLC_UM_MODE, RLC_AM_MODE = 1, 2, 4
CHANNEL_TYPE_DRB = 4


class RlcPcap(_RawPcap):
    """RLC-LTE pcap writer (srslte::rlc_pcap analog, DLT 149): dummy UDP
    header + rlc-lte context + PDU, as LTE_PCAP_RLC_WritePDU frames it."""

    DLT = RLC_LTE_DLT

    def __init__(self, path: str, ue_id: int = 0):
        super().__init__(path)
        self.ue_id = ue_id

    def write_rlc_pdu(self, pdu: bytes, mode: int = RLC_AM_MODE,
                      direction: int = 1, channel_id: int = 1,
                      sn_length: int = 10, priority: int = 0) -> None:
        ctx = bytearray()
        # dummy UDP header the Wireshark heuristic expects
        ctx += bytes([0xDE, 0xAD, 0xBE, 0xEF])
        ctx += struct.pack("<H", len(pdu) + 12)
        ctx += bytes([0xDE, 0xAD])
        ctx += RLC_LTE_START
        ctx += bytes([mode])
        if mode == RLC_UM_MODE:
            ctx += bytes([RLC_LTE_SN_LENGTH_TAG, sn_length])
        ctx += bytes([RLC_LTE_DIRECTION_TAG, direction])
        ctx += bytes([RLC_LTE_PRIORITY_TAG, priority])
        ctx += bytes([RLC_LTE_UEID_TAG]) + struct.pack(">H", self.ue_id)
        ctx += bytes([RLC_LTE_CHANNEL_TYPE_TAG]) + struct.pack(
            ">H", CHANNEL_TYPE_DRB)
        ctx += bytes([RLC_LTE_CHANNEL_ID_TAG]) + struct.pack(
            ">H", channel_id)
        ctx += bytes([RLC_LTE_PAYLOAD_TAG])
        self.write_pdu(bytes(ctx) + pdu)
