"""MBMS gateway (srsepc/src/mbms-gw/mbms-gw.cc parity).

The reference gateway reads multicast downlink IP from an SGi-mb TUN
device (mbms-gw.cc:126-208 init_sgi_mb_if), sanity-checks the IPv4
header, encapsulates into GTP-U with the fixed MBMS TEID 0xAAAA
(mbms-gw.cc:290-299 handle_sgi_md_pdu) and sends it on the M1-U UDP
multicast socket at GTPU port + 1 = 2153 (mbms-gw.cc:210-257 init_m1_u,
multicast interface + TTL options).

This build keeps the same pipeline with three delivery modes:

* **in-process callbacks** (``add_enb``) — the OTA test path, feeding
  the eNB stack's M1 ingest directly;
* **M1-U UDP socket** (``open_m1u``) — real datagrams to a multicast
  (or unicast, for containers without multicast routing) address, the
  eNB side receiving via ``M1uReceiver``;
* **SGi-mb TUN pump** (``serve_sgi_mb``) — a kernel TUN device as the
  ingest side, mirroring init_sgi_mb_if (requires CAP_NET_ADMIN).
"""

from __future__ import annotations

import socket
import struct
from dataclasses import dataclass, field

from ..upper.gtpu import GTPU_PORT, gtpu_pack, gtpu_unpack

MBMS_TEID = 0xAAAA
#: M1-U rides GTPU_RX_PORT + 1 (mbms-gw.cc:251).
M1U_PORT = GTPU_PORT + 1
DEFAULT_M1U_ADDR = "239.255.0.1"


@dataclass
class MbmsGw:
    teid: int = MBMS_TEID
    enbs: list = field(default_factory=list)   # delivery callbacks
    stats_tx: int = 0
    stats_dropped: int = 0
    _m1u_sock: socket.socket | None = None
    _m1u_dest: tuple | None = None

    def add_enb(self, deliver) -> None:
        """deliver(gtpu_pdu: bytes) — the eNB's M1 ingest."""
        self.enbs.append(deliver)

    # --- M1-U socket mode (init_m1_u, mbms-gw.cc:210) -------------------

    def open_m1u(self, addr: str = DEFAULT_M1U_ADDR, port: int = M1U_PORT,
                 ttl: int = 1, multicast_if: str | None = None) -> None:
        """Open the M1-U UDP sender; multicast options applied when the
        target is a multicast group (IP_MULTICAST_TTL/IF/LOOP as in the
        reference), plain unicast otherwise."""
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        if int(addr.split(".")[0]) >= 224:          # multicast group
            s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_TTL, ttl)
            s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_LOOP, 0)
            if multicast_if:
                s.setsockopt(socket.IPPROTO_IP, socket.IP_MULTICAST_IF,
                             socket.inet_aton(multicast_if))
        self._m1u_sock = s
        self._m1u_dest = (addr, port)

    def close(self) -> None:
        if self._m1u_sock is not None:
            self._m1u_sock.close()
            self._m1u_sock = None

    # --- SGi-mb ingest (handle_sgi_md_pdu, mbms-gw.cc:288) --------------

    def forward(self, ip_packet: bytes) -> bytes | None:
        """Encapsulate one downlink IP packet and fan it to every eNB.

        Sanity checks mirror the reference: minimum IPv4 header length
        and version 4 only (mbms-gw.cc:300-310)."""
        if len(ip_packet) < 20 or (ip_packet[0] >> 4) != 4:
            self.stats_dropped += 1
            return None
        pdu = gtpu_pack(self.teid, ip_packet)
        for deliver in self.enbs:
            deliver(pdu)
        if self._m1u_sock is not None:
            self._m1u_sock.sendto(pdu, self._m1u_dest)
        self.stats_tx += 1
        return pdu

    def serve_sgi_mb(self, if_name: str = "sgi_mb",
                     if_cidr: str = "172.16.1.1/24",
                     max_packets: int | None = None,
                     timeout: float = 0.5) -> int:
        """Pump the SGi-mb TUN device into ``forward`` (run_thread,
        mbms-gw.cc:259-286). Blocking; returns packets forwarded (stops
        at ``max_packets`` or after a ``timeout`` with no traffic)."""
        from ..runtime.tun import TunDevice

        n = 0
        with TunDevice(if_name, if_cidr) as tun:
            while max_packets is None or n < max_packets:
                pkt = tun.read_packet(timeout=timeout)
                if pkt is None:
                    break
                if self.forward(pkt) is not None:
                    n += 1
        return n


class M1uReceiver:
    """eNB-side M1-U UDP receiver (the ingest half of the reference's
    multicast delivery; srsenb receives M1-U datagrams and feeds PMCH)."""

    def __init__(self, addr: str = "0.0.0.0", port: int = M1U_PORT,
                 group: str | None = None, timeout: float = 0.5):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((addr, port))
        if group is not None:                      # join multicast group
            mreq = struct.pack("4s4s", socket.inet_aton(group),
                               socket.inet_aton("0.0.0.0"))
            self.sock.setsockopt(socket.IPPROTO_IP,
                                 socket.IP_ADD_MEMBERSHIP, mreq)
        self.sock.settimeout(timeout)

    def recv(self, expected_teid: int = MBMS_TEID) -> bytes | None:
        """One datagram -> inner IP packet (TEID-validated), or None."""
        try:
            pdu, _ = self.sock.recvfrom(65536)
        except socket.timeout:
            return None
        return m1_ingest(pdu, expected_teid)

    def close(self) -> None:
        self.sock.close()


def m1_ingest(gtpu_pdu: bytes, expected_teid: int = MBMS_TEID) -> bytes | None:
    """eNB M1 side: validate the MBMS TEID, return the inner IP packet."""
    teid, payload = gtpu_unpack(gtpu_pdu)
    return payload if teid == expected_teid else None
