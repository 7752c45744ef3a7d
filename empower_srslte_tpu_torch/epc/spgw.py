"""SP-GW: user-plane gateway (srsepc/src/spgw/spgw.cc parity).

TEID/session management and GTP-U tunnel forwarding between the SGi side
(IP packets, the reference's TUN interface) and the S1-U side (GTP-U over
UDP to the eNB). Transport is pluggable so tests run in memory; the UDP
path uses runtime/io-style sockets.
"""

from __future__ import annotations

import ipaddress
from dataclasses import dataclass

from ..upper.gtpu import gtpu_pack, gtpu_unpack


@dataclass
class Session:
    imsi: str
    ue_ip: str
    teid_out: int       # eNB's TEID (what we put in downlink GTP-U)
    teid_in: int        # our TEID (what the eNB addresses uplink to)
    enb_addr: tuple | None = None


class SpGw:
    """Session table + forwarding logic."""

    def __init__(self, ue_subnet: str = "172.16.0.0/24"):
        self._net = ipaddress.ip_network(ue_subnet)
        self._hosts = self._net.hosts()
        next(self._hosts)  # skip gateway address
        self._next_teid = 1
        self._by_teid_in: dict[int, Session] = {}
        self._by_ue_ip: dict[str, Session] = {}

    # --- session management (gtpc create-session analog) ---------------------

    def create_session(self, imsi: str, enb_teid: int,
                       enb_addr: tuple | None = None) -> Session:
        ue_ip = str(next(self._hosts))
        sess = Session(imsi=imsi, ue_ip=ue_ip, teid_out=enb_teid,
                       teid_in=self._next_teid, enb_addr=enb_addr)
        self._next_teid += 1
        self._by_teid_in[sess.teid_in] = sess
        self._by_ue_ip[ue_ip] = sess
        return sess

    def session_by_teid(self, teid_in: int) -> Session | None:
        return self._by_teid_in.get(teid_in)

    def delete_session(self, imsi: str) -> None:
        for t, s in list(self._by_teid_in.items()):
            if s.imsi == imsi:
                del self._by_teid_in[t]
                self._by_ue_ip.pop(s.ue_ip, None)

    # --- user plane ----------------------------------------------------------

    def downlink(self, ip_packet: bytes) -> tuple[Session, bytes] | None:
        """SGi -> S1-U: wrap an IP packet for the UE it addresses
        (spgw.cc handle_sgi_pdu)."""
        if len(ip_packet) < 20:
            return None
        dst = str(ipaddress.ip_address(ip_packet[16:20]))
        sess = self._by_ue_ip.get(dst)
        if sess is None:
            return None
        return sess, gtpu_pack(sess.teid_out, ip_packet)

    def uplink(self, gtpu_pdu: bytes) -> bytes | None:
        """S1-U -> SGi: unwrap an uplink GTP-U PDU
        (spgw.cc handle_s1u_pdu); None for unknown TEIDs."""
        try:
            teid, payload = gtpu_unpack(gtpu_pdu)
        except ValueError:
            return None
        if teid not in self._by_teid_in:
            return None
        return payload
