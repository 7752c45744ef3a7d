"""PDCP entity (36.323; lib/src/upper/pdcp*.cc parity).

Sequence numbering (12-bit DRB / 5-bit SRB), data-PDU header add/remove,
HFN maintenance, and ciphering/integrity via the security module's
EEA/EIA algorithms (the reference's lib_security hooks).
"""

from __future__ import annotations

from dataclasses import dataclass

from . import security


@dataclass
class PdcpConfig:
    is_control: bool = False       # SRB (5-bit SN + MAC-I) vs DRB (12-bit)
    bearer_id: int = 1
    cipher: str = "eea0"           # eea0 | eea1 | eea2
    integrity: str = "none"        # none | eia1 | eia2
    key_enc: bytes = b"\x00" * 16
    key_int: bytes = b"\x00" * 16


class PdcpEntity:
    def __init__(self, cfg: PdcpConfig | None = None):
        self.cfg = cfg or PdcpConfig()
        self.tx_sn = 0
        self.rx_sn = 0
        self.tx_hfn = 0
        self.rx_hfn = 0
        self.rx_sdus: list[bytes] = []
        self.integrity_failures = 0
        self.replays_discarded = 0
        self._last_rx_count = -1

    @property
    def _sn_mod(self) -> int:
        return 32 if self.cfg.is_control else 4096

    def _count(self, hfn: int, sn: int) -> int:
        bits = 5 if self.cfg.is_control else 12
        return (hfn << bits) | sn

    def _cipher(self, count: int, direction: int, data: bytes) -> bytes:
        if self.cfg.cipher in ("eea1", "eea2"):
            fn = security.eea1 if self.cfg.cipher == "eea1" else security.eea2
            return fn(self.cfg.key_enc, count, self.cfg.bearer_id,
                      direction, data)
        return data

    def _mac(self, count: int, direction: int, msg: bytes) -> bytes:
        fn = security.eia1 if self.cfg.integrity == "eia1" else security.eia2
        return fn(self.cfg.key_int, count, self.cfg.bearer_id, direction, msg)

    # --- TX -----------------------------------------------------------------

    def write_sdu(self, sdu: bytes, direction: int = 0) -> bytes:
        """SDU -> PDCP PDU (header + optional MAC-I, ciphered)."""
        sn = self.tx_sn
        count = self._count(self.tx_hfn, sn)
        body = sdu
        if self.cfg.is_control and self.cfg.integrity in ("eia1", "eia2"):
            header = bytes([sn & 0x1F])
            mac = self._mac(count, direction, header + sdu)
            body = sdu + mac
        body = self._cipher(count, direction, body)
        if self.cfg.is_control:
            pdu = bytes([sn & 0x1F]) + body
        else:
            pdu = bytes([0x80 | ((sn >> 8) & 0xF), sn & 0xFF]) + body
        self.tx_sn = (self.tx_sn + 1) % self._sn_mod
        if self.tx_sn == 0:
            self.tx_hfn += 1
        return pdu

    # --- RX -----------------------------------------------------------------

    def write_pdu(self, pdu: bytes, direction: int = 0) -> bytes | None:
        """PDCP PDU -> SDU (decipher + integrity check); None on failure."""
        if self.cfg.is_control:
            sn = pdu[0] & 0x1F
            body = pdu[1:]
        else:
            sn = ((pdu[0] & 0xF) << 8) | pdu[1]
            body = pdu[2:]
        # HFN advance on SN wrap (simplified window rule)
        if sn < self.rx_sn - self._sn_mod // 2:
            self.rx_hfn += 1
        self.rx_sn = sn
        count = self._count(self.rx_hfn, sn)
        if self.cfg.is_control:
            # SRB replay protection: COUNT must strictly increase (36.323
            # 5.1.2.2 discards duplicate SNs on SRBs)
            if count <= self._last_rx_count:
                self.replays_discarded += 1
                return None
            self._last_rx_count = count
        body = self._cipher(count, direction, body)
        if self.cfg.is_control and self.cfg.integrity in ("eia1", "eia2"):
            sdu, mac = body[:-4], body[-4:]
            exp = self._mac(count, direction, bytes([sn & 0x1F]) + sdu)
            if mac != exp:
                self.integrity_failures += 1
                return None
            body = sdu
        self.rx_sdus.append(body)
        return body
