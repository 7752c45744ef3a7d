"""MAC PDU packing/unpacking (36.321 6.1.2; lib/src/common/pdu.cc parity).

Subheaders (R/R/E/LCID with F/L length fields), SDU multiplexing, padding,
and the common control elements: short/long BSR, PHR, timing advance,
C-RNTI. Host-side byte logic feeding/consuming the PHY transport blocks.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# LCID values (36.321 Tables 6.2.1-1/2)
LCID_CCCH = 0
LCID_PAD = 31
# UL-SCH CEs
LCID_PHR = 26
LCID_CRNTI = 27
LCID_TRUNC_BSR = 28
LCID_SHORT_BSR = 29
LCID_LONG_BSR = 30
# DL-SCH CEs
LCID_CON_RES = 28          # UE Contention Resolution Identity (6 bytes)
LCID_TA_CMD = 29
LCID_DRX_CMD = 30


@dataclass
class MacSubPdu:
    lcid: int
    payload: bytes = b""

    @property
    def is_sdu(self) -> bool:
        return self.lcid <= 10


@dataclass
class MacPdu:
    subpdus: list = field(default_factory=list)

    def add_sdu(self, lcid: int, data: bytes) -> None:
        assert 0 <= lcid <= 10
        self.subpdus.append(MacSubPdu(lcid, data))

    def add_short_bsr(self, lcg: int, buffer_index: int) -> None:
        self.subpdus.append(MacSubPdu(
            LCID_SHORT_BSR, bytes([(lcg << 6) | (buffer_index & 0x3F)])))

    def add_trunc_bsr(self, lcg: int, buffer_index: int) -> None:
        self.subpdus.append(MacSubPdu(
            LCID_TRUNC_BSR, bytes([(lcg << 6) | (buffer_index & 0x3F)])))

    def add_long_bsr(self, buffer_indexes) -> None:
        """Long BSR CE: four 6-bit indexes in 3 bytes (36.321 6.1.3.1)."""
        i0, i1, i2, i3 = (v & 0x3F for v in buffer_indexes)
        self.subpdus.append(MacSubPdu(LCID_LONG_BSR, bytes([
            (i0 << 2) | (i1 >> 4),
            ((i1 & 0xF) << 4) | (i2 >> 2),
            ((i2 & 0x3) << 6) | i3])))

    def add_phr(self, ph: int) -> None:
        self.subpdus.append(MacSubPdu(LCID_PHR, bytes([ph & 0x3F])))

    def add_crnti(self, rnti: int) -> None:
        self.subpdus.append(MacSubPdu(LCID_CRNTI, rnti.to_bytes(2, "big")))

    def add_ta_cmd(self, ta: int) -> None:
        self.subpdus.append(MacSubPdu(LCID_TA_CMD, bytes([ta & 0x3F])))

    def add_con_res(self, ident: bytes) -> None:
        """DL contention-resolution CE: first 48 bits of the msg3 CCCH SDU
        (36.321 6.1.3.4)."""
        self.subpdus.append(MacSubPdu(LCID_CON_RES, ident[:6].ljust(6,
                                                                    b"\0")))

    def pack(self, pdu_len: int) -> bytes:
        """Serialize into exactly pdu_len bytes (padding as needed)."""
        # CE sizes are implicit; SDUs carry F/L length fields on all but
        # the last subheader position
        headers = b""
        payloads = b""
        subs = list(self.subpdus)
        for i, sp in enumerate(subs):
            last = i == len(subs) - 1
            e = 0 if last else 1
            if sp.is_sdu and not last:
                l = len(sp.payload)
                if l < 128:
                    headers += bytes([(e << 5) | sp.lcid, l & 0x7F])
                else:
                    headers += bytes([(e << 5) | sp.lcid,
                                      0x80 | (l >> 8), l & 0xFF])
            else:
                headers += bytes([(e << 5) | sp.lcid])
            payloads += sp.payload
        out = headers + payloads
        if len(out) > pdu_len:
            raise ValueError(f"PDU overflow: {len(out)} > {pdu_len}")
        pad = pdu_len - len(out)
        if pad == 0:
            return out
        # trailing padding: a padding subheader then zero bytes. The last
        # real subheader must set E=1 to chain to it.
        if subs:
            # re-serialize with E=1 on the last subheader
            self_with_pad = MacPdu(subs + [MacSubPdu(LCID_PAD)])
            headers = b""
            payloads = b""
            for i, sp in enumerate(self_with_pad.subpdus):
                last = i == len(self_with_pad.subpdus) - 1
                e = 0 if last else 1
                if sp.is_sdu and not last:
                    l = len(sp.payload)
                    if l < 128:
                        headers += bytes([(e << 5) | sp.lcid, l & 0x7F])
                    else:
                        headers += bytes([(e << 5) | sp.lcid,
                                          0x80 | (l >> 8), l & 0xFF])
                else:
                    headers += bytes([(e << 5) | sp.lcid])
                payloads += sp.payload
            out = headers + payloads
        else:
            out = bytes([LCID_PAD])
        return out + b"\x00" * (pdu_len - len(out))


#: CE payload sizes differ per direction: UL lcid 28 is the truncated BSR
#: (1 byte) but DL lcid 28 is the contention-resolution identity (6 bytes)
CE_SIZES_UL = {LCID_PHR: 1, LCID_CRNTI: 2, LCID_TRUNC_BSR: 1,
               LCID_SHORT_BSR: 1, LCID_LONG_BSR: 3}
CE_SIZES_DL = {LCID_CON_RES: 6, LCID_TA_CMD: 1, LCID_DRX_CMD: 0}


def unpack_pdu(data: bytes, ul: bool = True) -> MacPdu:
    """Parse a MAC PDU byte string back into sub-PDUs."""
    heads = []
    pos = 0
    while True:
        b0 = data[pos]
        e = (b0 >> 5) & 1
        lcid = b0 & 0x1F
        pos += 1
        length = None
        if lcid <= 10 and e:  # SDU with F/L field
            b1 = data[pos]
            pos += 1
            if b1 & 0x80:
                length = ((b1 & 0x7F) << 8) | data[pos]
                pos += 1
            else:
                length = b1 & 0x7F
        heads.append((lcid, length))
        if not e:
            break
    pdu = MacPdu()
    for i, (lcid, length) in enumerate(heads):
        if lcid == LCID_PAD:
            continue
        if lcid <= 10:
            n = length if length is not None else len(data) - pos
            pdu.subpdus.append(MacSubPdu(lcid, data[pos : pos + n]))
            pos += n
        else:
            sizes = CE_SIZES_UL if ul else CE_SIZES_DL
            n = sizes.get(lcid, 0)
            pdu.subpdus.append(MacSubPdu(lcid, data[pos : pos + n]))
            pos += n
    return pdu


# --- Random Access Response (36.321 6.1.5; srsenb mac.cc RAR build) ----------


def pack_rar_pdu(rapid: int, ta: int, rb_start: int, n_prb: int, mcs: int,
                 t_crnti: int, nof_prb_ul: int) -> bytes:
    """One-RAR MAC PDU: E/T/RAPID subheader + 6-byte RAR body.

    UL grant (20 bits, 36.213 6.2): hop(1) | RB assignment (10, RIV) |
    trunc. MCS (4) | TPC (3) | UL delay (1) | CQI req (1).
    """
    from ..models import ra

    riv = ra.riv_encode(nof_prb_ul, rb_start, n_prb)
    grant = (0 << 19) | ((riv & 0x3FF) << 9) | ((mcs & 0xF) << 5) \
        | (0b001 << 2) | (0 << 1) | 0
    body = ((ta & 0x7FF) << 36) | ((grant & 0xFFFFF) << 16) \
        | (t_crnti & 0xFFFF)
    hdr = bytes([0x40 | (rapid & 0x3F)])    # E=0, T=1, RAPID
    return hdr + body.to_bytes(6, "big")


def unpack_rar_pdu(data: bytes, nof_prb_ul: int) -> dict:
    """-> {rapid, ta, rb_start, n_prb, mcs, t_crnti}."""
    from ..models import ra

    assert data[0] & 0x40, "not a RAR subheader"
    rapid = data[0] & 0x3F
    body = int.from_bytes(data[1:7], "big")
    ta = (body >> 36) & 0x7FF
    grant = (body >> 16) & 0xFFFFF
    t_crnti = body & 0xFFFF
    riv = (grant >> 9) & 0x3FF
    mcs = (grant >> 5) & 0xF
    rb_start, n_prb = ra.riv_decode(riv, nof_prb_ul)
    return {"rapid": rapid, "ta": ta, "rb_start": rb_start,
            "n_prb": n_prb, "mcs": mcs, "t_crnti": t_crnti}
