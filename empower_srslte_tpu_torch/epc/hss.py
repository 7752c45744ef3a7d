"""HSS: subscriber database + EPS authentication vectors
(srsepc/src/hss/hss.cc parity).

Subscribers load from the reference's user_db.csv format
(name,auth,imsi,key,op_type,op/opc,amf,sqn,qci,...); authentication
vectors use Milenage (or the test-mode XOR algorithm) per 33.401 6.1:
AV = (RAND, XRES, AUTN, K_ASME).
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

from ..upper import security


@dataclass
class Subscriber:
    name: str
    auth_algo: str            # "mil" | "xor"
    imsi: str
    key: bytes
    opc: bytes
    amf: bytes = b"\x80\x00"
    sqn: int = 0


def _kdf_hmac_sha256(key: bytes, s: bytes) -> bytes:
    """33.220 generic KDF (HMAC-SHA-256)."""
    import hmac

    return hmac.new(key, s, hashlib.sha256).digest()


def kasme_derive(ck: bytes, ik: bytes, plmn: bytes, sqn_xor_ak: bytes) -> bytes:
    """K_ASME derivation (33.401 A.2):
    S = FC(0x10) || PLMN || L_plmn || (SQN^AK) || L_sqnak."""
    s = (b"\x10" + plmn + bytes([0, len(plmn)])
         + sqn_xor_ak + bytes([0, len(sqn_xor_ak)]))
    return _kdf_hmac_sha256(ck + ik, s)


class Hss:
    """Subscriber registry + AV generation."""

    def __init__(self):
        self._by_imsi: dict[str, Subscriber] = {}

    # --- database (user_db.csv format) --------------------------------------

    def add_subscriber(self, sub: Subscriber) -> None:
        self._by_imsi[sub.imsi] = sub

    def load_csv(self, path: str) -> int:
        """Parse the reference's user_db.csv rows:
        name,auth,imsi,key,op_type,op_value,amf,sqn,...
        """
        n = 0
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split(",")
                name, auth, imsi, key_hex, op_type, op_hex, amf_hex, sqn_hex = parts[:8]
                key = bytes.fromhex(key_hex)
                op = bytes.fromhex(op_hex)
                opc = op if op_type == "opc" else security.milenage_opc(key, op)
                self.add_subscriber(Subscriber(
                    name=name, auth_algo=auth, imsi=imsi, key=key, opc=opc,
                    amf=bytes.fromhex(amf_hex), sqn=int(sqn_hex, 16)))
                n += 1
        return n

    def get(self, imsi: str) -> Subscriber | None:
        return self._by_imsi.get(imsi)

    # --- authentication (hss.cc gen_auth_info_answer) ------------------------

    def generate_av(self, imsi: str, plmn: bytes = b"\x00\xf1\x10",
                    rand: bytes | None = None) -> dict | None:
        sub = self.get(imsi)
        if sub is None:
            return None
        if rand is None:
            rand = os.urandom(16)
        sqn = sub.sqn.to_bytes(6, "big")
        if sub.auth_algo == "xor":
            # 34.108 test algorithm: XDOUT = K xor RAND
            xdout = bytes(a ^ b for a, b in zip(sub.key, rand))
            xres = xdout[:8]
            ck = xdout[1:] + xdout[:1]
            ik = xdout[2:] + xdout[:2]
            ak = xdout[3:9][:6]
            mac_a = xdout[:8]
        else:
            mac_a, _ = security.milenage_f1(sub.key, sub.opc, rand, sqn, sub.amf)
            xres, ck, ik, ak = security.milenage_f2345(sub.key, sub.opc, rand)
        sqn_xor_ak = bytes(a ^ b for a, b in zip(sqn, ak))
        autn = sqn_xor_ak + sub.amf + mac_a
        kasme = kasme_derive(ck, ik, plmn, sqn_xor_ak)
        sub.sqn += 1
        return dict(rand=rand, xres=xres, autn=autn, kasme=kasme,
                    ck=ck, ik=ik)

    def resync_sqn(self, imsi: str, sqn: int) -> None:
        """AUTS resynchronization (simplified): jump to the UE's SQN."""
        sub = self.get(imsi)
        if sub:
            sub.sqn = sqn + 1
