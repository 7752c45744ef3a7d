"""LTE security algorithms (33.401; lib/src/common/liblte_security.cc
parity): EEA0 (null), 128-EEA2 (AES-CTR ciphering), 128-EIA2 (AES-CMAC
integrity) and the Milenage authentication functions (f1-f5*, used by the
HSS and USIM). AES-128 is implemented in pure Python (encrypt-only — CTR
and CMAC need only the forward cipher); no external crypto dependency.
SNOW 3G (128-EEA1 ciphering per UEA2, plus 128-EIA1/UIA2 integrity — the
reference ships only the cipher, liblte_security.h:220-251) and the 33.401
Annex A key-derivation family are implemented below.
"""

from __future__ import annotations

# --- AES-128 (FIPS-197), encrypt-only ---------------------------------------

_SBOX = None


def _build_sbox():
    global _SBOX
    if _SBOX is not None:
        return _SBOX
    # multiplicative inverse in GF(2^8) + affine transform
    def xtime(a):
        return ((a << 1) ^ 0x1B) & 0xFF if a & 0x80 else a << 1

    # build log/antilog tables with generator 3
    exp = [0] * 512
    log = [0] * 256
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x ^= xtime(x)  # multiply by 3
    for i in range(255, 512):
        exp[i] = exp[i - 255]
    sbox = [0] * 256
    for i in range(256):
        inv = 0 if i == 0 else exp[255 - log[i]]
        b = inv
        res = 0x63
        for _ in range(4):
            b = ((b << 1) | (b >> 7)) & 0xFF
            res ^= b
        sbox[i] = res ^ inv
    _SBOX = bytes(sbox)
    return _SBOX


def _gmul(a, b):
    p = 0
    for _ in range(8):
        if b & 1:
            p ^= a
        hi = a & 0x80
        a = (a << 1) & 0xFF
        if hi:
            a ^= 0x1B
        b >>= 1
    return p


_RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


def _expand_key(key: bytes) -> list[bytes]:
    sbox = _build_sbox()
    w = [list(key[4 * i : 4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]
            t = [sbox[b] for b in t]
            t[0] ^= _RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return [bytes(sum(w[4 * r : 4 * r + 4], [])) for r in range(11)]


def aes128_encrypt_block(key: bytes, block: bytes) -> bytes:
    """One AES-128 block encryption (16 bytes)."""
    sbox = _build_sbox()
    rks = _expand_key(key)
    # flat state, byte index r + 4*c (column-major like FIPS-197)
    s = list(block)

    def add_rk(s, rk):
        return [a ^ b for a, b in zip(s, rk)]

    def sub(s):
        return [sbox[b] for b in s]

    def shift_rows(s):
        out = list(s)
        for r in range(1, 4):
            row = [s[r + 4 * c] for c in range(4)]
            row = row[r:] + row[:r]
            for c in range(4):
                out[r + 4 * c] = row[c]
        return out

    def mix(s):
        out = [0] * 16
        for c in range(4):
            col = s[4 * c : 4 * c + 4]
            out[4 * c + 0] = _gmul(col[0], 2) ^ _gmul(col[1], 3) ^ col[2] ^ col[3]
            out[4 * c + 1] = col[0] ^ _gmul(col[1], 2) ^ _gmul(col[2], 3) ^ col[3]
            out[4 * c + 2] = col[0] ^ col[1] ^ _gmul(col[2], 2) ^ _gmul(col[3], 3)
            out[4 * c + 3] = _gmul(col[0], 3) ^ col[1] ^ col[2] ^ _gmul(col[3], 2)
        return out

    s = add_rk(s, rks[0])
    for rnd in range(1, 10):
        s = mix(shift_rows(sub(s)))
        s = add_rk(s, rks[rnd])
    s = shift_rows(sub(s))
    s = add_rk(s, rks[10])
    return bytes(s)


# --- 128-EEA2: AES-CTR ciphering (33.401 B.1.3) ------------------------------


def eea2(key: bytes, count: int, bearer: int, direction: int,
         data: bytes) -> bytes:
    """Cipher/decipher (symmetric): counter block T1 = COUNT | BEARER |
    DIRECTION | 0..., incremented per 16-byte block."""
    iv = (count.to_bytes(4, "big")
          + bytes([((bearer & 0x1F) << 3) | ((direction & 1) << 2)])
          + b"\x00" * 11)
    out = bytearray()
    ctr = int.from_bytes(iv, "big")
    for i in range(0, len(data), 16):
        ks = aes128_encrypt_block(key, ctr.to_bytes(16, "big"))
        chunk = data[i : i + 16]
        out += bytes(a ^ b for a, b in zip(chunk, ks))
        ctr = (ctr + 1) % (1 << 128)
    return bytes(out)


def eea0(key: bytes, count: int, bearer: int, direction: int,
         data: bytes) -> bytes:
    """Null ciphering."""
    return data


# --- 128-EIA2: AES-CMAC integrity (33.401 B.2.3) -----------------------------


def _cmac_subkeys(key: bytes):
    def dbl(b: bytes) -> bytes:
        i = int.from_bytes(b, "big") << 1
        if b[0] & 0x80:
            i ^= 0x87
        return (i & ((1 << 128) - 1)).to_bytes(16, "big")

    l = aes128_encrypt_block(key, b"\x00" * 16)
    k1 = dbl(l)
    k2 = dbl(k1)
    return k1, k2


def aes_cmac(key: bytes, msg: bytes) -> bytes:
    k1, k2 = _cmac_subkeys(key)
    n = max(1, (len(msg) + 15) // 16)
    full = len(msg) and len(msg) % 16 == 0
    blocks = [msg[16 * i : 16 * i + 16] for i in range(n)]
    last = blocks[-1]
    if full:
        last = bytes(a ^ b for a, b in zip(last, k1))
    else:
        pad = last + b"\x80" + b"\x00" * (15 - len(last))
        last = bytes(a ^ b for a, b in zip(pad, k2))
    x = b"\x00" * 16
    for b in blocks[:-1]:
        x = aes128_encrypt_block(key, bytes(a ^ c for a, c in zip(x, b)))
    return aes128_encrypt_block(key, bytes(a ^ c for a, c in zip(x, last)))


def eia2(key: bytes, count: int, bearer: int, direction: int,
         data: bytes) -> bytes:
    """32-bit MAC-I (33.401 B.2.3): M = COUNT | BEARER | DIR | data."""
    m = (count.to_bytes(4, "big")
         + bytes([((bearer & 0x1F) << 3) | ((direction & 1) << 2)])
         + b"\x00" * 3 + data)
    return aes_cmac(key, m)[:4]


# --- Milenage (35.206; hss.cc:808 / usim.cc parity) --------------------------


def _xor(a: bytes, b: bytes) -> bytes:
    return bytes(x ^ y for x, y in zip(a, b))


def milenage_opc(k: bytes, op: bytes) -> bytes:
    return _xor(aes128_encrypt_block(k, op), op)


def _rotl(x: bytes, bits: int) -> bytes:
    """Cyclic left rotation by a whole number of bytes (35.206 uses
    r in {0, 32, 64, 96, 128} bits)."""
    n = (bits // 8) % 16
    return x[n:] + x[:n]


def milenage_f1(k: bytes, opc: bytes, rand: bytes, sqn: bytes, amf: bytes):
    """-> (MAC-A, MAC-S) (35.206 f1/f1*; r1=64 bits, c1=0)."""
    temp = aes128_encrypt_block(k, _xor(rand, opc))
    in1 = sqn + amf + sqn + amf
    out1 = _xor(aes128_encrypt_block(
        k, _xor(temp, _rotl(_xor(in1, opc), 64))), opc)
    return out1[:8], out1[8:]


def milenage_f2345(k: bytes, opc: bytes, rand: bytes):
    """-> (RES, CK, IK, AK) (35.206 f2-f5; r2..r4 = 0/32/64 bits,
    c2..c4 = 1/2/4)."""
    temp = aes128_encrypt_block(k, _xor(rand, opc))

    def outx(c: int, r_bits: int) -> bytes:
        block = bytearray(_rotl(_xor(temp, opc), r_bits))
        block[15] ^= c
        return _xor(aes128_encrypt_block(k, bytes(block)), opc)

    out2 = outx(1, 0)
    out3 = outx(2, 32)
    out4 = outx(4, 64)
    return out2[8:], out3, out4, out2[:6]


# --- SNOW 3G stream cipher (ETSI/SAGE UEA2&UIA2 spec; 33.401 B.1.2/B.2.2) ----
#
# The reference exposes only the UEA2 cipher (liblte_security_encryption_eea1,
# liblte_security.h:220-238, snow_3g.cc); we add UIA2 integrity as well since
# 33.401 mandates the pair. Both S-boxes are generated, not transcribed: SR is
# the Rijndael S-box (shared with the AES above) and SQ is the Dickson
# polynomial g49 over GF(2^8)/(x^8+x^6+x^5+x^3+1) plus 0x25.

_M32 = 0xFFFFFFFF
_SNOW_SQ = None
_SNOW_S1_T = None
_SNOW_S2_T = None


def _gf8_mul(a: int, b: int, poly: int) -> int:
    p = 0
    for _ in range(8):
        if b & 1:
            p ^= a
        hi = a & 0x80
        a = (a << 1) & 0xFF
        if hi:
            a ^= poly & 0xFF
        b >>= 1
    return p


def _build_sq():
    global _SNOW_SQ
    if _SNOW_SQ is not None:
        return _SNOW_SQ
    # g49(x) = x + x^9 + x^13 + x^15 + x^33 + x^41 + x^45 + x^47 + x^49,
    # field polynomial x^8 + x^6 + x^5 + x^3 + 1 (0x169); SQ(x)=g49(x)^0x25
    poly = 0x69  # reduction byte for x^8 == x^6+x^5+x^3+1
    sq = []
    for x in range(256):
        powers = {1: x}
        cur = x
        for e in range(2, 50):
            cur = _gf8_mul(cur, x, poly)
            powers[e] = cur
        v = 0x25
        for e in (1, 9, 13, 15, 33, 41, 45, 47, 49):
            v ^= powers[e]
        sq.append(v)
    _SNOW_SQ = bytes(sq)
    return _SNOW_SQ


def _mulx(v: int, c: int) -> int:
    return ((v << 1) ^ c) & 0xFF if v & 0x80 else (v << 1) & 0xFF


def _build_fsm_tables():
    """Word-in/word-out tables for S1 (SR + MixColumn, const 0x1B) and
    S2 (SQ + MixColumn, const 0x69), built per byte position."""
    global _SNOW_S1_T, _SNOW_S2_T
    if _SNOW_S1_T is not None:
        return _SNOW_S1_T, _SNOW_S2_T

    def make(box: bytes, c: int):
        # MixColumn circulant [2 1 1 3; 3 2 1 1; 1 3 2 1; 1 1 3 2] applied to
        # (S(w0), S(w1), S(w2), S(w3)); table[j][b] is the 32-bit contribution
        # of input byte j (j=0 is the MSB).
        tabs = []
        for j in range(4):
            t = []
            for b in range(256):
                s = box[b]
                two = _mulx(s, c)
                three = two ^ s
                col = [0, 0, 0, 0]
                # column j of the circulant: rows receive 2/3/1/1 rotated
                col[j] = two
                col[(j + 1) % 4] = three
                col[(j + 2) % 4] = s
                col[(j + 3) % 4] = s
                t.append((col[0] << 24) | (col[1] << 16)
                         | (col[2] << 8) | col[3])
            tabs.append(t)
        return tabs

    _SNOW_S1_T = make(_build_sbox(), 0x1B)
    _SNOW_S2_T = make(_build_sq(), 0x69)
    return _SNOW_S1_T, _SNOW_S2_T


def _mulxpow(v: int, i: int, c: int) -> int:
    for _ in range(i):
        v = _mulx(v, c)
    return v


_SNOW_MULA = None
_SNOW_DIVA = None


def _build_alpha_tables():
    global _SNOW_MULA, _SNOW_DIVA
    if _SNOW_MULA is not None:
        return _SNOW_MULA, _SNOW_DIVA
    mula = []
    diva = []
    for c in range(256):
        mula.append((_mulxpow(c, 23, 0xA9) << 24)
                    | (_mulxpow(c, 245, 0xA9) << 16)
                    | (_mulxpow(c, 48, 0xA9) << 8)
                    | _mulxpow(c, 239, 0xA9))
        diva.append((_mulxpow(c, 16, 0xA9) << 24)
                    | (_mulxpow(c, 39, 0xA9) << 16)
                    | (_mulxpow(c, 6, 0xA9) << 8)
                    | _mulxpow(c, 64, 0xA9))
    _SNOW_MULA, _SNOW_DIVA = mula, diva
    return mula, diva


class _Snow3G:
    """SNOW 3G keystream generator (LFSR of 16 words + FSM R1/R2/R3)."""

    def __init__(self, k: list[int], iv: list[int]):
        # k = [k0..k3] LSW-first, iv = [iv0..iv3] LSW-first (spec notation)
        inv = 0xFFFFFFFF
        s = [
            k[0] ^ inv, k[1] ^ inv, k[2] ^ inv, k[3] ^ inv,
            k[0], k[1], k[2], k[3],
            k[0] ^ inv, k[1] ^ inv ^ iv[0], k[2] ^ inv ^ iv[1], k[3] ^ inv,
            k[0] ^ iv[2], k[1], k[2], k[3] ^ iv[3],
        ]
        self.s = s
        self.r1 = self.r2 = self.r3 = 0
        self.s1t, self.s2t = _build_fsm_tables()
        self.mula, self.diva = _build_alpha_tables()
        for _ in range(32):
            f = self._clock_fsm()
            self._clock_lfsr(f)

    def _clock_fsm(self) -> int:
        s = self.s
        f = ((s[15] + self.r1) & _M32) ^ self.r2
        r = (self.r2 + (self.r3 ^ s[5])) & _M32
        w = self.r2
        self.r3 = (self.s2t[0][(w >> 24) & 0xFF] ^ self.s2t[1][(w >> 16) & 0xFF]
                   ^ self.s2t[2][(w >> 8) & 0xFF] ^ self.s2t[3][w & 0xFF])
        w = self.r1
        self.r2 = (self.s1t[0][(w >> 24) & 0xFF] ^ self.s1t[1][(w >> 16) & 0xFF]
                   ^ self.s1t[2][(w >> 8) & 0xFF] ^ self.s1t[3][w & 0xFF])
        self.r1 = r
        return f

    def _clock_lfsr(self, f: int = 0):
        s = self.s
        v = (((s[0] << 8) & 0xFFFFFF00)
             ^ self.mula[(s[0] >> 24) & 0xFF]
             ^ s[2]
             ^ ((s[11] >> 8) & 0x00FFFFFF)
             ^ self.diva[s[11] & 0xFF]
             ^ f)
        self.s = s[1:] + [v & _M32]

    def keystream(self, n: int) -> list[int]:
        """n 32-bit keystream words (first FSM output is discarded)."""
        f = self._clock_fsm()
        self._clock_lfsr(0)
        out = []
        for _ in range(n):
            f = self._clock_fsm()
            out.append(f ^ self.s[0])
            self._clock_lfsr(0)
        return out


def _snow_key_words(key: bytes) -> list[int]:
    """CK bytes -> [k0..k3] with k3 = most-significant word (spec 4.1)."""
    k3 = int.from_bytes(key[0:4], "big")
    k2 = int.from_bytes(key[4:8], "big")
    k1 = int.from_bytes(key[8:12], "big")
    k0 = int.from_bytes(key[12:16], "big")
    return [k0, k1, k2, k3]


def eea1(key: bytes, count: int, bearer: int, direction: int,
         data: bytes, length_bits: int | None = None) -> bytes:
    """128-EEA1 / UEA2 ciphering (symmetric). Bits past length_bits in the
    last byte are zeroed, matching the spec's keystream masking."""
    if length_bits is None:
        length_bits = 8 * len(data)
    iv_hi = ((bearer & 0x1F) << 27) | ((direction & 1) << 26)
    k = _snow_key_words(key)
    # [iv0..iv3]: s12 absorbs COUNT, s15 absorbs BEARER|DIR (UEA2 section 4,
    # validated against 33.401 Annex C.3 test sets)
    iv = [count & _M32, iv_hi, count & _M32, iv_hi]
    n = (length_bits + 31) // 32
    ks = _Snow3G(k, iv).keystream(n)
    ksb = b"".join(w.to_bytes(4, "big") for w in ks)
    nbytes = (length_bits + 7) // 8
    out = bytearray(a ^ b for a, b in zip(data[:nbytes], ksb))
    rem = length_bits % 8
    if rem and out:
        out[-1] &= (0xFF << (8 - rem)) & 0xFF
    return bytes(out) + data[nbytes:]


def _mul64(v: int, p: int) -> int:
    """GF(2^64) product modulo x^64+x^4+x^3+x+1 (UIA2 MUL64, c=0x1b)."""
    m64 = (1 << 64) - 1
    r = 0
    for _ in range(64):
        if p & 1:
            r ^= v
        p >>= 1
        if not p:
            break
        hi = v >> 63
        v = (v << 1) & m64
        if hi:
            v ^= 0x1B
    return r


def eia1(key: bytes, count: int, bearer: int, direction: int,
         data: bytes, length_bits: int | None = None) -> bytes:
    """128-EIA1 / UIA2 32-bit MAC. FRESH = BEARER||0^27 (33.401 B.2.2)."""
    if length_bits is None:
        length_bits = 8 * len(data)
    fresh = (bearer & 0x1F) << 27
    d = direction & 1
    k = _snow_key_words(key)
    iv = [count & _M32, fresh,
          (count & _M32) ^ (d << 31), fresh ^ (d << 15)]  # [iv0..iv3]
    z = _Snow3G(k, iv).keystream(5)
    p = (z[0] << 32) | z[1]
    q = (z[2] << 32) | z[3]
    # message as 64-bit blocks, last zero-padded; D = ceil(len/64)+1
    nblk = (length_bits + 63) // 64
    padded = data + b"\x00" * (8 * nblk - len(data))
    eval_ = 0
    for i in range(nblk):
        m = int.from_bytes(padded[8 * i : 8 * i + 8], "big")
        eval_ = _mul64(eval_ ^ m, p)
    eval_ ^= length_bits
    mac = (_mul64(eval_, q) >> 32) ^ z[4]
    return mac.to_bytes(4, "big")


# --- 33.401 Annex A key derivation (liblte_security.cc generate_k_*) ---------


def _kdf(key: bytes, fc: int, *params: bytes) -> bytes:
    """Generic 33.220 B.2 KDF: HMAC-SHA256(key, FC || P0 || L0 || ...)."""
    import hashlib
    import hmac as _hmac
    s = bytes([fc])
    for p in params:
        s += p + len(p).to_bytes(2, "big")
    return _hmac.new(key, s, hashlib.sha256).digest()


def generate_k_asme(ck: bytes, ik: bytes, ak: bytes, sqn: bytes,
                    mcc: str, mnc: str) -> bytes:
    """K_ASME (33.401 A.2): FC=0x10, P0=SN id (PLMN BCD), P1=SQN^AK."""
    plmn = _plmn_bcd(mcc, mnc)
    sqn_ak = bytes(a ^ b for a, b in zip(sqn, ak))
    return _kdf(ck + ik, 0x10, plmn, sqn_ak)


def _plmn_bcd(mcc: str, mnc: str) -> bytes:
    d = [int(c) for c in mcc] + ([0xF] if len(mnc) == 2 else []) \
        + [int(c) for c in mnc]
    return bytes([d[1] << 4 | d[0], d[3] << 4 | d[2], d[5] << 4 | d[4]])


def generate_k_enb(k_asme: bytes, nas_count: int) -> bytes:
    """K_eNB (33.401 A.3): FC=0x11, P0=uplink NAS COUNT."""
    return _kdf(k_asme, 0x11, nas_count.to_bytes(4, "big"))


def generate_nh(k_asme: bytes, sync_input: bytes) -> bytes:
    """NH (33.401 A.4): FC=0x12, P0=SYNC-input (K_eNB or previous NH)."""
    return _kdf(k_asme, 0x12, sync_input)


def generate_k_enb_star(k_enb: bytes, pci: int, earfcn_dl: int) -> bytes:
    """K_eNB* for handover (33.401 A.5): FC=0x13, P0=PCI, P1=EARFCN-DL."""
    return _kdf(k_enb, 0x13, pci.to_bytes(2, "big"),
                earfcn_dl.to_bytes(2, "big"))


def _alg_key(key: bytes, alg_distinguisher: int, alg_id: int) -> bytes:
    """Algorithm key derivation (33.401 A.7): FC=0x15; 128 LSBs."""
    return _kdf(key, 0x15, bytes([alg_distinguisher]),
                bytes([alg_id]))[16:]


def generate_k_nas(k_asme: bytes, enc_alg_id: int, int_alg_id: int):
    """-> (K_NASenc, K_NASint) (33.401 A.7 distinguishers 0x01/0x02)."""
    return _alg_key(k_asme, 0x01, enc_alg_id), _alg_key(k_asme, 0x02,
                                                        int_alg_id)


def generate_k_rrc(k_enb: bytes, enc_alg_id: int, int_alg_id: int):
    """-> (K_RRCenc, K_RRCint) (distinguishers 0x03/0x04)."""
    return _alg_key(k_enb, 0x03, enc_alg_id), _alg_key(k_enb, 0x04,
                                                       int_alg_id)


def generate_k_up(k_enb: bytes, enc_alg_id: int, int_alg_id: int):
    """-> (K_UPenc, K_UPint) (distinguishers 0x05/0x06)."""
    return _alg_key(k_enb, 0x05, enc_alg_id), _alg_key(k_enb, 0x06,
                                                       int_alg_id)
