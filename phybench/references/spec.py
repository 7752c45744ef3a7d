"""3GPP pieces the plain receivers share, written from the specification.

Nothing here is taken from the program or from ``phybench.frozen``: the
pseudo-random sequence (TS 36.211 7.2), the CRCs and code block
segmentation (TS 36.212 5.1.1-5.1.2), the turbo code's trellis, tail and
QPP interleaver (5.1.3.2), the sub-block interleaver and circular buffer
of its rate matching (5.1.4.1), and a max-log-MAP (BCJR) turbo decoder
over the whole trellis, with no windows; also the FFT sizes of the
standard sampling rates and the piecewise-linear max-log LLRs of the
constellations of TS 36.211 7.1 (srsLTE's ``demod_soft.c``, the program's
semantics). NumPy throughout; the decoder
runs in float32, everything before it in float64. A control rounds each
stage's output to bfloat16 through ``Rounding``.
"""

from __future__ import annotations

import functools
import math

import numpy as np

# --- bfloat16 rounding (the control) ----------------------------------------


def bf16(x: np.ndarray) -> np.ndarray:
    """``x`` rounded to bfloat16 (nearest, ties to even) and back; complex
    values part by part."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return bf16(x.real) + 1j * bf16(x.imag)
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(x.dtype)


class Rounding:
    """What each stage's output is stored in: unchanged for the
    reference, bfloat16 for the control."""

    def __init__(self, lower: bool = False):
        self.lower = lower

    def __call__(self, x):
        return bf16(x) if self.lower else x


#: FFT size by bandwidth at the standard sampling rates (TS 36.104)
FFT = {6: 128, 15: 256, 25: 512, 50: 1024, 75: 1536, 100: 2048}


def llrs(x: np.ndarray, qm: int) -> np.ndarray:
    """Piecewise-linear max-log LLRs of Gray-mapped QPSK/16QAM/64QAM
    (TS 36.211 7.1: b0/b1 the signs of I/Q, then the amplitude bits):
    [..., M] -> [..., M qm], positive <=> bit 0."""
    re, im = x.real, x.imag
    if qm == 2:
        planes = [re, im]
    elif qm == 4:
        c = 2 / math.sqrt(10)
        planes = [re, im, c - abs(re), c - abs(im)]
    elif qm == 6:
        c4, c2 = 4 / math.sqrt(42), 2 / math.sqrt(42)
        planes = [re, im, c4 - abs(re), c4 - abs(im),
                  c2 - abs(abs(re) - c4), c2 - abs(abs(im) - c4)]
    else:
        raise ValueError(qm)
    return np.stack(planes, -1).reshape(*x.shape[:-1], -1)


# --- the pseudo-random sequence, TS 36.211 7.2 -------------------------------

NC = 1600


@functools.lru_cache(maxsize=256)
def gold(c_init: int, n: int) -> np.ndarray:
    """c(0..n-1) as uint8: x1 starts at 1, 0, ..., 0, x2 at the bits of
    ``c_init``; c(i) = x1(i + Nc) + x2(i + Nc) mod 2."""
    total = NC + n
    x1 = [0] * (total + 31)
    x2 = [0] * (total + 31)
    x1[0] = 1
    for i in range(31):
        x2[i] = (c_init >> i) & 1
    for i in range(total):
        x1[i + 31] = x1[i + 3] ^ x1[i]
        x2[i + 31] = x2[i + 3] ^ x2[i + 2] ^ x2[i + 1] ^ x2[i]
    out = (np.asarray(x1[NC:NC + n], np.uint8)
           ^ np.asarray(x2[NC:NC + n], np.uint8))
    out.setflags(write=False)
    return out


def signs(c_init: int, n: int) -> np.ndarray:
    """1 - 2 c(i): the descrambling of LLRs (positive LLR <=> bit 0)."""
    return 1.0 - 2.0 * gold(c_init, n).astype(np.float64)


# --- CRCs, TS 36.212 5.1.1 ---------------------------------------------------

#: generator polynomials without their leading term, and lengths
CRC24A = (0x864CFB, 24)
CRC24B = (0x800063, 24)
CRC16 = (0x1021, 16)
CRC8 = (0x9B, 8)


@functools.lru_cache(maxsize=8)
def _crc_table(poly: int, length: int) -> np.ndarray:
    table = np.zeros(256, np.uint64)
    top, mask = 1 << (length - 1), (1 << length) - 1
    for byte in range(256):
        reg = byte << (length - 8)
        for _ in range(8):
            reg = ((reg << 1) ^ poly) if reg & top else (reg << 1)
        table[byte] = reg & mask
    return table


def crc_bits(bits: np.ndarray, crc) -> np.ndarray:
    """Parity bits [..., L] of ``bits`` [..., n] (0/1), register
    starting at 0, MSB first."""
    poly, length = crc
    bits = np.asarray(bits, np.uint8)
    lead, n = bits.shape[:-1], bits.shape[-1]
    flat = bits.reshape(-1, n)
    pad = (-n) % 8               # leading zeros leave the CRC unchanged
    flat = np.concatenate([np.zeros((flat.shape[0], pad), np.uint8), flat],
                          axis=1)
    data = np.packbits(flat, axis=1).astype(np.uint64)
    table, mask = _crc_table(poly, length), (1 << length) - 1
    reg = np.zeros(flat.shape[0], np.uint64)
    for col in range(data.shape[1]):
        idx = ((reg >> np.uint64(length - 8)) ^ data[:, col]) & np.uint64(0xFF)
        reg = ((reg << np.uint64(8)) ^ table[idx]) & np.uint64(mask)
    out = ((reg[:, None] >> np.arange(length - 1, -1, -1, dtype=np.uint64))
           & np.uint64(1)).astype(np.uint8)
    return out.reshape(*lead, length)


def crc_ok(bits_with_parity: np.ndarray, crc) -> np.ndarray:
    """Whether the last L bits are the CRC of the rest: [...] bool."""
    length = crc[1]
    b = np.asarray(bits_with_parity, np.uint8)
    return (crc_bits(b[..., :-length], crc) == b[..., -length:]).all(-1)


# --- code block segmentation, TS 36.212 5.1.2 --------------------------------

#: the interleaver sizes K of Table 5.1.3-3
K_SIZES = (list(range(40, 512, 8)) + list(range(512, 1024, 16))
           + list(range(1024, 2048, 32)) + list(range(2048, 6145, 64)))
Z = 6144
assert len(K_SIZES) == 188


@functools.lru_cache(maxsize=64)
def segmentation(tbs: int) -> tuple:
    """-> (C, per-block K list in order, F): the K- blocks come first and
    the F filler bits lead the first block."""
    b = tbs + 24
    if b <= Z:
        c, b_prime = 1, b
    else:
        c = math.ceil(b / (Z - 24))
        b_prime = b + 24 * c
    k_plus = min(k for k in K_SIZES if c * k >= b_prime)
    if c == 1:
        c_plus, c_minus, k_minus = 1, 0, 0
    else:
        k_minus = max(k for k in K_SIZES if k < k_plus)
        c_minus = (c * k_plus - b_prime) // (k_plus - k_minus)
        c_plus = c - c_minus
    f = c_plus * k_plus + c_minus * k_minus - b_prime
    return c, [k_minus] * c_minus + [k_plus] * c_plus, f


# --- turbo code, TS 36.212 5.1.3.2 -------------------------------------------

#: (f1, f2) of the QPP interleaver, Table 5.1.3-3, by K
QPP = dict(zip(K_SIZES, zip(
    (3, 7, 19, 7, 7, 11, 5, 11, 7, 41, 103, 15, 9, 17, 9, 21, 101, 21, 57,
     23, 13, 27, 11, 27, 85, 29, 33, 15, 17, 33, 103, 19, 19, 37, 19, 21, 21,
     115, 193, 21, 133, 81, 45, 23, 243, 151, 155, 25, 51, 47, 91, 29, 29,
     247, 29, 89, 91, 157, 55, 31, 17, 35, 227, 65, 19, 37, 41, 39, 185, 43,
     21, 155, 79, 139, 23, 217, 25, 17, 127, 25, 239, 17, 137, 215, 29, 15,
     147, 29, 59, 65, 55, 31, 17, 171, 67, 35, 19, 39, 19, 199, 21, 211, 21,
     43, 149, 45, 49, 71, 13, 17, 25, 183, 55, 127, 27, 29, 29, 57, 45, 31,
     59, 185, 113, 31, 17, 171, 209, 253, 367, 265, 181, 39, 27, 127, 143,
     43, 29, 45, 157, 47, 13, 111, 443, 51, 51, 451, 257, 57, 313, 271, 179,
     331, 363, 375, 127, 31, 33, 43, 33, 477, 35, 233, 357, 337, 37, 71, 71,
     37, 39, 127, 39, 39, 31, 113, 41, 251, 43, 21, 43, 45, 45, 161, 89, 323,
     47, 23, 47, 263),
    (10, 12, 42, 16, 18, 20, 22, 24, 26, 84, 90, 32, 34, 108, 38, 120, 84,
     44, 46, 48, 50, 52, 36, 56, 58, 60, 62, 32, 198, 68, 210, 36, 74, 76,
     78, 120, 82, 84, 86, 44, 90, 46, 94, 48, 98, 40, 102, 52, 106, 72, 110,
     168, 114, 58, 118, 180, 122, 62, 84, 64, 66, 68, 420, 96, 74, 76, 234,
     80, 82, 252, 86, 44, 120, 92, 94, 48, 98, 80, 102, 52, 106, 48, 110,
     112, 114, 58, 118, 60, 122, 124, 84, 64, 66, 204, 140, 72, 74, 76, 78,
     240, 82, 252, 86, 88, 60, 92, 846, 48, 28, 80, 102, 104, 954, 96, 110,
     112, 114, 116, 354, 120, 610, 124, 420, 64, 66, 136, 420, 216, 444, 456,
     468, 80, 164, 504, 172, 88, 300, 92, 188, 96, 28, 240, 204, 104, 212,
     192, 220, 336, 228, 232, 236, 120, 244, 248, 168, 64, 130, 264, 134,
     408, 138, 280, 142, 480, 146, 444, 120, 152, 462, 234, 158, 80, 96, 902,
     166, 336, 170, 86, 174, 176, 178, 120, 182, 184, 186, 94, 190, 480))))


@functools.lru_cache(maxsize=64)
def qpp(k: int) -> np.ndarray:
    """Pi(i) = (f1 i + f2 i^2) mod K: c'_i = c_Pi(i)."""
    f1, f2 = QPP[k]
    i = np.arange(k, dtype=np.int64)
    pi = (f1 * i + f2 * i * i) % k
    assert len(np.unique(pi)) == k, k
    return pi


@functools.lru_cache(maxsize=1)
def trellis() -> tuple:
    """The 8-state constituent encoder, g0 = 1 + D^2 + D^3 (feedback),
    g1 = 1 + D + D^3. A state holds (a_{k-1}, a_{k-2}, a_{k-3}) as
    4 a1 + 2 a2 + a3. -> (prev [8, 2], u [8, 2], p [8, 2]): for each next
    state, its two predecessors and their input and parity bits."""
    prev = [[] for _ in range(8)]
    for s in range(8):
        a1, a2, a3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
        for u in (0, 1):
            a = u ^ a2 ^ a3
            z = a ^ a1 ^ a3
            prev[(a << 2) | (a1 << 1) | a2].append((s, u, z))
    arr = np.asarray(prev, np.int64)                       # [8, 2, 3]
    return arr[..., 0], arr[..., 1], arr[..., 2]


def turbo_streams(d: np.ndarray, k: int) -> tuple:
    """d [..., 3, K+4] -> (sys [..., K+3], par1 [..., K+3], sys2 tail
    [..., 3], par2 [..., K+3]): the tail bits' places in d follow
    5.1.3.2.2 (x_K, z_K, x_K+1, z_K+1, x_K+2, z_K+2 of the first encoder,
    then the same primed of the second, in d0 d1 d2 order)."""
    d0, d1, d2 = d[..., 0, :], d[..., 1, :], d[..., 2, :]
    x = np.stack([d0[..., k], d2[..., k], d1[..., k + 1]], -1)
    z = np.stack([d1[..., k], d0[..., k + 1], d2[..., k + 1]], -1)
    xp = np.stack([d0[..., k + 2], d2[..., k + 2], d1[..., k + 3]], -1)
    zp = np.stack([d1[..., k + 2], d0[..., k + 3], d2[..., k + 3]], -1)
    return (np.concatenate([d0[..., :k], x], -1),
            np.concatenate([d1[..., :k], z], -1), xp,
            np.concatenate([d2[..., :k], zp], -1))


def map_decode(lsa: np.ndarray, lp: np.ndarray) -> np.ndarray:
    """Max-log-MAP over the whole trellis of one constituent code.
    lsa, lp [N, T] float32: systematic (plus a-priori) and parity LLRs of
    T steps, the last 3 the termination; the trellis starts and ends in
    state 0. -> a-posteriori LLRs of the first T - 3 steps [N, T - 3]."""
    prev, u, p = trellis()
    n, t = lsa.shape
    # branch metrics of the four (input, parity) pairs, index 2 u + p
    hs, hp = 0.5 * lsa.T, 0.5 * lp.T                       # [T, N]
    bm = np.stack([hs + hp, hs - hp, -hs + hp, -hs - hp], -1)
    into = 2 * u + p                                       # [8, 2]
    nxt = np.zeros((8, 2), np.int64)                       # by (state, u)
    out_bm = np.zeros((8, 2), np.int64)
    for s_next in range(8):
        for j in range(2):
            nxt[prev[s_next, j], u[s_next, j]] = s_next
            out_bm[prev[s_next, j], u[s_next, j]] = into[s_next, j]
    neg = np.float32(-1e30)
    alpha = np.empty((t + 1, n, 8), np.float32)
    alpha[0] = neg
    alpha[0][:, 0] = 0
    for k in range(t):
        ak, bk = alpha[k], bm[k]
        a = np.maximum(ak[:, prev[:, 0]] + bk[:, into[:, 0]],
                       ak[:, prev[:, 1]] + bk[:, into[:, 1]])
        np.subtract(a, a[:, :1], out=alpha[k + 1])
    beta = np.full((n, 8), neg, np.float32)
    beta[:, 0] = 0
    out = np.empty((n, t - 3), np.float32)
    for k in range(t - 1, -1, -1):
        bk = bm[k]
        via0 = bk[:, out_bm[:, 0]] + beta[:, nxt[:, 0]]    # [N, 8], u = 0
        via1 = bk[:, out_bm[:, 1]] + beta[:, nxt[:, 1]]
        if k < t - 3:
            out[:, k] = ((alpha[k] + via0).max(-1)
                         - (alpha[k] + via1).max(-1))
        b = np.maximum(via0, via1)
        beta = b - b[:, :1]
    return out


def turbo_decode(d: np.ndarray, k: int, max_iterations: int,
                 check) -> tuple:
    """Iterative max-log-MAP decode of code blocks d [N, 3, K+4] float32
    (positive LLR <=> bit 0). After each iteration ``check(bits [N, K])``
    says which blocks pass their CRC; those stop there.
    -> (bits [N, K] uint8, iterations run by each block [N])."""
    pi = qpp(k)
    pinv = np.argsort(pi)
    sys, par1, tail2, par2 = (a.astype(np.float32)
                              for a in turbo_streams(d, k))
    n = d.shape[0]
    bits = np.zeros((n, k), np.uint8)
    its = np.zeros(n, np.int64)
    live = np.arange(n)
    ext2 = np.zeros((n, k), np.float32)
    for it in range(1, max_iterations + 1):
        s = sys[live]
        lsa1 = s[:, :k] + ext2[live]
        llr1 = map_decode(np.concatenate([lsa1, s[:, k:]], -1), par1[live])
        ext1 = llr1 - lsa1
        lsa2 = (s[:, :k] + ext1)[:, pi]
        llr2 = map_decode(np.concatenate([lsa2, tail2[live]], -1),
                          par2[live])
        ext2[live] = (llr2 - lsa2)[:, pinv]
        hard = (llr2[:, pinv] < 0).astype(np.uint8)
        bits[live] = hard
        its[live] = it
        ok = check(hard, live)
        live = live[~ok]
        if not len(live):
            break
    return bits, its


# --- rate matching for turbo coded channels, TS 36.212 5.1.4.1 --------------

#: the sub-block interleaver's column permutation, Table 5.1.4-1
COL_PERM = (0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
            1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31)
NULL = -1


@functools.lru_cache(maxsize=64)
def circular_buffer(k: int, f: int) -> np.ndarray:
    """w_0..w_{Kw-1} as indices into d [3, K+4] flattened (stream i at
    i (K+4) + position), NULL for the dummy and the filler bits."""
    d = k + 4
    r = math.ceil(d / 32)
    kp, nd = 32 * r, 32 * r - d
    perm = np.asarray(COL_PERM)
    j = np.arange(kp)
    # y_k: NULL for k < ND, then d_k; the filler <NULL> of d0, d1
    def y_to_d(y_idx, stream, filler):
        pos = y_idx - nd
        out = np.where(pos >= 0, stream * d + pos, NULL)
        if filler:
            out = np.where((pos >= 0) & (pos < f), NULL, out)
        return out
    # streams 0, 1: column-wise read of the permuted R x 32 matrix
    v01 = perm[j // r] + 32 * (j % r)
    # stream 2: pi(k) = (P(floor(k/R)) + 32 (k mod R) + 1) mod Kp
    v2 = (perm[j // r] + 32 * (j % r) + 1) % kp
    w = np.empty(3 * kp, np.int64)
    w[:kp] = y_to_d(v01, 0, True)
    w[kp::2] = y_to_d(v01, 1, True)
    w[kp + 1::2] = y_to_d(v2, 2, False)
    return w


def e_sizes(g: int, c: int, qm: int, n_l: int = 1) -> list:
    """E of each code block (5.1.4.1.2)."""
    g_p = g // (n_l * qm)
    gamma = g_p % c
    return [n_l * qm * (g_p // c if r <= c - gamma - 1
                        else math.ceil(g_p / c)) for r in range(c)]


def selection(k: int, f: int, rv: int, e: int) -> np.ndarray:
    """The d positions of e_0..e_{E-1} (bit selection, N_cb = Kw)."""
    w = circular_buffer(k, f)
    ncb = len(w)
    r = ncb // 96
    k0 = r * (2 * math.ceil(ncb / (8 * r)) * rv + 2)
    order = w[(k0 + np.arange(ncb)) % ncb]
    order = order[order != NULL]
    return np.resize(order, e)


def derm(llr: np.ndarray, k: int, f: int, rv: int) -> np.ndarray:
    """Soft inverse of the bit selection: llr [..., E] -> [..., 3 (K+4)],
    repeated bits summed, positions never sent 0."""
    e = llr.shape[-1]
    pos = selection(k, f, rv, e)
    n = int((circular_buffer(k, f) != NULL).sum())
    out = np.zeros((*llr.shape[:-1], 3 * (k + 4)), llr.dtype)
    for start in range(0, e, n):         # one pass of the circle at a time
        stop = min(start + n, e)
        out[..., pos[start:stop]] += llr[..., start:stop]
    return out


# --- the shared channel's decode, TS 36.212 5.3.2 / 5.2.2 --------------------


def sch_softbuffers(llr: np.ndarray, tbs: int, qm: int, rv: int = 0
                    ) -> list:
    """Descrambled codeword LLRs [..., G] -> each code block's
    de-rate-matched LLRs [..., 3 (K+4)], in block order."""
    c, ks, f = segmentation(tbs)
    out, off = [], 0
    for r, (k, e) in enumerate(zip(ks, e_sizes(llr.shape[-1], c, qm))):
        out.append(derm(llr[..., off:off + e], k, f if r == 0 else 0, rv))
        off += e
    assert off == llr.shape[-1]
    return out


def sch_decode(soft: list, tbs: int, max_iterations: int,
               filler_llr: float = 1e4) -> tuple:
    """Code blocks' de-rate-matched LLRs (``sch_softbuffers``, each
    [..., 3 (K+4)]) -> (TB bits [..., tbs] uint8, TB passed [...] bool,
    turbo iterations of each block [..., C]). The blocks of one K decode
    as one batch; each stops once its own CRC passes (CRC24B, or the
    TB's CRC24A when it is the only block). A TB passes when its CRC and
    every block's pass; a word decoded as all zeros passes every CRC and
    is no success."""
    c, ks, f = segmentation(tbs)
    lead = soft[0].shape[:-1]
    n = int(np.prod(lead)) if lead else 1
    crc = CRC24B if c > 1 else CRC24A
    decoded, its = [None] * c, [None] * c
    for k in sorted(set(ks)):
        idx = [r for r in range(c) if ks[r] == k]
        d = np.stack([soft[r].reshape(n, 3, k + 4) for r in idx], 1)
        d = d.reshape(n * len(idx), 3, k + 4).astype(np.float32)
        if f and idx[0] == 0:
            d = d.reshape(n, len(idx), 3, k + 4)
            d[:, 0, 0, :f] = filler_llr
            d = d.reshape(n * len(idx), 3, k + 4)
        b, it = turbo_decode(d, k, max_iterations,
                             lambda bits, _live: crc_ok(bits, crc))
        b, it = b.reshape(n, len(idx), k), it.reshape(n, len(idx))
        for j, r in enumerate(idx):
            decoded[r], its[r] = b[:, j], it[:, j]
    ok = np.ones(n, bool)
    parts = []
    for r in range(c):
        fr = f if r == 0 else 0
        if c > 1:
            ok &= crc_ok(decoded[r][:, fr:], CRC24B)
            parts.append(decoded[r][:, fr:ks[r] - 24])
        else:
            parts.append(decoded[r][:, fr:])
    full = np.concatenate(parts, -1)                       # [n, tbs + 24]
    ok &= crc_ok(full, CRC24A) & full.any(-1)
    return (full[:, :tbs].reshape(*lead, tbs), ok.reshape(lead),
            np.stack(its, -1).reshape(*lead, c))
