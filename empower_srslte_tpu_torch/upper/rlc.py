"""RLC: TM, UM and AM modes on the 36.322 wire format
(lib/src/upper/rlc_tm.cc / rlc_um.cc / rlc_am.cc parity).

TM: passthrough. UM: 5/10-bit SN UMD PDUs with LI concatenation,
reordering and FI/LI reassembly (rlc_um.cc). AM: 10-bit SN AMD PDUs with
SDU concatenation, in-order delivery, spec STATUS PDUs (ACK_SN/NACK_SN
with optional SO ranges), retransmission with **SO-based resegmentation
under shrinking grants** (rlc_am.cc build_segment at rlc_am.cc:684),
poll handling and max-retx signalling.

Byte parity: the UMD/AMD/STATUS framing and the greedy concatenation
accounting mirror the reference exactly; golden vectors generated by
tools/rlc_oracle.cc (which drives the reference rlc_am/rlc_um entities)
are frozen into tests/test_rlc_wire.py. The receive-state variables
(vr_r/vr_h/vr_x/vr_ms) follow rlc_am.cc:1364-1406 including the
reference's status ACK_SN loop (rlc_am.cc get_status_pdu — ACK_SN ends
one below vr_ms, a reference quirk preserved for interop).

Timers are event-driven: callers invoke ``tick`` per TTI/ms.
"""

from __future__ import annotations

from dataclasses import dataclass, field

MOD_UM10 = 1024
MOD_UM5 = 32
MOD_AM = 1024
AM_WINDOW = 512

#: Framing info bits (36.322 6.2.2.6): bit1 = first byte is NOT the start
#: of an SDU, bit0 = last byte is NOT the end of an SDU.
FI_NOT_START = 0x2
FI_NOT_END = 0x1


# --------------------------------------------------------------------------
# bit-level helpers (MSB-first, as 36.322 headers are drawn)
# --------------------------------------------------------------------------


class _BitWriter:
    def __init__(self):
        self._bits: list[int] = []

    def add(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self._bits.append((value >> i) & 1)

    def to_bytes(self) -> bytes:
        bits = self._bits + [0] * (-len(self._bits) % 8)
        out = bytearray()
        for i in range(0, len(bits), 8):
            b = 0
            for bit in bits[i : i + 8]:
                b = (b << 1) | bit
            out.append(b)
        return bytes(out)


class _BitReader:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0

    def take(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            byte = self._data[self._pos >> 3]
            v = (v << 1) | ((byte >> (7 - (self._pos & 7))) & 1)
            self._pos += 1
        return v

    def byte_pos(self) -> int:
        return (self._pos + 7) >> 3


def _pack_lis(w: _BitWriter, lis: list[int]) -> None:
    """Extension part: E(1)+LI(11) entries, E=1 while more follow."""
    for i, li in enumerate(lis):
        w.add(int(i < len(lis) - 1), 1)
        w.add(li, 11)


def _unpack_lis(r: _BitReader, first_e: int) -> list[int]:
    lis = []
    e = first_e
    while e:
        e = r.take(1)
        lis.append(r.take(11))
    return lis


def _li_len(n_li: int) -> int:
    """Extension-part bytes for n LIs (12 bits each, byte-padded;
    matches the reference's N_li*1.5+0.5 integer rounding)."""
    return int(n_li * 1.5 + 0.5)


# --------------------------------------------------------------------------
# wire codecs (36.322 6.2.1)
# --------------------------------------------------------------------------


def pack_umd(sn: int, fi: int, lis: list[int], data: bytes,
             sn_bits: int = 10) -> bytes:
    """UMD PDU (36.322 6.2.1.3): [R3 FI E SN10] or [FI E SN5] + LIs."""
    w = _BitWriter()
    e = int(bool(lis))
    if sn_bits == 5:
        w.add(fi, 2)
        w.add(e, 1)
        w.add(sn, 5)
    else:
        w.add(0, 3)
        w.add(fi, 2)
        w.add(e, 1)
        w.add(sn, 10)
    _pack_lis(w, lis)
    return w.to_bytes() + data


def unpack_umd(pdu: bytes, sn_bits: int = 10) -> dict:
    r = _BitReader(pdu)
    if sn_bits == 5:
        fi = r.take(2)
        e = r.take(1)
        sn = r.take(5)
    else:
        r.take(3)
        fi = r.take(2)
        e = r.take(1)
        sn = r.take(10)
    lis = _unpack_lis(r, e)
    return dict(fi=fi, sn=sn, lis=lis, data=pdu[r.byte_pos():])


def pack_amd(sn: int, data: bytes, fi: int = 0,
             lis: list[int] | None = None, poll: bool = False,
             rf: bool = False, lsf: bool = False, so: int = 0) -> bytes:
    """AMD PDU / AMD PDU segment (36.322 6.2.1.4/6.2.1.5):
    [D/C RF P FI E SN10] (+ [LSF SO15] when RF=1) + LIs + data."""
    lis = lis or []
    w = _BitWriter()
    w.add(1, 1)                       # D/C = data
    w.add(int(rf), 1)
    w.add(int(poll), 1)
    w.add(fi, 2)
    w.add(int(bool(lis)), 1)
    w.add(sn, 10)
    if rf:
        w.add(int(lsf), 1)
        w.add(so, 15)
    _pack_lis(w, lis)
    return w.to_bytes() + data


def unpack_amd(pdu: bytes) -> dict:
    r = _BitReader(pdu)
    dc = r.take(1)
    if dc == 0:                        # control: STATUS PDU
        return dict(dc=0, status=unpack_status(pdu))
    rf = r.take(1)
    p = r.take(1)
    fi = r.take(2)
    e = r.take(1)
    sn = r.take(10)
    lsf, so = 0, 0
    if rf:
        lsf = r.take(1)
        so = r.take(15)
    lis = _unpack_lis(r, e)
    return dict(dc=1, rf=rf, p=p, fi=fi, sn=sn, lsf=lsf, so=so, lis=lis,
                data=pdu[r.byte_pos():])


def amd_header_len(n_li: int, rf: bool = False) -> int:
    return 2 + (2 if rf else 0) + _li_len(n_li)


def pack_status(ack_sn: int,
                nacks: list[tuple[int, int | None, int | None]]) -> bytes:
    """STATUS PDU (36.322 6.2.1.6): D/C=0, CPT=000, ACK_SN, E1; per NACK:
    NACK_SN, E1, E2 (+SOstart/SOend when E2)."""
    w = _BitWriter()
    w.add(0, 1)                       # D/C = control
    w.add(0, 3)                       # CPT = STATUS
    w.add(ack_sn, 10)
    w.add(int(bool(nacks)), 1)        # E1
    for i, (sn, so_start, so_end) in enumerate(nacks):
        w.add(sn, 10)
        w.add(int(i < len(nacks) - 1), 1)          # E1: more NACKs follow
        has_so = so_start is not None
        w.add(int(has_so), 1)                      # E2
        if has_so:
            w.add(so_start, 15)
            w.add(so_end, 15)
    return w.to_bytes()


def unpack_status(pdu: bytes) -> dict:
    r = _BitReader(pdu)
    r.take(1)                          # D/C
    r.take(3)                          # CPT
    ack_sn = r.take(10)
    e1 = r.take(1)
    nacks: list[tuple[int, int | None, int | None]] = []
    while e1:
        sn = r.take(10)
        e1 = r.take(1)
        e2 = r.take(1)
        if e2:
            nacks.append((sn, r.take(15), r.take(15)))
        else:
            nacks.append((sn, None, None))
    return dict(ack_sn=ack_sn, nacks=nacks)


def is_control(pdu: bytes) -> bool:
    return (pdu[0] >> 7) == 0


# --------------------------------------------------------------------------
# TM
# --------------------------------------------------------------------------


class RlcTm:
    """Transparent mode: a FIFO passthrough (rlc_tm.cc)."""

    def __init__(self):
        self._q: list[bytes] = []
        self.rx_sdus: list[bytes] = []

    def write_sdu(self, sdu: bytes) -> None:
        self._q.append(sdu)

    def buffer_state(self) -> int:
        """Queued bytes awaiting transmission (rlc::get_buffer_state,
        feeds the MAC BSR procedure)."""
        return sum(map(len, self._q))

    def read_pdu(self, nof_bytes: int) -> bytes | None:
        if not self._q or len(self._q[0]) > nof_bytes:
            return None
        return self._q.pop(0)

    def write_pdu(self, pdu: bytes) -> None:
        self.rx_sdus.append(pdu)


# --------------------------------------------------------------------------
# shared TX concatenation engine (rlc_um.cc/rlc_am.cc build_data_pdu)
# --------------------------------------------------------------------------


class _TxQueue:
    """Greedy SDU-to-PDU fill with the reference's space accounting."""

    def __init__(self, fixed_len: int):
        self._fixed = fixed_len
        self._q: list[bytes] = []
        self._sdu = bytearray()        # partially-sent SDU remainder

    def write(self, sdu: bytes) -> None:
        self._q.append(sdu)

    def pending(self) -> int:
        return len(self._sdu) + sum(map(len, self._q))

    def has_data(self) -> bool:
        return bool(self._sdu) or bool(self._q)

    def build(self, nof_bytes: int):
        """-> (fi, lis, data) or None; mirrors build_data_pdu's greedy
        loop (rlc_am.cc:611 onward) byte-for-byte."""
        head_len = self._fixed
        if nof_bytes <= head_len + 1 or not self.has_data():
            return None
        lis: list[int] = []
        data = bytearray()
        pdu_space = nof_bytes
        last_li = 0
        fi = 0
        if self._sdu:
            to_move = min(len(self._sdu), pdu_space - head_len)
            data += self._sdu[:to_move]
            del self._sdu[:to_move]
            last_li = to_move
            pdu_space = pdu_space - to_move if pdu_space > to_move else 0
            fi |= FI_NOT_START
        while pdu_space > head_len + 1 and self._q:
            if last_li > 0:
                lis.append(last_li)
            head_len = self._fixed + _li_len(len(lis))
            if head_len >= pdu_space:
                lis.pop()
                break
            sdu = self._q.pop(0)
            to_move = min(len(sdu), pdu_space - head_len)
            data += sdu[:to_move]
            if to_move < len(sdu):
                self._sdu = bytearray(sdu[to_move:])
            last_li = to_move
            pdu_space = pdu_space - to_move if pdu_space > to_move else 0
        if not data:
            return None
        if self._sdu:
            fi |= FI_NOT_END
        return fi, lis, bytes(data)


# --------------------------------------------------------------------------
# shared RX reassembly (FI/LI chunk splitting)
# --------------------------------------------------------------------------


class _Reassembler:
    def __init__(self, out: list[bytes]):
        self._partial: bytearray | None = None
        self._out = out

    def reset(self) -> None:
        self._partial = None

    def push(self, fi: int, lis: list[int], data: bytes) -> None:
        chunks = []
        pos = 0
        for li in lis:
            chunks.append(data[pos : pos + li])
            pos += li
        chunks.append(data[pos:])
        for i, chunk in enumerate(chunks):
            first, last = i == 0, i == len(chunks) - 1
            continues = first and (fi & FI_NOT_START)
            incomplete = last and (fi & FI_NOT_END)
            if continues:
                if self._partial is None:
                    continue           # predecessor lost: drop fragment
                self._partial += chunk
                if not incomplete:
                    self._out.append(bytes(self._partial))
                    self._partial = None
            elif incomplete:
                self._partial = bytearray(chunk)
            else:
                self._out.append(bytes(chunk))


# --------------------------------------------------------------------------
# UM
# --------------------------------------------------------------------------


class RlcUm:
    """Unacknowledged mode with LI concatenation + reordering
    (rlc_um.cc; 5- or 10-bit SN per 36.322 6.2.1.3)."""

    def __init__(self, sn_bits: int = 10):
        self.sn_bits = sn_bits
        self.mod = MOD_UM5 if sn_bits == 5 else MOD_UM10
        self.window = 16 if sn_bits == 5 else 512
        self.vt_us = 0                     # next TX SN
        self._tx = _TxQueue(1 if sn_bits == 5 else 2)
        self._rx: dict[int, dict] = {}
        self._vr_ur = 0                    # next expected SN
        self.rx_sdus: list[bytes] = []
        self._asm = _Reassembler(self.rx_sdus)

    # TX side
    def write_sdu(self, sdu: bytes) -> None:
        self._tx.write(sdu)

    def buffer_state(self) -> int:
        return self._tx.pending()

    def read_pdu(self, nof_bytes: int) -> bytes | None:
        built = self._tx.build(nof_bytes)
        if built is None:
            return None
        fi, lis, data = built
        pdu = pack_umd(self.vt_us, fi, lis, data, self.sn_bits)
        self.vt_us = (self.vt_us + 1) % self.mod
        return pdu

    # RX side
    def write_pdu(self, pdu: bytes) -> None:
        h = unpack_umd(pdu, self.sn_bits)
        if (h["sn"] - self._vr_ur) % self.mod >= self.window \
                and h["sn"] != self._vr_ur:
            return                         # outside the reordering window
        self._rx[h["sn"]] = h
        self._deliver()

    def _deliver(self) -> None:
        while self._vr_ur in self._rx:
            h = self._rx.pop(self._vr_ur)
            self._vr_ur = (self._vr_ur + 1) % self.mod
            self._asm.push(h["fi"], h["lis"], h["data"])

    def tick(self) -> None:
        """t-Reordering expiry: skip the gap (advance past missing SNs,
        dropping any partial SDU spanning the hole)."""
        if self._rx:
            self._asm.reset()
            self._vr_ur = min(
                self._rx, key=lambda s: (s - self._vr_ur) % self.mod)
            self._deliver()


# --------------------------------------------------------------------------
# AM
# --------------------------------------------------------------------------


@dataclass
class _TxPdu:
    sn: int
    data: bytes                        # PDU data field (headerless)
    fi: int
    lis: list[int]
    acked: bool = False
    retx_count: int = 0


@dataclass
class _Retx:
    sn: int
    is_segment: bool = False
    so_start: int = 0
    so_end: int = 0


@dataclass
class _RxSegments:
    segments: list[dict] = field(default_factory=list)


class RlcAm:
    """Acknowledged mode (rlc_am.cc): concatenation, in-order delivery,
    STATUS PDUs with NACKs, retransmission with SO resegmentation, poll
    bit, max-retx signalling."""

    def __init__(self, poll_pdu: int = 4, poll_retx: int = 40,
                 max_retx: int = 16, max_retx_cb=None):
        self.MAX_RETX = max_retx
        self.max_retx_cb = max_retx_cb
        self.max_retx_reached = False
        #: t-PollRetransmit analog, counted in read_pdu opportunities
        #: (~TTIs): pace the nothing-else-to-send re-poll so a long
        #: outage does not burn MAX_RETX in consecutive subframes
        self._poll_retx = poll_retx
        self._poll_retx_cnt = 0
        self._pulled_since_tick = False
        self.vt_s = 0                      # next new SN
        self.vt_a = 0                      # lowest unacked SN
        self._tx = _TxQueue(2)
        self._tx_window: dict[int, _TxPdu] = {}
        self._retx_q: list[_Retx] = []
        self._pdu_without_poll = 0
        self._poll_pdu = poll_pdu

        # RX state (36.322 5.1.3.2 variables, rlc_am.cc:1364-1406)
        self._rx: dict[int, dict] = {}
        self._rx_segments: dict[int, _RxSegments] = {}
        self.vr_r = 0                      # next in-sequence expected
        self.vr_h = 0                      # highest received + 1
        self.vr_x = 0                      # reordering trigger
        self.vr_ms = 0                     # max STATUS SN
        self.rx_sdus: list[bytes] = []
        self._asm = _Reassembler(self.rx_sdus)
        self._status_requested = False
        self._reordering_running = False

    # --- TX ---------------------------------------------------------------

    def write_sdu(self, sdu: bytes) -> None:
        self._tx.write(sdu)

    def buffer_state(self) -> int:
        retx = sum(len(self._tx_window[r.sn].data) + 2
                   for r in self._retx_q if r.sn in self._tx_window)
        return self._tx.pending() + retx

    def tick(self) -> None:
        """One TTI of the t-PollRetransmit timer (rlc_am.cc
        poll_retx_timer): with data outstanding and NO grant traffic, the
        expiry queues the oldest unacked PDU for retransmission-with-poll,
        so the MAC sees a non-zero buffer and raises BSR/SR — the path
        that eventually exhausts MAX_RETX and declares RLF when the link
        is dead. read_pdu's own pacing covers the granted case; a tick in
        a TTI that also pulled a PDU is a no-op so the two paths advance
        ONE shared timer at TTI rate, not double rate."""
        if self._pulled_since_tick:
            self._pulled_since_tick = False
            return
        if not ((self.vt_s - self.vt_a) % MOD_AM) or self._retx_q:
            return
        if self.vt_a not in self._tx_window:
            return
        self._poll_retx_cnt += 1
        if self._poll_retx_cnt < self._poll_retx:
            return
        self._poll_retx_cnt = 0
        self._retx_q.append(_Retx(self.vt_a))

    def _poll_required(self) -> bool:
        """rlc_am.cc:544 poll_required: PDU-count trigger (strict >) or
        both queues drained (a partially-sent SDU does not count)."""
        return (self._pdu_without_poll > self._poll_pdu
                or (not self._tx._q and not self._retx_q))

    def read_pdu(self, nof_bytes: int) -> bytes | None:
        """Highest priority: retransmissions, then new data (rlc_am.cc
        build_retx_pdu / build_data_pdu ordering)."""
        self._pulled_since_tick = True
        if self._retx_q:
            return self._build_retx(nof_bytes)
        if not self._tx.has_data():
            # t-PollRetransmit fallback: data outstanding, nothing else
            # to send -> re-poll with the oldest unacked PDU (rlc_am.cc
            # poll_retx timer expiry), paced by the timer analog
            if (self.vt_s - self.vt_a) % MOD_AM and \
                    self.vt_a in self._tx_window:
                self._poll_retx_cnt += 1
                if self._poll_retx_cnt < self._poll_retx:
                    return None
                self._poll_retx_cnt = 0
                ent = self._tx_window[self.vt_a]
                if self._bump_retx(ent) and \
                        amd_header_len(len(ent.lis)) + len(ent.data) \
                        <= nof_bytes:
                    return pack_amd(ent.sn, ent.data, ent.fi, ent.lis,
                                    poll=True)
            return None
        if (self.vt_s - self.vt_a) % MOD_AM >= AM_WINDOW:
            return None                    # TX window stall
        built = self._tx.build(nof_bytes)
        if built is None:
            return None
        fi, lis, data = built
        self._pdu_without_poll += 1
        poll = self._poll_required()
        if poll:
            self._pdu_without_poll = 0
        sn = self.vt_s
        self._tx_window[sn] = _TxPdu(sn, data, fi, lis)
        self.vt_s = (self.vt_s + 1) % MOD_AM
        return pack_amd(sn, data, fi, lis, poll=poll)

    def _bump_retx(self, ent: _TxPdu) -> bool:
        ent.retx_count += 1
        if ent.retx_count >= self.MAX_RETX:
            self.max_retx_reached = True
            if self.max_retx_cb is not None:
                self.max_retx_cb()
            return ent.retx_count == self.MAX_RETX  # last attempt goes out
        return True

    def _build_retx(self, nof_bytes: int) -> bytes | None:
        retx = self._retx_q[0]
        while retx.sn not in self._tx_window:
            self._retx_q.pop(0)
            if not self._retx_q:
                return None
            retx = self._retx_q[0]
        ent = self._tx_window[retx.sn]
        full_len = amd_header_len(len(ent.lis)) + len(ent.data)
        if not retx.is_segment and full_len <= nof_bytes:
            # poll decision is made while this retx is still queued
            # (rlc_am.cc build_retx_pdu pops after the poll check)
            self._pdu_without_poll += 1
            poll = self._poll_required()
            if poll:
                self._pdu_without_poll = 0
            self._retx_q.pop(0)
            if not self._bump_retx(ent):
                return None
            return pack_amd(ent.sn, ent.data, ent.fi, ent.lis, poll=poll)
        return self._build_segment(nof_bytes, retx, ent)

    def _build_segment(self, nof_bytes: int, retx: _Retx,
                       ent: _TxPdu) -> bytes | None:
        """AMD PDU segment under a too-small grant (rlc_am.cc:684
        build_segment): SO window into the original data field with a
        rebuilt LI table and FI bits."""
        if not retx.is_segment:
            retx.so_start, retx.so_end = 0, len(ent.data)
        so_start = retx.so_start
        fi = FI_NOT_START | FI_NOT_END
        poll = self._poll_required()
        head_len = amd_header_len(0, rf=True) + (2 if ent.lis else 0)
        if nof_bytes <= head_len:
            return None
        pdu_space = nof_bytes - head_len
        so_end = retx.so_end
        if pdu_space < so_end - so_start:
            so_end = so_start + pdu_space
        if so_start == 0 and not (ent.fi & FI_NOT_START):
            fi &= FI_NOT_END               # segment is start aligned
        # rebuild the LI table for SDU boundaries inside [so_start, so_end)
        lis: list[int] = []
        lower = 0
        for li in ent.lis:
            upper = lower + li
            if lower >= so_end:
                break
            head_len = amd_header_len(len(lis), rf=True) + len(ent.lis)
            pdu_space = nof_bytes - head_len
            if pdu_space < so_end - so_start:
                so_end = so_start + pdu_space
            if upper > so_start and lower < so_end:
                if lower > 0 and lower == so_start:
                    fi &= FI_NOT_END       # starts at an SDU boundary
                if upper == so_end:
                    fi &= FI_NOT_START     # ends at an SDU boundary
                if so_end > upper:
                    lis.append(min(upper, so_end) - max(lower, so_start))
            lower = upper
        lsf = so_end == len(ent.data)
        if lsf:
            self._retx_q.pop(0)
            if not (ent.fi & FI_NOT_END):
                fi &= FI_NOT_START         # segment is end aligned
        elif retx.so_end == so_end:
            self._retx_q.pop(0)
        else:
            retx.is_segment = True
            retx.so_start = so_end        # remaining range for next grant
        if not self._bump_retx(ent):
            return None
        if poll:
            self._pdu_without_poll = 0
        return pack_amd(ent.sn, ent.data[so_start:so_end], fi, lis,
                        poll=poll, rf=True, lsf=lsf, so=so_start)

    # --- status handling (TX side) ------------------------------------------

    def handle_status(self, status: bytes) -> None:
        """Apply a STATUS PDU: ack [vt_a, ack_sn) minus NACKs, schedule
        retransmissions (rlc_am.cc handle_control_pdu)."""
        st = unpack_status(status)
        ack_sn = st["ack_sn"]
        nacked = {sn: (so_s, so_e) for sn, so_s, so_e in st["nacks"]}
        if nacked:
            # flush to avoid unordered SNs; the peer re-requests losses
            # (rlc_am.cc handle_control_pdu)
            self._retx_q.clear()
        self._poll_retx_cnt = 0            # poll answered: stop the timer
        sn = self.vt_a
        while sn != ack_sn and sn != self.vt_s:   # ack_sn is EXCLUSIVE
            if sn in nacked:
                if not any(r.sn == sn for r in self._retx_q):
                    ent = self._tx_window.get(sn)
                    if ent is not None and ent.retx_count < self.MAX_RETX:
                        so_s, so_e = nacked[sn]
                        if so_s is None or so_s >= len(ent.data):
                            self._retx_q.append(_Retx(sn))
                        else:
                            self._retx_q.append(_Retx(
                                sn, True, so_s,
                                len(ent.data) if so_e == 0x7FFF
                                else so_e + 1))
            else:
                ent = self._tx_window.get(sn)
                if ent:
                    ent.acked = True
            sn = (sn + 1) % MOD_AM
        # advance vt_a over fully acked prefix
        while self.vt_a != self.vt_s:
            ent = self._tx_window.get(self.vt_a)
            if ent is None or not ent.acked:
                break
            del self._tx_window[self.vt_a]
            self.vt_a = (self.vt_a + 1) % MOD_AM

    # --- RX ---------------------------------------------------------------

    def write_pdu(self, pdu: bytes) -> None:
        if is_control(pdu):
            self.handle_status(pdu)
            return
        h = unpack_amd(pdu)
        if h["rf"]:
            self._rx_segment(h)
            return
        inside = (h["sn"] - self.vr_r) % MOD_AM < AM_WINDOW
        dup = not inside or h["sn"] in self._rx
        if inside and not dup:
            self._rx[h["sn"]] = h
            self._advance_rx_state(h["sn"])
        if h["p"] or dup:
            # duplicates mean the peer missed our STATUS: answer again
            self._status_requested = True
        self._deliver()

    def _advance_rx_state(self, sn: int) -> None:
        """vr_h / vr_ms / reordering-trigger updates
        (rlc_am.cc:1364-1406)."""
        if (sn - self.vr_h) % MOD_AM < AM_WINDOW:
            self.vr_h = (sn + 1) % MOD_AM
        while self.vr_ms in self._rx:
            self.vr_ms = (self.vr_ms + 1) % MOD_AM
        if self._reordering_running:
            if self.vr_x == self.vr_r:
                self._reordering_running = False
        if not self._reordering_running:
            if (self.vr_h - self.vr_r) % MOD_AM > 0 and self.vr_h != self.vr_r:
                self._reordering_running = True
                self.vr_x = self.vr_h

    def _rx_segment(self, h: dict) -> None:
        """Collect AMD PDU segments; on completion splice the full data
        field + merged LI table into the rx window
        (rlc_am.cc handle_data_pdu_segment / add_segment_and_check)."""
        if (h["sn"] - self.vr_r) % MOD_AM >= AM_WINDOW:
            if h["p"]:
                self._status_requested = True
            return
        store = self._rx_segments.setdefault(h["sn"], _RxSegments())
        if not any(s["so"] == h["so"] for s in store.segments):
            store.segments.append(h)
        if h["p"]:
            self._status_requested = True
        if (h["sn"] - self.vr_h) % MOD_AM < AM_WINDOW:
            self.vr_h = (h["sn"] + 1) % MOD_AM
        merged = self._try_merge(store)
        if merged is not None:
            del self._rx_segments[h["sn"]]
            if h["sn"] not in self._rx:
                self._rx[h["sn"]] = merged
                self._advance_rx_state(h["sn"])
            self._deliver()

    @staticmethod
    def _try_merge(store: _RxSegments) -> dict | None:
        segs = sorted(store.segments, key=lambda s: s["so"])
        if not segs or segs[0]["so"] != 0 or not segs[-1]["lsf"]:
            return None
        pos = 0
        for s in segs:
            if s["so"] != pos:
                return None            # gap (or overlap) remains
            pos += len(s["data"])
        # merge: concatenate data; boundaries from per-segment LIs and
        # end-aligned FI bits at internal segment joins
        data = b"".join(s["data"] for s in segs)
        cuts: list[int] = []
        for s in segs:
            off = s["so"]
            for li in s["lis"]:
                off += li
                cuts.append(off)
            if s is not segs[-1] and not (s["fi"] & FI_NOT_END):
                cuts.append(s["so"] + len(s["data"]))
        cuts = sorted(set(cuts))
        lis = [b - a for a, b in zip([0] + cuts, cuts)]
        fi = (segs[0]["fi"] & FI_NOT_START) | (segs[-1]["fi"] & FI_NOT_END)
        return dict(dc=1, rf=0, p=0, fi=fi, sn=segs[0]["sn"], lsf=0, so=0,
                    lis=lis, data=data)

    def _deliver(self) -> None:
        while self.vr_r in self._rx:
            h = self._rx.pop(self.vr_r)
            self.vr_r = (self.vr_r + 1) % MOD_AM
            self._asm.push(h["fi"], h["lis"], h["data"])

    def tick(self) -> None:
        """t-Reordering expiry (rlc_am.cc timer_expired): advance vr_ms
        to the first missing SN at/after vr_x and request a STATUS."""
        if not self._reordering_running:
            return
        self._reordering_running = False
        self.vr_ms = self.vr_x
        while self.vr_ms in self._rx:
            self.vr_ms = (self.vr_ms + 1) % MOD_AM
        self._status_requested = True
        if (self.vr_h - self.vr_ms) % MOD_AM > 0 and self.vr_h != self.vr_ms:
            self._reordering_running = True
            self.vr_x = self.vr_h

    def retx_pending(self) -> bool:
        """Unacknowledged PDUs outstanding (keeps the MAC asking for
        grants so poll-retransmit opportunities exist)."""
        return (self.vt_s - self.vt_a) % MOD_AM > 0

    def status_pending(self) -> bool:
        """A STATUS PDU is owed to the peer (drives BSR/SR triggers)."""
        return self._status_requested

    def get_status_pdu(self) -> bytes | None:
        """Build STATUS when polled (rlc_am.cc get_status_pdu): ACK_SN
        walks [vr_r, vr_ms), NACKing the holes — preserving the
        reference's ack_sn=i loop quirk for interop."""
        if not self._status_requested:
            return None
        self._status_requested = False
        ack_sn = self.vr_ms
        nacks: list[tuple[int, int | None, int | None]] = []
        sn = self.vr_r
        while sn != self.vr_ms:
            ack_sn = sn
            if sn not in self._rx:
                nacks.append((sn, None, None))
            sn = (sn + 1) % MOD_AM
        return pack_status(ack_sn, nacks)
