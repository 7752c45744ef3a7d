"""PUSCH: physical uplink shared channel (36.211 5.3, 36.212 5.2.2), with
UCI multiplexing.

Capability parity with lib/src/phy/phch/pusch.c: UL-SCH coding (the shared
turbo chain, models/sch.py), scrambling, modulation, DFT transform
precoding, mapping around the two DMRS symbols; the eNB receive path
(enb_ul.c:256-386): DMRS channel estimation, MMSE equalization, IDFT
despreading, soft demapping and decode; and UCI (CQI, RI, HARQ-ACK) on
PUSCH (sch.c:550-1095, pusch.c:536-560). Counterpart of the JAX package's
models/pusch.py:1-556, batched over leading dims.

``pusch_decode_jit`` / ``pusch_decode_uci_jit`` keep the JAX package's
signatures and cache keys; the port has no jit, so each caches the plain
closure (and the plan) per key, and the chain runs eagerly. The receive stages
are the profiler ranges ``pusch.chest``, ``pusch.eq_demod``,
``pusch.uci_demux`` (and ``uci.cqi_decode``, ``dlsch.*`` below them).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.dft_precoding import dft_deprecode, dft_precode, valid_prb
from ..ops.fec.cbsegm import cbsegm
from ..ops.modem import Mod, demod_soft, modulate, quantize_llr_int8
from ..ops.scrambling import descramble_llrs, scramble_bits
from ..runtime import trace
from ..utils.cell import CP, Cell
from ..utils.device import device_table
from ..utils.sequence import cinit_pdsch, gold_sequence
from . import uci as uci_mod
from .refsignal_ul import chest_ul_pusch, pusch_dmrs, pusch_dmrs_symbols
from .sch import DlschPlan, dlsch_decode, dlsch_encode


# --- frequency hopping (36.211 5.3.4 / 36.213 8.4; pusch.c:55-137) ----------


def pusch_hop_type1(nof_prb: int, n_rb_ho: int, n_prb_1: int,
                    hop: str) -> tuple[int, int]:
    """Type-1 hopping: fixed offset between slots from the DCI0 hopping
    bits (ra.c:145-177). hop: "quart" | "quart_neg" | "half"."""
    if n_rb_ho % 2:
        n_rb_ho += 1
    n_rb_pusch = nof_prb - n_rb_ho - (nof_prb % 2)
    if hop == "quart":
        n1 = (n_rb_pusch // 4 + n_prb_1) % n_rb_pusch
    elif hop == "quart_neg":
        n1 = (n_prb_1 - n_rb_pusch // 4) if n_prb_1 >= n_rb_pusch // 4 \
            else (n_rb_pusch + n_prb_1 - n_rb_pusch // 4)
    elif hop == "half":
        n1 = (n_rb_pusch // 2 + n_prb_1) % n_rb_pusch
    else:
        raise ValueError(hop)
    return n_prb_1, n1


def pusch_hop_type2(cell: Cell, n_sb: int, hopping_offset: int,
                    inter_sf: bool, n_vrb: int, sf_idx: int,
                    current_tx_nb: int = 0) -> tuple[int, int]:
    """Type-2 (pseudo-random subband) hopping with mirroring
    (36.211 5.3.4; pusch.c:55-137). The hopping pattern c(i) is the Gold
    sequence seeded with the cell id (pusch.c:332)."""
    c = gold_sequence(cell.id, 210)

    def f_hop_sum(i):
        return sum(int(c[k]) << (k - (i * 10 + 1))
                   for k in range(i * 10 + 1, i * 10 + 9))

    def f_hop(i):
        if i == -1 or n_sb == 1:
            return 0
        if n_sb == 2:
            return (f_hop(i - 1) + f_hop_sum(i)) % 2
        return (f_hop(i - 1) + f_hop_sum(i) % (n_sb - 1) + 1) % n_sb

    def f_m(i):
        if n_sb == 1:
            return current_tx_nb % 2 if inter_sf else i % 2
        return int(c[i * 10])

    out = []
    for slot in range(2):
        n_vrb_t = n_vrb
        if n_sb > 1:
            n_vrb_t -= (hopping_offset - 1) // 2 + 1
        i = sf_idx if inter_sf else 2 * sf_idx + slot
        n_rb_sb = cell.nof_prb
        if n_sb > 1:
            n_rb_sb = (n_rb_sb - hopping_offset - hopping_offset % 2) // n_sb
        n_prb_t = (n_vrb_t + f_hop(i) * n_rb_sb
                   + (n_rb_sb - 1 - 2 * (n_vrb_t % n_rb_sb)) * f_m(i)) \
            % (n_rb_sb * n_sb)
        if n_sb > 1:
            n_prb_t += (hopping_offset - 1) // 2 + 1
        out.append(n_prb_t)
    return out[0], out[1]


@dataclass(frozen=True)
class PuschConfig:
    """Static PUSCH grant configuration."""

    cell: Cell
    sf_idx: int = 0
    rnti: int = 0x1234
    mod: Mod = Mod.QPSK
    prb_start: int = 0
    n_prb: int = 6
    cyclic_shift: int = 0
    #: second-slot PRB start when frequency hopping (36.211 5.3.4);
    #: None = no hop
    prb_start_slot1: int | None = None
    #: DMRS group/sequence hopping (36.211 5.5.1.3/5.5.1.4)
    delta_ss: int = 0
    group_hopping: bool = False
    sequence_hopping: bool = False
    #: 8-bit quantized LLR lane of ``pusch_decode`` (the UCI decode
    #: ignores it, as the reference package does)
    llr_int8: bool = False

    def __post_init__(self):
        if not valid_prb(self.n_prb):
            raise ValueError(f"n_prb={self.n_prb} is not 2^a 3^b 5^c")

    @property
    def m_sc(self) -> int:
        return 12 * self.n_prb

    @property
    def nof_data_symbols(self) -> int:
        return self.cell.nsymb_sf - 2  # minus the two DMRS symbols

    @property
    def g(self) -> int:
        return self.nof_data_symbols * self.m_sc * self.mod.bits_per_symbol

    def plan(self, tbs: int, rv: int = 0, max_iterations: int = 5,
             decoder_impl: str = "nii") -> DlschPlan:
        return DlschPlan(tbs=tbs, g=self.g, qm=self.mod.bits_per_symbol,
                         rv=rv, max_iterations=max_iterations,
                         decoder_impl=decoder_impl)

    def cinit(self) -> int:
        return cinit_pdsch(self.rnti, 0, 2 * self.sf_idx, self.cell.id)

    def slot_starts(self) -> tuple[int, int]:
        s1 = self.prb_start if self.prb_start_slot1 is None \
            else self.prb_start_slot1
        return self.prb_start, s1

    @functools.cached_property
    def data_symbol_indices(self) -> np.ndarray:
        l0, l1 = pusch_dmrs_symbols(self.cell)
        return np.asarray(
            [s for s in range(self.cell.nsymb_sf) if s not in (l0, l1)],
            np.int64)


@functools.lru_cache(maxsize=256)
def _grid_indices(cfg: PuschConfig) -> np.ndarray:
    """Flat grid positions of the data REs (symbol by symbol) followed by
    the two DMRS symbols' REs; each slot at its own PRB start (pusch_cp,
    pusch.c:141-180)."""
    cell = cfg.cell
    st0, st1 = cfg.slot_starts()
    k0_of = lambda sym: 12 * (st0 if sym < cell.nsymb_slot else st1)
    syms = list(cfg.data_symbol_indices) + list(pusch_dmrs_symbols(cell))
    return np.concatenate([s * cell.nof_re + k0_of(s) + np.arange(cfg.m_sc)
                           for s in syms]).astype(np.int64)


def _map_grid(q: torch.Tensor, cfg: PuschConfig) -> torch.Tensor:
    """Scrambled bits q[..., G] -> modulate, DFT-spread, map with the
    DMRS -> UL grid [..., nsymb, nre]."""
    cell = cfg.cell
    syms = modulate(q, cfg.mod)
    lead = syms.shape[:-1]
    spread = dft_precode(syms.reshape(*lead, cfg.nof_data_symbols, cfg.m_sc))
    dmrs = device_table(("pusch_dmrs", cfg), q.device, lambda: pusch_dmrs(
        cell, cfg.n_prb, cfg.cyclic_shift, cfg.delta_ss, cfg.sf_idx,
        cfg.group_hopping, cfg.sequence_hopping).reshape(-1))
    vals = torch.cat([spread.reshape(*lead, -1),
                      dmrs.expand(*lead, 2 * cfg.m_sc)], dim=-1)
    idx = device_table(("pusch_grid_idx", cfg), q.device,
                       lambda: _grid_indices(cfg))
    flat = vals.new_zeros((*lead, cell.nsymb_sf * cell.nof_re))
    flat[..., idx] = vals
    return flat.reshape(*lead, cell.nsymb_sf, cell.nof_re)


def pusch_encode(tb_bits: torch.Tensor, cfg: PuschConfig,
                 plan: DlschPlan) -> torch.Tensor:
    """tb_bits[..., tbs] -> UL grid [..., nsymb, nre] (single antenna)."""
    coded = dlsch_encode(tb_bits, plan)
    return _map_grid(scramble_bits(coded, cfg.cinit()), cfg)


def _pusch_llrs(grid: torch.Tensor, cfg: PuschConfig, noise_est,
                int8: bool = False) -> torch.Tensor:
    """DMRS chest, per-RE MMSE, IDFT despread, soft demap, CSI weight,
    ``int8``: quantize to the 8-bit lane, and descramble: grid [..., nsymb,
    nre] -> LLRs [..., G]."""
    cell = cfg.cell
    st0, st1 = cfg.slot_starts()
    with trace.span("pusch.chest"):
        h = chest_ul_pusch(grid, cell, cfg.prb_start, cfg.n_prb,
                           cfg.cyclic_shift,
                           prb_start_slot1=cfg.prb_start_slot1,
                           sf_idx=cfg.sf_idx, delta_ss=cfg.delta_ss,
                           group_hopping=cfg.group_hopping,
                           sequence_hopping=cfg.sequence_hopping)
    with trace.span("pusch.eq_demod"):
        if st0 == st1:
            alloc = grid[..., 12 * st0:12 * st0 + cfg.m_sc]
        else:
            half = cell.nsymb_slot
            alloc = torch.cat(
                [grid[..., :half, 12 * st0:12 * st0 + cfg.m_sc],
                 grid[..., half:, 12 * st1:12 * st1 + cfg.m_sc]], dim=-2)
        data_syms = device_table(("pusch_data_syms", cfg), grid.device,
                                 lambda: cfg.data_symbol_indices)
        y = alloc[..., data_syms, :]
        hh = h[..., data_syms, :]
        h2 = hh.abs() ** 2
        x = y * torch.conj(hh) / (h2 + noise_est)
        despread = dft_deprecode(x)
        lead = despread.shape[:-2]
        llr = demod_soft(despread.reshape(*lead, -1), cfg.mod)
        # weight by the mean channel gain per symbol (post-IDFT the
        # per-RE CSI averages across the allocation)
        csi = torch.mean(h2, dim=-1)                        # [..., nsym]
        llr = llr * torch.repeat_interleave(
            csi, cfg.m_sc * cfg.mod.bits_per_symbol, dim=-1)
        if int8:
            llr = quantize_llr_int8(llr, cfg.mod)
        return descramble_llrs(llr, cfg.cinit())


def pusch_decode(grid: torch.Tensor, cfg: PuschConfig, plan: DlschPlan,
                 noise_est=0.0, iters_out: list | None = None,
                 softbuffers=None):
    """eNB receive: grid [..., nsymb, nre] -> (tb, crc_ok, softbuffers)
    (srslte_enb_ul chain, enb_ul.c:256-386); ``cfg.llr_int8`` decodes on
    the 8-bit LLR lane (int8 LLRs, de-rate-matching and softbuffers)."""
    llr = _pusch_llrs(grid, cfg, noise_est, int8=cfg.llr_int8)
    return dlsch_decode(llr, plan, softbuffers=softbuffers,
                        iters_out=iters_out)


@functools.lru_cache(maxsize=None)
def pusch_decode_jit(cfg: PuschConfig, tbs: int, rv: int = 0,
                     with_soft: bool = False):
    """Cached PUSCH decode for one (config, TBS, rv), the eNB stack's per
    grant call: ``fn(grid, noise)`` or, ``with_soft``,
    ``fn(grid, noise, softbuffers)`` -> ``pusch_decode``'s (tb, crc_ok,
    softbuffers), with the plan built once per key."""
    plan = cfg.plan(tbs, rv=rv)
    if with_soft:
        return lambda grid, noise, soft: pusch_decode(
            grid, cfg, plan, noise_est=noise, softbuffers=soft)
    return lambda grid, noise: pusch_decode(grid, cfg, plan,
                                            noise_est=noise)


# --- UCI multiplexing on PUSCH (36.212 5.2.2; sch.c:550-1095) ----------------


@dataclass(frozen=True)
class UciData:
    """UCI payload riding on a PUSCH grant (srslte_uci_data_t parity)."""

    cqi_bits: tuple = ()        # CQI/PMI payload bits (O of them)
    ri: int | None = None       # 1-bit rank indicator
    ack: tuple = ()             # 0/1/2 HARQ-ACK bits
    i_offset_cqi: int = 7
    i_offset_ri: int = 2
    i_offset_ack: int = 2


class UciPlan:
    """Static per-grant UCI layout: Q' sizes, RI/ACK bit positions, the
    5.2.2.8 channel-interleaver permutation and the UL-SCH plan of the
    data part — all computed on the host."""

    def __init__(self, cfg: PuschConfig, tbs: int, uci: UciData,
                 rv: int = 0, max_iterations: int = 5,
                 decoder_impl: str = "nii"):
        self.cfg = cfg
        self.uci = uci
        qm = cfg.mod.bits_per_symbol
        nb_q = cfg.g
        n_symb = cfg.nof_data_symbols
        h_total = nb_q // qm
        self.rows = h_total // n_symb
        self.qm = qm
        self.nb_q = nb_q
        normal_cp = cfg.cell.cp is CP.NORM

        if tbs > 0:
            segm = cbsegm(tbs)
            k_sum = segm.c_plus * segm.k_plus + segm.c_minus * segm.k_minus
        else:
            k_sum = 0
        m_sc, o_cqi = cfg.m_sc, len(uci.cqi_bits)

        def beta_div(beta):
            # UCI-only PUSCH: beta is relative to the CQI offset (sch.c:1016)
            if tbs == 0:
                return beta / uci_mod.BETA_CQI_OFFSET[uci.i_offset_cqi]
            return beta

        if uci.ri is not None:
            beta = beta_div(uci_mod.BETA_RI_OFFSET[uci.i_offset_ri])
            self.q_ri = uci_mod.q_prime_ri_ack(1, o_cqi, beta, m_sc,
                                               n_symb, k_sum, m_sc)
            self.ri_pos = uci_mod.ri_ack_positions(
                self.q_ri, qm, self.rows, normal_cp, ack=False)
        else:
            self.q_ri, self.ri_pos = 0, np.zeros(0, np.int64)

        # ACK punctures data; positions like RI's, columns around DMRS
        if len(uci.ack):
            beta = beta_div(uci_mod.BETA_HARQ_OFFSET[uci.i_offset_ack])
            self.q_ack = uci_mod.q_prime_ri_ack(len(uci.ack), o_cqi, beta,
                                                m_sc, n_symb, k_sum, m_sc)
            self.ack_pos = uci_mod.ri_ack_positions(
                self.q_ack, qm, self.rows, normal_cp, ack=True)
        else:
            self.q_ack, self.ack_pos = 0, np.zeros(0, np.int64)

        if o_cqi:
            beta = uci_mod.BETA_CQI_OFFSET[uci.i_offset_cqi]
            self.q_cqi = uci_mod.q_prime_cqi(o_cqi, beta, self.q_ri, m_sc,
                                             n_symb, k_sum, m_sc, n_symb)
        else:
            self.q_cqi = 0

        self.perm = uci_mod.ulsch_interleaver_perm(h_total, n_symb, qm,
                                                   self.ri_pos)
        self.g_data = nb_q - (self.q_ri + self.q_cqi) * qm
        self.tbs = tbs
        self.data_plan = (DlschPlan(tbs=tbs, g=self.g_data, qm=qm, rv=rv,
                                    max_iterations=max_iterations,
                                    decoder_impl=decoder_impl)
                          if tbs > 0 else None)

    def table(self, name: str, device) -> torch.Tensor:
        """One of the plan's static tables as a tensor on ``device``,
        built on the host once per (grant, UCI layout, device): ``perm``,
        the ACK puncturing mask ``ack_zmask``, and ``{ri,ack}_idx`` /
        ``{ri,ack}_w``, the gather index and weights of an RI/ACK field's
        soft sums."""
        u = self.uci
        key = ("uci_plan", name, self.cfg, self.tbs, len(u.cqi_bits),
               u.ri is not None, len(u.ack), u.i_offset_cqi, u.i_offset_ri,
               u.i_offset_ack)
        return device_table(key, device, lambda: self._host_table(name))

    def _host_table(self, name: str) -> np.ndarray:
        if name == "perm":
            return self.perm
        if name == "ack_zmask":
            val = np.ones(self.nb_q, np.float32)
            val[self.ack_pos] = 0.0
            return val
        field, part = name.split("_")
        if field == "ri":
            tabs = self._field_sums(self.ri_pos, self.q_ri, 1)
        else:
            tabs = self._field_sums(self.ack_pos, self.q_ack,
                                    len(self.uci.ack))
        return tabs[0] if part == "idx" else tabs[1]

    def _field_sums(self, positions: np.ndarray, q_prime: int,
                    nof_bits: int):
        """(idx [n], w [n, sums]): an RI/ACK field's soft sums are
        ``llr[..., idx] @ w`` on descrambled LLRs (positive <=> bit 0).

        1-bit field: one sum over the first bit of each repetition, plus,
        for Qm >= 2, the repetition (y) bit, which repeats the *scrambled*
        previous bit, so after descrambling it needs the sign of
        s[p-1]^s[p]. 2-bit field: repetition m%3 carries (b0,b1)/(b2,b0)/
        (b1,b2) at k=0,1, one sum per bit."""
        qm = self.qm
        pos = positions.reshape(q_prime, qm)
        cols = pos[:, :min(qm, 2)].T                       # [<=2, q']
        w = np.zeros((cols.shape[0], q_prime, 1 if nof_bits == 1 else 3),
                     np.float32)
        if nof_bits == 1:
            w[0, :, 0] = 1.0
            if qm >= 2:
                seq = gold_sequence(self.cfg.cinit(), self.nb_q)
                p1 = pos[:, 1]
                w[1, :, 0] = 1.0 - 2.0 * (seq[p1 - 1] ^ seq[p1])
        else:
            carriers = [(0, 1), (2, 0), (1, 2)]
            for i in range(q_prime):
                for j in range(cols.shape[0]):
                    w[j, i, carriers[i % 3][j]] = 1.0
        return cols.reshape(-1).astype(np.int64), w.reshape(-1, w.shape[-1])

    def _overlay(self, positions: np.ndarray, values, q_prime: int):
        """(data_pos, data_bits, ph_pos, rep_pos) for one RI/ACK field."""
        pat = uci_mod.ri_ack_pattern(np.asarray(values), self.qm)
        codes = np.array([pat[(i * self.qm + k) % len(pat)]
                          for i in range(q_prime) for k in range(self.qm)])
        data_m = codes <= 1
        return (positions[data_m], codes[data_m].astype(np.int8),
                positions[codes == uci_mod.UCI_BIT_PLACEHOLDER],
                positions[codes == uci_mod.UCI_BIT_REPETITION])


def pusch_encode_uci(tb_bits: torch.Tensor, cfg: PuschConfig,
                     plan: UciPlan) -> torch.Tensor:
    """Full UL-SCH+UCI encode (srslte_ulsch_uci_encode sch.c:995-1095 and
    the pusch.c:536-560 placeholder fixups) -> UL grid [..., nsymb, nre].
    The UCI payload (the plan's) is the same for every leading index."""
    uci = plan.uci
    qm, nb_q = plan.qm, plan.nb_q
    lead = tb_bits.shape[:-1]
    dev = tb_bits.device

    parts = []
    if plan.q_cqi:
        cqi = uci_mod.encode_cqi_pusch(np.asarray(uci.cqi_bits, np.int8),
                                       plan.q_cqi * qm)
        parts.append(torch.as_tensor(cqi, device=dev).expand(*lead, -1))
    if plan.tbs > 0:
        parts.append(dlsch_encode(tb_bits, plan.data_plan).to(torch.int8))
    g = torch.cat(parts, dim=-1)

    # channel interleave: scatter through the precomputed permutation
    q = g.new_zeros((*lead, nb_q))
    q[..., plan.table("perm", dev)] = g

    # RI/ACK overlays; placeholder (x) bits become 1 and repetition (y)
    # bits copy the previous scrambled bit after scrambling
    # (pusch.c:543-556)
    overlays = []
    if plan.q_ri:
        overlays.append(plan._overlay(plan.ri_pos, [uci.ri], plan.q_ri))
    if plan.q_ack:
        overlays.append(plan._overlay(plan.ack_pos, list(uci.ack),
                                      plan.q_ack))
    ph_pos, rep_pos = [], []
    for data_pos, data_bits, ph, rep in overlays:
        q[..., torch.as_tensor(data_pos, device=dev)] = torch.as_tensor(
            data_bits, device=dev)
        ph_pos.append(ph)
        rep_pos.append(rep)
    q = scramble_bits(q, cfg.cinit())
    if ph_pos:
        q[..., torch.as_tensor(np.concatenate(ph_pos), device=dev)] = 1
        rep = torch.as_tensor(np.concatenate(rep_pos), device=dev)
        q[..., rep] = q[..., rep - 1]
    return _map_grid(q, cfg)


#: ML over (b0, b1) with b2 = b0^b1: the signs of the three soft sums
#: for (b0, b1) = 00, 01, 10, 11
_ACK2_SIGNS = np.array([[1 - 2 * b0, 1 - 2 * b1, 1 - 2 * (b0 ^ b1)]
                        for b0 in (0, 1) for b1 in (0, 1)], np.float32).T


def _decode_ri_ack_field(llr: torch.Tensor, plan: UciPlan, field: str,
                         nof_bits: int) -> list[torch.Tensor]:
    """Soft-combine one RI/ACK field (``"ri"`` or ``"ack"``) from
    descrambled LLRs: one gather and one product with the plan's tables."""
    dev = llr.device
    sums = llr[..., plan.table(f"{field}_idx", dev)] \
        @ plan.table(f"{field}_w", dev)
    if nof_bits == 1:
        return [(sums[..., 0] < 0).to(torch.int8)]
    best = torch.argmax(sums @ device_table("ack2_signs", dev,
                                            lambda: _ACK2_SIGNS), dim=-1)
    return [(best >> 1).to(torch.int8), (best & 1).to(torch.int8)]


def pusch_decode_uci(grid: torch.Tensor, cfg: PuschConfig, plan: UciPlan,
                     noise_est=0.0, softbuffers=None,
                     iters_out: list | None = None) -> dict:
    """eNB receive with UCI demux (srslte_ulsch_uci_decode sch.c:884-985).

    -> dict with 'tb', 'crc_ok', 'softbuffers', 'cqi_bits', 'cqi_ok' (the
    CRC8 of a long CQI; all True for a short one), 'ri' and 'ack' (a
    tuple), each a tensor over the leading dims, or None / () when the
    plan carries no such field. The LLRs stay float32 whatever
    ``cfg.llr_int8`` says, as in the reference package.
    """
    llr = _pusch_llrs(grid, cfg, noise_est)
    out = {"ri": None, "ack": (), "cqi_bits": None, "cqi_ok": None,
           "tb": None, "crc_ok": None, "softbuffers": None}
    with trace.span("pusch.uci_demux"):
        if plan.q_ack:
            out["ack"] = tuple(_decode_ri_ack_field(llr, plan, "ack",
                                                    len(plan.uci.ack)))
            # zero the punctured positions before data demux
            # (sch.c:925-928)
            llr = llr * plan.table("ack_zmask", llr.device)
        if plan.q_ri:
            out["ri"] = _decode_ri_ack_field(llr, plan, "ri", 1)[0]
        g = llr[..., plan.table("perm", llr.device)]
    n_cqi = plan.q_cqi * plan.qm
    if plan.q_cqi:
        out["cqi_bits"], out["cqi_ok"] = uci_mod.decode_cqi_pusch(
            g[..., :n_cqi], len(plan.uci.cqi_bits), n_cqi)
    if plan.tbs > 0:
        out["tb"], out["crc_ok"], out["softbuffers"] = dlsch_decode(
            g[..., n_cqi:], plan.data_plan, softbuffers=softbuffers,
            iters_out=iters_out)
    return out


@functools.lru_cache(maxsize=None)
def pusch_decode_uci_jit(cfg: PuschConfig, plan: UciPlan,
                         with_soft: bool = False):
    """Cached PUSCH+UCI decode for one (config, plan): ``fn(grid, noise)``
    or, ``with_soft``, ``fn(grid, noise, softbuffers)`` ->
    ``pusch_decode_uci``'s dict (see ``pusch_decode_jit``)."""
    if with_soft:
        return lambda grid, noise, soft: pusch_decode_uci(
            grid, cfg, plan, noise_est=noise, softbuffers=soft)
    return lambda grid, noise: pusch_decode_uci(grid, cfg, plan,
                                                noise_est=noise)
