"""PMCH: physical multicast channel for eMBMS/MBSFN (36.211 6.5/6.10.2).

Capability parity with lib/src/phy/phch/pmch.c: a PDSCH-like processor
with MBSFN-area scrambling (36.211 6.5: c_init from the MBSFN area id),
extended-CP MBSFN region, MBSFN reference signals on antenna port 4
(36.211 6.10.2) and full-band allocation.

Counterpart of the JAX package's models/pmch.py:30-165. The RS values,
RE map and interpolation weights are host-side numpy tables (cached, and
on the device once per config through ``device_table``); encode, channel
estimate and decode are torch over any leading batch dims. ``pmch_decode``
decodes its transport blocks with ``models/sch.py dlsch_decode``, whose
default plan runs the NII turbo kernel (csrc/turbo_nii.cu) on a CUDA
tensor. The RE map takes its RS positions from area 0, as the JAX
package's does: the MBSFN RS positions do not depend on the area.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.chest import time_interp_apply
from ..ops.modem import Mod, demod_soft, modulate
from ..ops.scrambling import descramble_llrs, scramble_bits
from ..runtime import trace
from ..utils.cell import CP, Cell
from ..utils.device import device_table, resolve_device
from ..utils.sequence import cinit_pmch, prs_sequence
from .sch import DlschPlan, dlsch_decode, dlsch_encode

#: Subframe symbols carrying MBSFN RS (extended CP, 15 kHz, 36.211 6.10.2.2).
MBSFN_RS_SYMS = (2, 6, 10)


@functools.lru_cache(maxsize=256)
def mbsfn_rs(area_id: int, nof_prb: int, sf_idx: int):
    """(re_idx[3][3*prb... ], syms[3], values[3][...]): MBSFN RS every other
    subcarrier (6 per PRB over 2 symbol groups -> 3 per PRB per symbol)."""
    rows_idx, rows_val = [], []
    nre = 12 * nof_prb
    max_prb = 110
    for i, l in enumerate(MBSFN_RS_SYMS):
        ns = 2 * sf_idx + (0 if l < 6 else 1)
        l_slot = l if l < 6 else l - 6
        c_init = ((7 * (ns + 1) + l_slot + 1) * (2 * area_id + 1) << 9) \
            + area_id
        r = prs_sequence(c_init, 6 * max_prb)
        m = np.arange(6 * nof_prb)
        m_prime = m + 3 * (max_prb - nof_prb)   # center in the max-BW seq
        k = 2 * m + (1 if i == 1 else 0)   # offset alternates per symbol
        keep = k < nre
        rows_idx.append(k[keep].astype(np.int32))
        rows_val.append(r[m_prime[keep]])
    syms = np.asarray(MBSFN_RS_SYMS, np.int32)
    return rows_idx, syms, rows_val


@functools.lru_cache(maxsize=256)
def pmch_re_indices(cell: Cell, sf_idx: int, cfi: int = 1) -> np.ndarray:
    """PMCH REs: all non-control REs except MBSFN RS (full band)."""
    nre = cell.nof_re
    usable = np.ones((cell.nsymb_sf, nre), dtype=bool)
    usable[:cfi, :] = False
    idx_rows, syms, _ = mbsfn_rs(0, cell.nof_prb, sf_idx)
    for row, s in zip(idx_rows, syms):
        # only the RS REs themselves are excluded; data rides the other
        # subcarriers of RS symbols (srslte_pmch_cp prb_cp_ref with
        # nof_refs=6, pmch.c:63-105)
        usable[s, row] = False
    sym_idx, k_idx = np.nonzero(usable)
    order = np.lexsort((k_idx, sym_idx))
    return (sym_idx[order] * nre + k_idx[order]).astype(np.int64)


@dataclass(frozen=True)
class PmchConfig:
    cell: Cell                     # extended-CP cell for MBSFN subframes
    area_id: int = 1
    sf_idx: int = 1
    cfi: int = 1
    mod: Mod = Mod.QAM16

    def __post_init__(self):
        if self.cell.cp is not CP.EXT:
            raise ValueError("PMCH requires the extended-CP cell")

    @property
    def nof_re(self) -> int:
        return len(pmch_re_indices(self.cell, self.sf_idx, self.cfi))

    @property
    def g(self) -> int:
        return self.nof_re * self.mod.bits_per_symbol

    def plan(self, tbs: int, max_iterations: int = 5,
             decoder_impl: str = "nii") -> DlschPlan:
        return DlschPlan(tbs=tbs, g=self.g, qm=self.mod.bits_per_symbol,
                         max_iterations=max_iterations,
                         decoder_impl=decoder_impl)

    def cinit(self) -> int:
        return cinit_pmch(self.area_id, 2 * self.sf_idx)

    def re_index_tensor(self, device) -> torch.Tensor:
        return device_table(("pmch_re", self.cell, self.sf_idx, self.cfi),
                            device, lambda: pmch_re_indices(
                                self.cell, self.sf_idx, self.cfi))


def _rs_tables(cfg: PmchConfig):
    """(flat RS indices [n_rs] int64, RS values [n_rs] complex64) over the
    three RS symbols, symbol-major."""
    idx_rows, syms, vals = mbsfn_rs(cfg.area_id, cfg.cell.nof_prb,
                                    cfg.sf_idx)
    nre = cfg.cell.nof_re
    idx = np.concatenate([int(s) * nre + row.astype(np.int64)
                          for row, s in zip(idx_rows, syms)])
    return idx, np.concatenate(vals).astype(np.complex64)


def _rs_device(cfg: PmchConfig, device):
    key = ("mbsfn_rs", cfg.area_id, cfg.cell.nof_prb, cfg.sf_idx)
    return (device_table(key + ("idx",), device, lambda: _rs_tables(cfg)[0]),
            device_table(key + ("val",), device, lambda: _rs_tables(cfg)[1]))


def pmch_put_rs(grid: torch.Tensor, cfg: PmchConfig) -> torch.Tensor:
    """Insert MBSFN RS into [..., nsymb, nre] (the RS REs are set)."""
    idx, val = _rs_device(cfg, grid.device)
    flat = grid.reshape(*grid.shape[:-2], -1).clone()
    flat[..., idx] = val
    return flat.reshape(grid.shape)


def pmch_encode(tb_bits: torch.Tensor, cfg: PmchConfig,
                plan: DlschPlan) -> torch.Tensor:
    """tb[..., tbs] -> MBSFN subframe grid [..., nsymb, nre] (with RS), on
    the TB bits' device."""
    cell = cfg.cell
    coded = dlsch_encode(tb_bits, plan)
    syms = modulate(scramble_bits(coded, cfg.cinit()), cfg.mod)
    lead = syms.shape[:-1]
    flat = syms.new_zeros((*lead, cell.nsymb_sf * cell.nof_re))
    flat[..., cfg.re_index_tensor(syms.device)] = syms
    return pmch_put_rs(flat.reshape(*lead, cell.nsymb_sf, cell.nof_re), cfg)


@functools.lru_cache(maxsize=64)
def _interp_tables(cfg: PmchConfig):
    """Per RS symbol the frequency interpolation (left RS position in the
    symbol's RS list [nre] int64, weight t [nre] float32), and the time
    weights [nsymb, 3] float32 (linear between RS symbols, extrapolated
    at the edges)."""
    idx_rows, syms, _ = mbsfn_rs(cfg.area_id, cfg.cell.nof_prb, cfg.sf_idx)
    nre = cfg.cell.nof_re
    freq = []
    for row in idx_rows:
        x = np.asarray(row, np.float64)
        w0 = np.clip(np.searchsorted(x, np.arange(nre)) - 1, 0, len(x) - 2)
        t = (np.arange(nre) - x[w0]) / (x[w0 + 1] - x[w0])
        freq.append((w0.astype(np.int64), t.astype(np.float32)))
    ts = np.asarray(syms, np.float64)
    tw = np.zeros((cfg.cell.nsymb_sf, len(ts)), np.float32)
    for s in range(cfg.cell.nsymb_sf):
        j = int(np.clip(np.searchsorted(ts, s) - 1, 0, len(ts) - 2))
        w = (s - ts[j]) / (ts[j + 1] - ts[j])
        tw[s, j] = 1 - w
        tw[s, j + 1] = w
    return freq, tw


def pmch_chest(grid: torch.Tensor, cfg: PmchConfig) -> torch.Tensor:
    """LS + interpolation over MBSFN RS -> h [..., nsymb, nre]: linear in
    frequency within each RS symbol, then linear in time across the three
    RS symbols (profiler range ``pmch.chest``)."""
    with trace.span("pmch.chest"):
        dev = grid.device
        idx_rows, syms, vals = mbsfn_rs(cfg.area_id, cfg.cell.nof_prb,
                                        cfg.sf_idx)
        freq, tw = _interp_tables(cfg)
        key = ("pmch_chest", cfg.area_id, cfg.cell.nof_prb, cfg.sf_idx)
        h_rows = []
        for i, s in enumerate(syms):
            row = device_table(key + ("row", i), dev,
                               lambda i=i: idx_rows[i].astype(np.int64))
            vc = device_table(key + ("conj", i), dev,
                              lambda i=i: np.conj(vals[i]))
            w0 = device_table(key + ("w0", i), dev, lambda i=i: freq[i][0])
            t = device_table(key + ("t", i), dev, lambda i=i: freq[i][1])
            ls = grid[..., int(s), row] * vc
            h_rows.append(ls[..., w0] * (1 - t) + ls[..., w0 + 1] * t)
        return time_interp_apply(tw, torch.stack(h_rows, dim=-2))


def pmch_decode(grid: torch.Tensor, cfg: PmchConfig, plan: DlschPlan,
                noise_est=0.0, h: torch.Tensor | None = None,
                iters_out: list | None = None):
    """MBSFN subframe decode -> (tb [..., tbs], crc_ok [...], softbuffers):
    MMSE-scaled single-antenna equalization with CSI-weighted LLRs,
    descrambling, then ``dlsch_decode``. ``iters_out`` (a list) receives
    the turbo iteration counts. Profiler ranges ``pmch.chest`` (when h is
    not given) and ``pmch.eq_demod``, then ``dlsch.*``."""
    if h is None:
        h = pmch_chest(grid, cfg)
    with trace.span("pmch.eq_demod"):
        idx = cfg.re_index_tensor(grid.device)
        y = grid.reshape(*grid.shape[:-2], -1)[..., idx]
        hh = h.reshape(*h.shape[:-2], -1)[..., idx]
        e = hh.abs() ** 2
        x = y * torch.conj(hh) / (e + noise_est)
        llr = demod_soft(x, cfg.mod) * torch.repeat_interleave(
            e, cfg.mod.bits_per_symbol, dim=-1)
        llr = descramble_llrs(llr, cfg.cinit())
    return dlsch_decode(llr, plan, iters_out=iters_out)


# --- the MBSFN broadcast: a batch of PMCH subframes --------------------------

#: the JAX stack's MBMS settings (stack/mbms.py, stack/ue.py:821-827):
#: MBSFN area 1, the PMCH in subframe 1 of the stimulus, a 2-symbol
#: non-MBSFN region (cfi 2), the MCCH at MCS 2; data at MCS 16
MBMS_AREA, MBMS_SF, MBMS_CFI, MCCH_MCS, MTCH_MCS = 1, 1, 2, 2, 16
MBMS_SNR_DB, MBMS_SEED = 25.0, 51


@dataclass
class PmchBatch:
    """MBSFN subframes as received, and what they must decode to."""

    cell: Cell                   # the serving (normal-CP) cell: OFDM
    cfg: PmchConfig              # on its extended-CP twin
    plan: DlschPlan
    samples: torch.Tensor        # [B, sf_len] complex64
    tb: torch.Tensor             # [B, tbs] int8
    n0: float                    # noise per grid RE


def pmch_stimulus(batch: int, *, mcs: int = MTCH_MCS, nof_prb: int = 100,
                  device=None) -> PmchBatch:
    """``batch`` MBSFN subframes of Cell(nof_prb, id 1), full-band PMCH at
    ``mcs`` with random TBs: ``pmch_encode`` on the extended-CP twin of
    the cell (the JAX stack's ``mbsfn_cell``), ``ofdm_tx_sf_mbsfn`` with
    the ``MBMS_CFI``-symbol non-MBSFN region, a flat gain per subframe and
    AWGN ``MBMS_SNR_DB`` below a unit-power RE. TB bits and gains are
    numpy draws from ``MBMS_SEED``, the noise a torch draw on the card."""
    from ..ops.channel import awgn
    from ..ops.ofdm import ofdm_tx_sf_mbsfn
    from . import ra

    dev = resolve_device(device)
    cell = Cell(nof_prb=nof_prb, id=1)
    mod, tbs = ra.mcs_to_tbs(mcs, nof_prb)
    cfg = PmchConfig(cell=Cell(nof_prb=nof_prb, id=1, cp=CP.EXT),
                     area_id=MBMS_AREA, sf_idx=MBMS_SF, cfi=MBMS_CFI,
                     mod=mod)
    plan = cfg.plan(tbs)
    rng = np.random.default_rng(MBMS_SEED)
    tb = torch.as_tensor(rng.integers(0, 2, (batch, tbs)).astype(np.int8),
                         device=dev)
    gain = (rng.uniform(0.7, 1.3, (batch, 1))
            * np.exp(2j * np.pi * rng.random((batch, 1))))
    x = ofdm_tx_sf_mbsfn(pmch_encode(tb, cfg, plan), cell, MBMS_CFI) \
        * torch.as_tensor(gain.astype(np.complex64), device=dev)
    n0 = 10 ** (-MBMS_SNR_DB / 10)
    gen = torch.Generator(device=dev).manual_seed(MBMS_SEED)
    return PmchBatch(cell, cfg, plan, awgn(gen, x, n0 / cell.fft_size), tb,
                     n0)


def pmch_receive(samples: torch.Tensor, st: PmchBatch,
                 iters_out: list | None = None):
    """The UE's MBSFN decode of ``pmch_stimulus``'s subframes:
    ``ofdm_rx_sf_mbsfn`` (profiler range ``pmch.ofdm_rx``) ->
    ``pmch_decode`` with its own ``pmch_chest`` -> (tb, crc_ok,
    softbuffers)."""
    from ..ops.ofdm import ofdm_rx_sf_mbsfn

    with trace.span("pmch.ofdm_rx"):
        grid = ofdm_rx_sf_mbsfn(samples, st.cell, MBMS_CFI)
    return pmch_decode(grid, st.cfg, st.plan, noise_est=st.n0,
                       iters_out=iters_out)
