"""PDSCH: physical downlink shared channel processor.

Capability parity with lib/src/phy/phch/pdsch.c: RE mapping that skips
CRS/sync/PBCH regions (pdsch_cp, pdsch.c:95-214), per-RNTI scrambling
(pdsch.c:616-632), codeword encode/decode (pdsch.c:634-835) with
CSI-weighted LLRs (csi_correction, pdsch.c:676-776), the 8-bit LLR lane,
and the MIMO dispatch to the single-antenna, SFBC / SFBC-FSTD diversity,
2x2 spatial-multiplexing and large-delay CDD paths. The RE map is a
precomputed flat index table per (cell, sf_idx, cfi, allocation): one
gather (decode) or index assignment (encode).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.equalizer import (MimoType, effective_channel_cdd,
                             effective_channel_mux, eq_mux_2x2, eq_sfbc,
                             eq_sfbc_fstd, eq_single, layerdemap, layermap,
                             precode_cdd_2layer, precode_mux_2x2,
                             precode_sfbc, precode_sfbc_fstd)
from ..ops.modem import Mod, demod_soft, modulate, quantize_llr_int8
from ..ops.scrambling import descramble_llrs, scramble_bits
from ..runtime import trace
from ..runtime.graphs import EAGER
from ..utils.cell import Cell
from ..utils.device import device_table
from ..utils.sequence import cinit_pdsch
from .refsignal import crs_mask
from .regs import nof_ctrl_symbols
from .sch import DlschPlan, dlsch_decode, dlsch_encode

#: Central subcarriers reserved for PSS/SSS (72 = 6 PRB around DC).
SYNC_RE = 72


@functools.lru_cache(maxsize=1024)
def pdsch_re_indices(cell: Cell, sf_idx: int, cfi: int,
                     prb_mask: tuple[bool, ...] | None = None,
                     prb_mask_slot1: tuple[bool, ...] | None = None
                     ) -> np.ndarray:
    """Flat indices (s * nof_re + k) of PDSCH REs in 36.211 6.3.5 mapping
    order (k ascending within each symbol, symbols ascending), skipping
    the control region, CRS, and the PSS/SSS/PBCH reservations of
    subframes 0 and 5 (pdsch_cp, pdsch.c:95-214)."""
    nre = cell.nof_re
    usable = np.ones((cell.nsymb_sf, nre), dtype=bool)
    usable[:nof_ctrl_symbols(cell, cfi), :] = False   # control region
    usable[crs_mask(cell, sf_idx)] = False        # CRS of all cell ports

    mid = nre // 2
    sync_cols = slice(mid - SYNC_RE // 2, mid + SYNC_RE // 2)
    nsym_slot = cell.nsymb_slot
    if sf_idx == 0 or sf_idx == 5:
        usable[nsym_slot - 1, sync_cols] = False
        usable[nsym_slot - 2, sync_cols] = False
    if sf_idx == 0:
        for s in range(nsym_slot, nsym_slot + 4):
            usable[s, sync_cols] = False

    if prb_mask is not None:
        col = np.repeat(np.asarray(prb_mask, dtype=bool), 12)
        if prb_mask_slot1 is not None:
            col1 = np.repeat(np.asarray(prb_mask_slot1, dtype=bool), 12)
            usable[:cell.nsymb_slot] &= col[None, :]
            usable[cell.nsymb_slot:] &= col1[None, :]
        else:
            usable &= col[None, :]

    sym_idx, k_idx = np.nonzero(usable)
    order = np.lexsort((k_idx, sym_idx))          # symbol-major, k fastest
    return (sym_idx[order] * nre + k_idx[order]).astype(np.int64)


@dataclass(frozen=True)
class PdschConfig:
    """Static PDSCH configuration for one (cell, grant) combination."""

    cell: Cell
    sf_idx: int = 0
    cfi: int = 1
    rnti: int = 0x1234
    mod: Mod = Mod.QPSK
    mimo: MimoType = MimoType.SINGLE
    nof_layers: int = 1
    nof_codewords: int = 1
    pmi: int = 0
    prb_mask: tuple[bool, ...] | None = None
    prb_mask_slot1: tuple[bool, ...] | None = None
    #: 8-bit quantized LLR lane (demod_soft.c byte scales + rm_turbo.c
    #: int8 combining): quantize after CSI weighting, descramble, de-RM
    #: and HARQ-combine in int8; the turbo decoder reads them as float32
    llr_int8: bool = False

    @functools.cached_property
    def re_indices(self) -> np.ndarray:
        return pdsch_re_indices(self.cell, self.sf_idx, self.cfi,
                                self.prb_mask, self.prb_mask_slot1)

    def re_index_tensor(self, device) -> torch.Tensor:
        return device_table(("pdsch_re", self), device,
                            lambda: self.re_indices)

    @property
    def nof_re(self) -> int:
        """REs per antenna port available to this allocation."""
        return len(self.re_indices)

    @property
    def nof_symbols(self) -> int:
        """Modulation symbols per codeword."""
        if self.mimo is MimoType.SINGLE:
            return self.nof_re
        if self.mimo is MimoType.DIVERSITY:
            group = 4 if self.cell.nof_ports == 4 else 2
            return self.nof_re - (self.nof_re % group)
        return self.nof_re * self.nof_layers // self.nof_codewords

    @property
    def g(self) -> int:
        """Codeword bits carried (per codeword)."""
        return self.nof_symbols * self.mod.bits_per_symbol

    @property
    def split_layers(self) -> int:
        """N_L of a codeword's E split (36.212 5.1.4.1.2): 2 for transmit
        diversity and for one codeword on two layers, else 1."""
        if self.mimo is MimoType.DIVERSITY:
            return 2
        if self.mimo is not MimoType.SINGLE and self.nof_codewords == 1 \
                and self.nof_layers == 2:
            return 2
        return 1

    def plan(self, tbs: int, rv: int = 0, max_iterations: int = 5,
             decoder_impl: str = "nii") -> DlschPlan:
        return DlschPlan(tbs=tbs, g=self.g, qm=self.mod.bits_per_symbol,
                         rv=rv, n_layers=self.split_layers,
                         max_iterations=max_iterations,
                         decoder_impl=decoder_impl)

    def cinit(self, codeword: int = 0) -> int:
        return cinit_pdsch(self.rnti, codeword, 2 * self.sf_idx, self.cell.id)


# --- encode (eNB side) ------------------------------------------------------


def pdsch_encode(tb_bits, cfg: PdschConfig, plan: DlschPlan, tb_bits2=None,
                 plan2: DlschPlan | None = None, *, grid=None):
    """tb_bits[..., tbs] -> per-port grid [..., ports, nsymb, nre] complex64.

    DL-SCH encode -> scramble -> modulate -> layer map -> precode -> RE
    placement (srslte_pdsch_encode, pdsch.c:1048). Two codewords of one
    plan encode as ONE ``dlsch_encode`` with a leading codeword axis
    (its ``dlsch.*`` ranges); the rest runs in the range ``pdsch.map``.
    With ``grid`` [..., P, nsymb, nre] (P at least the scheme's ports)
    the PDSCH's REs are written into it in place and it is returned.
    """
    pairs = [(tb_bits, plan)] + ([(tb_bits2, plan2)]
                                 if tb_bits2 is not None else [])
    if len(pairs) == 2 and plan == plan2 and tb_bits.shape == tb_bits2.shape:
        coded = list(dlsch_encode([tb_bits, tb_bits2], plan))
    else:
        coded = [dlsch_encode(bits, pl) for bits, pl in pairs]
    with trace.span("pdsch.map"):
        cws = [modulate(scramble_bits(c, cfg.cinit(cw)), cfg.mod)
               for cw, c in enumerate(coded)]
        if cfg.mimo is MimoType.SINGLE:
            ports = cws[0][..., None, :]                   # [..., 1, M]
        elif cfg.mimo is MimoType.DIVERSITY:
            if cfg.cell.nof_ports == 4:
                ports = precode_sfbc_fstd(layermap(cws, 4))  # [..., 4, M]
            else:
                ports = precode_sfbc(layermap(cws, 2))     # [..., 2, M]
        elif cfg.mimo is MimoType.SPATIAL_MUX:
            ports = precode_mux_2x2(
                layermap(cws, cfg.nof_layers, cfg.nof_codewords), cfg.pmi)
        else:
            ports = precode_cdd_2layer(
                layermap(cws, cfg.nof_layers, cfg.nof_codewords))
        n_ports = ports.shape[-2]
        cell = cfg.cell
        idx = cfg.re_index_tensor(ports.device)[:ports.shape[-1]]
        if grid is not None:
            flat = grid.view(*grid.shape[:-2], -1)
            flat[..., :n_ports, idx] = ports
            return grid
        lead = ports.shape[:-2]
        out = ports.new_zeros((*lead, n_ports, cell.nsymb_sf * cell.nof_re))
        out[..., idx] = ports
        return out.reshape(*lead, n_ports, cell.nsymb_sf, cell.nof_re)


# --- decode (UE side) -------------------------------------------------------


def pdsch_extract(grid, cfg: PdschConfig):
    """Extract PDSCH REs: [..., nsymb, nre] -> [..., M] in 36.211 6.3.5
    mapping order (pdsch_get / pdsch_cp, pdsch.c:95-214)."""
    flat = grid.reshape(*grid.shape[:-2], -1)
    return flat[..., cfg.re_index_tensor(grid.device)]


def _pdsch_llrs(grid, h, cfg: PdschConfig, noise_est) -> tuple:
    """The equalised, CSI-weighted and descrambled LLRs of each codeword
    [..., G] (``pdsch_decode``'s stage ``pdsch.eq_demod``)."""
    y = pdsch_extract(grid, cfg)                          # [..., A, M]
    m = cfg.nof_symbols
    if cfg.mimo is MimoType.SINGLE:
        hh = pdsch_extract(h[..., :, 0, :, :], cfg)
        x, csi = eq_single(y, hh, noise_est)
        cw_syms = [x[..., :m]]
        csis = [csi[..., :m]]
    elif cfg.mimo is MimoType.DIVERSITY:
        n_p = 4 if cfg.cell.nof_ports == 4 else 2
        hp = [pdsch_extract(h[..., :, p, :, :], cfg)[..., :m]
              for p in range(n_p)]
        eq = eq_sfbc_fstd if n_p == 4 else eq_sfbc
        x, csi = eq(y[..., :m], *hp)
        cw_syms, csis = [x], [csi]
    else:
        hp = torch.stack([pdsch_extract(h[..., :, p, :, :], cfg)
                          for p in range(2)], dim=-2)      # [..., A, 2, M]
        if y.shape[-2] == 1:
            # one rx antenna: the 2x2 solve reads rx row min(r, A - 1),
            # as the JAX package's clamped static index does
            y = y.expand(*y.shape[:-2], 2, y.shape[-1])
            hp = hp.expand(*hp.shape[:-3], 2, *hp.shape[-2:])
        x, csi = eq_mux_2x2(                              # [..., 2, M]
            y, effective_channel_mux(hp, cfg.pmi)
            if cfg.mimo is MimoType.SPATIAL_MUX
            else effective_channel_cdd(hp), noise_est)
        cw_syms = layerdemap(x, cfg.nof_codewords)
        csis = layerdemap(csi, cfg.nof_codewords)

    cw_llrs = []
    for cw, (syms, csi) in enumerate(zip(cw_syms, csis)):
        # CSI-weighted max-log LLRs (csi_correction, pdsch.c:676-776)
        llr = demod_soft(syms, cfg.mod)
        llr = llr * torch.repeat_interleave(
            csi, cfg.mod.bits_per_symbol, dim=-1)
        if cfg.llr_int8:
            llr = quantize_llr_int8(llr, cfg.mod)
        cw_llrs.append(descramble_llrs(llr, cfg.cinit(cw)))
    return tuple(cw_llrs)


def pdsch_decode(grid, h, cfg: PdschConfig, plan: DlschPlan, noise_est=0.0,
                 softbuffers=None, plan2: DlschPlan | None = None,
                 softbuffers2=None, iters_out: list | None = None,
                 stages=EAGER):
    """Full PDSCH decode (srslte_pdsch_decode, pdsch.c:837-1007).

    grid: [..., A, nsymb, nre] received resource grids per rx antenna
    h:    [..., A, P, nsymb, nre] channel estimates per (rx, tx port)
    Returns (tb_bits, crc_ok, softbuffers) — tuples per codeword when a
    second plan is given. Diversity needs the RE pairs (quads with 4 ports)
    of ``cfg.nof_symbols``; CDD's D(i) cycles by extraction index. The
    equaliser and demapper run as the stage ``pdsch.eq_demod`` of
    ``stages`` (``runtime.graphs``), and so do the DL-SCH decode's CRCs
    and reassembly (``dlsch_decode``).
    """
    cw_llrs = stages("pdsch.eq_demod", _pdsch_llrs, grid, h, cfg, noise_est)

    plans = [plan] + ([plan2] if plan2 is not None else [])

    # two codewords with the same plan and no HARQ state decode as ONE
    # dlsch call with a leading codeword axis (twice the turbo batch)
    if (len(plans) == 2 and plans[0] == plans[1]
            and softbuffers is None and softbuffers2 is None):
        bits, ok, soft = dlsch_decode(torch.stack(cw_llrs, dim=0), plan,
                                      iters_out=iters_out, stages=stages)
        outs = [(bits[0], ok[0], [s[0] for s in soft]),
                (bits[1], ok[1], [s[1] for s in soft])]
    else:
        all_soft = [softbuffers, softbuffers2]
        outs = [dlsch_decode(llr, pl, softbuffers=all_soft[cw],
                             iters_out=iters_out, stages=stages)
                for cw, (llr, pl) in enumerate(zip(cw_llrs, plans))]
    if plan2 is None:
        return outs[0]
    return tuple(zip(*outs))
