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

from ..ops.equalizer import (MimoType, layermap, precode_cdd_2layer, precode_mux_2x2, precode_sfbc, precode_sfbc_fstd)
from ..ops.modem import Mod, modulate
from ..ops.scrambling import scramble_bits
from ..utils.cell import Cell
from ..utils.device import device_table
from ..utils.sequence import cinit_pdsch
from .refsignal import crs_mask
from .regs import nof_ctrl_symbols
from .sch import DlschPlan, dlsch_encode

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

    def plan(self, tbs: int, rv: int = 0, max_iterations: int = 5,
             decoder_impl: str = "nii") -> DlschPlan:
        return DlschPlan(tbs=tbs, g=self.g, qm=self.mod.bits_per_symbol,
                         rv=rv, max_iterations=max_iterations,
                         decoder_impl=decoder_impl)

    def cinit(self, codeword: int = 0) -> int:
        return cinit_pdsch(self.rnti, codeword, 2 * self.sf_idx, self.cell.id)


# --- encode (eNB side) ------------------------------------------------------


def pdsch_encode(tb_bits, cfg: PdschConfig, plan: DlschPlan, tb_bits2=None,
                 plan2: DlschPlan | None = None):
    """tb_bits[..., tbs] -> per-port grid [..., ports, nsymb, nre] complex64.

    DL-SCH encode -> scramble -> modulate -> layer map -> precode -> RE
    placement (srslte_pdsch_encode, pdsch.c:1048).
    """
    cws = []
    pairs = [(tb_bits, plan)] + ([(tb_bits2, plan2)]
                                 if tb_bits2 is not None else [])
    for cw, (bits, pl) in enumerate(pairs):
        coded = dlsch_encode(bits, pl)
        cws.append(modulate(scramble_bits(coded, cfg.cinit(cw)), cfg.mod))
    if cfg.mimo is MimoType.SINGLE:
        ports = cws[0][..., None, :]                       # [..., 1, M]
    elif cfg.mimo is MimoType.DIVERSITY:
        if cfg.cell.nof_ports == 4:
            ports = precode_sfbc_fstd(layermap(cws, 4))    # [..., 4, M]
        else:
            ports = precode_sfbc(layermap(cws, 2))         # [..., 2, M]
    elif cfg.mimo is MimoType.SPATIAL_MUX:
        ports = precode_mux_2x2(
            layermap(cws, cfg.nof_layers, cfg.nof_codewords), cfg.pmi)
    else:
        ports = precode_cdd_2layer(
            layermap(cws, cfg.nof_layers, cfg.nof_codewords))
    n_ports = ports.shape[-2]
    lead = ports.shape[:-2]
    cell = cfg.cell
    idx = cfg.re_index_tensor(ports.device)[:ports.shape[-1]]
    grid = ports.new_zeros((*lead, n_ports, cell.nsymb_sf * cell.nof_re))
    grid[..., idx] = ports
    return grid.reshape(*lead, n_ports, cell.nsymb_sf, cell.nof_re)


# --- decode (UE side) -------------------------------------------------------


