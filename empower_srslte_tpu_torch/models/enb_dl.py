"""eNB downlink subframe composition, and the 2x2 TM4 test transmitter.

Capability parity with lib/src/phy/enb/enb_dl.c: an empty grid with the
CRS placed (put_base, enb_dl.c:323-388), the control and shared channels
added by their own modules, then iFFT to time-domain samples (gen_signal,
enb_dl.c:389). Batched: every function takes/returns leading batch dims.

``tm4_stimulus`` builds the main path's receive samples: a batch of
20 MHz 2x2 TM4 two-codeword subframes with PCFICH, one DCI and PDSCH,
through a per-subframe 2x2 channel and AWGN — the same construction and
the same numpy random draws as the JAX package's full-chain UE receiver
benchmark (bench.py ``bench_uedl(mimo=True)``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.ofdm import ofdm_tx_sf
from ..utils.cell import Cell
from ..utils.device import device_table, resolve_device
from .refsignal import crs_pilots


@functools.lru_cache(maxsize=256)
def _crs_scatter(cell: Cell, sf_idx: int):
    """Per-port flat indices + values for CRS insertion."""
    out = []
    ports = {1: (0,), 2: (0, 1), 4: (0, 1, 2, 3)}[cell.nof_ports]
    for p in ports:
        idx, syms, vals = crs_pilots(cell, sf_idx, p)
        flat = (syms[:, None] * cell.nof_re + idx).reshape(-1)
        out.append((flat.astype(np.int64), vals.reshape(-1)))
    return out


def put_crs(grid, cell: Cell, sf_idx: int):
    """Insert CRS for all ports: grid [..., P, nsymb, nre] -> new grid."""
    out = grid.clone()
    flat = out.view(*grid.shape[:-2], -1)
    for p, (idx, vals) in enumerate(_crs_scatter(cell, sf_idx)):
        if p >= grid.shape[-3]:
            break
        key = ("crs", cell, sf_idx, p)
        flat[..., p, device_table(key + ("i",), grid.device,
                                  lambda: idx)] = \
            device_table(key + ("v",), grid.device, lambda: vals)
    return out


def enb_dl_base_grid(cell: Cell, sf_idx: int, batch_shape=(), device=None):
    """Empty per-port grid with CRS placed (put_base analog)."""
    grid = torch.zeros((*batch_shape, cell.nof_ports, cell.nsymb_sf,
                        cell.nof_re), dtype=torch.complex64,
                       device=resolve_device(device))
    return put_crs(grid, cell, sf_idx)


def enb_dl_gen_signal(grid, cell: Cell):
    """Per-port grids -> time samples [..., P, sf_sample_len]
    (srslte_enb_dl_gen_signal, enb_dl.c:389)."""
    return ofdm_tx_sf(grid, cell)


#: the main path's stimulus: 20 MHz, MCS 25 (64QAM, TBS 57336), cfi 1,
#: AWGN at 30 dB of the mean signal power, numpy draws from seed 7
TM4_NOF_PRB, TM4_MCS, TM4_CFI, TM4_SNR_DB, TM4_SEED = 100, 25, 1, 30.0, 7


def enb_dl_tm4(tb, tb2, h2, noise, cfg, plan, dci_bits, dci_cce: int,
               dci_l: int):
    """2x2 TM4 subframes through a per-subframe channel plus AWGN.

    tb, tb2 [B, tbs] 0/1; h2 [B, rx, port] complex64 flat channel;
    noise [B, rx, sf_len] complex64 unit-variance-per-component draws;
    dci_bits [size] 0/1. Returns samples [B, rx, sf_len] complex64:
    base grid + PCFICH + PDCCH + PDSCH, mixed by h2 in the frequency
    domain, iFFT per antenna, AWGN at ``TM4_SNR_DB`` of the mean
    power.
    """
    from .pcfich import pcfich_put
    from .pdcch import pdcch_encode
    from .pdsch import pdsch_encode

    cell, sf_idx, cfi = cfg.cell, cfg.sf_idx, cfg.cfi
    grid = enb_dl_base_grid(cell, sf_idx, batch_shape=(tb.shape[0],),
                            device=tb.device)
    grid = pcfich_put(grid, cfi, cell, sf_idx)
    grid = grid + pdcch_encode(dci_bits, cfg.rnti, dci_cce, dci_l, cell,
                               cfi, sf_idx)
    grid = grid + pdsch_encode(tb, cfg, plan, tb2, plan)
    grid = torch.einsum("brp,bpsk->brsk", h2, grid)
    samples = enb_dl_gen_signal(grid, cell)
    p_sig = torch.mean(samples.abs() ** 2)
    sigma = torch.sqrt(p_sig * 10 ** (-TM4_SNR_DB / 10) / 2)
    return samples + sigma * noise


def tm4_draws(batch: int, tbs: int, dci_size: int, sf_len: int) -> dict:
    """The stimulus' random draws (numpy), in the JAX benchmark's order:
    DCI bits, both TBs, channel phases (a well-conditioned diagonal-
    dominant 2x2: unit diagonal, 0.35 off-diagonal, random phases), then
    the real and imaginary noise [batch, 2, sf_len]."""
    rng = np.random.default_rng(TM4_SEED)
    dci_bits = rng.integers(0, 2, dci_size).astype(np.int8)
    tb = rng.integers(0, 2, size=(batch, tbs)).astype(np.int8)
    tb2 = rng.integers(0, 2, size=(batch, tbs)).astype(np.int8)
    ph = rng.uniform(0, 2 * np.pi, size=(batch, 2, 2))
    mag = np.where(np.eye(2, dtype=bool)[None], 1.0, 0.35)
    h2 = (mag * np.exp(1j * ph)).astype(np.complex64)
    nshape = (batch, 2, sf_len)
    nz_re = rng.normal(size=nshape).astype(np.float32)
    nz_im = rng.normal(size=nshape).astype(np.float32)
    return dict(dci_bits=dci_bits, tb=tb, tb2=tb2, h2=h2, nz_re=nz_re,
                nz_im=nz_im)


@dataclass
class Tm4Stimulus:
    """The main path's input and what it must decode to."""

    cfg: object                  # PdschConfig (cell, sf_idx, cfi, RNTI)
    plan: object                 # DlschPlan (both codewords)
    samples: torch.Tensor        # [B, rx, sf_len] complex64
    tb: torch.Tensor             # [B, tbs] int8, codeword 0
    tb2: torch.Tensor            # [B, tbs] int8, codeword 1


def tm4_stimulus(batch: int, *, device=None) -> Tm4Stimulus:
    """Build ``batch`` 2x2 TM4 two-codeword subframes (cell id 1, sf_idx 1,
    RNTI 0x1234, one format-1 DCI at L=4, CCE 0) at the ``TM4_*``
    settings, drawing bits, channel and noise in the JAX benchmark's
    order."""
    from . import ra
    from .dci import format1_size
    from .pdsch import PdschConfig
    from ..ops.equalizer import MimoType

    dev = resolve_device(device)
    sf_idx, rnti = 1, 0x1234
    cell = Cell(nof_prb=TM4_NOF_PRB, nof_ports=2, id=1)
    mod, tbs = ra.mcs_to_tbs(TM4_MCS, TM4_NOF_PRB)
    cfg = PdschConfig(cell=cell, sf_idx=sf_idx, cfi=TM4_CFI, rnti=rnti,
                      mod=mod, mimo=MimoType.SPATIAL_MUX, nof_layers=2,
                      nof_codewords=2)
    plan = cfg.plan(tbs)
    d = tm4_draws(batch, tbs, format1_size(TM4_NOF_PRB), cell.sf_sample_len)
    noise = torch.complex(torch.as_tensor(d["nz_re"], device=dev),
                          torch.as_tensor(d["nz_im"], device=dev))
    del d["nz_re"], d["nz_im"]
    tb_t = torch.as_tensor(d["tb"], device=dev)
    tb2_t = torch.as_tensor(d["tb2"], device=dev)
    samples = enb_dl_tm4(tb_t, tb2_t, torch.as_tensor(d["h2"], device=dev),
                         noise, cfg, plan,
                         torch.as_tensor(d["dci_bits"], device=dev), 0, 4)
    return Tm4Stimulus(cfg, plan, samples, tb_t, tb2_t)
