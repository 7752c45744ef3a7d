"""UE uplink subframe generation and the eNB's uplink front end
(lib/src/phy/ue/ue_ul.c, enb_ul.c parity).

Counterpart of the JAX package's models/ue_ul.py:26-88: composes PUSCH
(with or without UCI) into the UL grid, SC-FDMA modulates it with the
half-subcarrier shift, and on the eNB side undoes the shift and FFTs back
to the grid. ``ue_ul_generate`` raises ``NotImplementedError`` for PUCCH,
SRS, CFO pre-compensation and timing advance, which are not ported yet.

``ul_uci_stimulus`` builds the uplink path's receive samples: a batch of
20 MHz PUSCH subframes with UCI through a flat channel and AWGN;
``ul_stimulus`` the same grant without UCI.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch.profiler import record_function

from ..ops.ofdm import freq_shift_half_subcarrier, ofdm_rx_sf, ofdm_tx_sf
from ..utils.cell import Cell
from ..utils.device import resolve_device
from .pusch import UciPlan, pusch_encode, pusch_encode_uci


def ue_ul_generate(cell: Cell, *, pusch: tuple | None = None,
                   pucch: tuple | None = None, srs: dict | None = None,
                   cfo: float = 0.0, timing_advance: int = 0,
                   device=None) -> torch.Tensor:
    """Build one UL subframe per leading index.

    pusch: (tb_bits[..., tbs], PuschConfig, DlschPlan | UciPlan) or None;
    with a UciPlan the subframe carries multiplexed CQI/RI/ACK. Without
    PUSCH the subframe is empty, on ``device`` (None = the CUDA card).
    Returns time samples [..., sf_sample_len] complex64.
    """
    if pucch is not None or srs is not None or cfo or timing_advance:
        raise NotImplementedError(
            "PUCCH, SRS, CFO and timing advance are not ported yet")
    if pusch is not None:
        tb, cfg, plan = pusch
        grid = (pusch_encode_uci(tb, cfg, plan) if isinstance(plan, UciPlan)
                else pusch_encode(tb, cfg, plan))
    else:
        grid = torch.zeros((cell.nsymb_sf, cell.nof_re),
                           dtype=torch.complex64,
                           device=resolve_device(device))
    return freq_shift_half_subcarrier(ofdm_tx_sf(grid, cell), cell,
                                      direction=1)


def enb_ul_receive_grid(samples: torch.Tensor, cell: Cell) -> torch.Tensor:
    """eNB side: undo the half-subcarrier shift and FFT to the UL grid
    [..., nsymb, nre] (srslte_enb_ul_fft analog; profiler range
    ``enb_ul.fft``)."""
    with record_function("enb_ul.fft"):
        shifted = freq_shift_half_subcarrier(samples, cell, direction=-1)
        return ofdm_rx_sf(shifted, cell)


#: the uplink path's grant: the JAX benchmark's 20 MHz uplink
#: (bench.py rx_20ul: 96 PRB from PRB 0, MCS 20, 16QAM, TBS 40576, cell id
#: 1, sf 1, RNTI 0x1234, flat channel 0.95+0.1j) carrying the stack's UCI
#: (two HARQ-ACK bits, a 1-bit RI and the higher-layer subband CQI report)
UL_NOF_PRB, UL_N_PRB, UL_MCS, UL_SEED = 100, 96, 20, 7
UL_H = complex(0.95, 0.1)


@dataclass
class UlStimulus:
    """The uplink path's input and what it must decode to."""

    cfg: object                  # PuschConfig
    plan: object                 # UciPlan (ul_uci_stimulus) or DlschPlan
    samples: torch.Tensor        # [B, sf_len] complex64 at the eNB antenna
    tb: torch.Tensor             # [B, tbs] int8


def _ul_grant():
    """The ``UL_*`` grant: -> (PuschConfig, TBS)."""
    from . import ra
    from .pusch import PuschConfig

    cell = Cell(nof_prb=UL_NOF_PRB, nof_ports=1, id=1)
    mod, tbs = ra.mcs_to_tbs(UL_MCS, UL_N_PRB, dl=False)
    return PuschConfig(cell=cell, sf_idx=1, rnti=0x1234, mod=mod,
                       prb_start=0, n_prb=UL_N_PRB), tbs


def _ul_batch(cfg, plan, batch: int, n0: float, rng, dev) -> UlStimulus:
    """``batch`` subframes of ``plan`` on the grant ``cfg`` through the flat
    channel ``UL_H`` plus AWGN of ``n0`` per resource element of the
    received grid; TB bits, then the noise, drawn from ``rng``.

    The noise is added to the time samples: ``ofdm_rx_sf`` is an
    unnormalized FFT, so white noise of variance s2 per sample has
    variance fft_size * s2 per grid RE; s2 = n0 / fft_size."""
    cell = cfg.cell
    tb = torch.as_tensor(rng.integers(0, 2, size=(batch, plan.tbs))
                         .astype(np.int8), device=dev)
    x = ue_ul_generate(cell, pusch=(tb, cfg, plan)) * UL_H
    sigma = float(np.sqrt(n0 / cell.fft_size / 2))
    nshape = (batch, cell.sf_sample_len)
    noise = torch.complex(
        torch.as_tensor(rng.normal(size=nshape).astype(np.float32),
                        device=dev),
        torch.as_tensor(rng.normal(size=nshape).astype(np.float32),
                        device=dev))
    return UlStimulus(cfg, plan, x + sigma * noise, tb)


def ul_uci_stimulus(batch: int, n0: float, *, device=None) -> UlStimulus:
    """``batch`` PUSCH+UCI subframes at the ``UL_*`` settings through the
    flat channel ``UL_H`` plus AWGN of ``n0`` per resource element of the
    received grid, for ``pusch_decode_uci``. The subband CQIs, TB bits and
    the noise are numpy draws from ``UL_SEED``."""
    from .pusch import UciData
    from .uci import cqi_nof_subbands, cqi_pack_hl_subband

    dev = resolve_device(device)
    cfg, tbs = _ul_grant()
    rng = np.random.default_rng(UL_SEED)
    wb = int(rng.integers(1, 16))
    sbs = rng.integers(0, 16, cqi_nof_subbands(UL_NOF_PRB))
    uci_data = UciData(ack=(1, 0), ri=1, cqi_bits=tuple(
        int(b) for b in cqi_pack_hl_subband(wb, sbs, UL_NOF_PRB)))
    plan = UciPlan(cfg, tbs, uci_data, decoder_impl="windowed")
    return _ul_batch(cfg, plan, batch, n0, rng, dev)


def ul_stimulus(batch: int, n0: float, *, device=None) -> UlStimulus:
    """``batch`` PUSCH subframes without UCI on the ``UL_*`` grant, as
    ``ul_uci_stimulus`` builds them, for ``pusch_decode`` (the plan is the
    UL-SCH's ``DlschPlan``, windowed decoder). TB bits and the noise are
    numpy draws from ``UL_SEED``."""
    cfg, tbs = _ul_grant()
    plan = cfg.plan(tbs, decoder_impl="windowed")
    return _ul_batch(cfg, plan, batch, n0, np.random.default_rng(UL_SEED),
                     resolve_device(device))
