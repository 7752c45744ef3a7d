"""UE measurement reporting: CQI / PMI / RI from channel estimates.

Capability parity with the reference's reporting path (srslte_ue_dl RI/PMI
selection, ue_dl.c:684-763, and srslte_cqi_from_snr in cqi.c): maps the
post-equalization SINR to the CQI index whose spectral efficiency fits,
selects rank and precoder from the estimated channel, and measures the
per-subband SNRs and the RSRP of one subframe. Every function runs on the
device of the tensors it is given.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.chest import chest_dl, chest_dl_ports
from ..ops.equalizer import (condition_number_db, pmi_select_1layer,
                             pmi_select_2layer)
from ..ops.ofdm import ofdm_rx_sf
from ..utils.cell import Cell
from ..utils.device import device_table
from .uci import cqi_hl_subband_size, cqi_nof_subbands

#: SNR (dB) thresholds for CQI 1..15 (the 36.213 Table 7.2.3-1 spectral
#: efficiencies mapped through the AWGN capacity gap, matching the
#: reference's srslte_cqi_from_snr staircase).
CQI_SNR_DB = (-6.7, -4.7, -2.3, 0.2, 2.4, 4.3, 5.9, 8.1, 10.3, 11.7,
              14.1, 16.3, 18.7, 21.0, 22.7)


def cqi_from_snr(snr_db) -> torch.Tensor:
    """SNR (dB) [...] -> CQI index [...] int32 (0 = out of range)."""
    snr_db = torch.as_tensor(snr_db, dtype=torch.float32)
    th = device_table("cqi_snr_db", snr_db.device,
                      lambda: np.asarray(CQI_SNR_DB, np.float32))
    return torch.sum(snr_db[..., None] >= th, dim=-1).to(torch.int32)


def snr_from_chest(h, noise_est) -> torch.Tensor:
    """Average post-MRC SNR (dB) from a channel estimate [..., nsymb, nre]."""
    p = torch.mean(h.abs() ** 2, dim=(-1, -2))
    return 10.0 * torch.log10(torch.clamp(p / noise_est, min=1e-10))


def select_rank_2x2(h, noise_est=1e-3, cn_threshold_db: float = 17.0):
    """RI selection for a 2x2 channel (ue_dl.c select_ri analog): rank 2
    when the channel is well-conditioned, else rank 1.
    h [..., rx, port, n] -> ri [...] int32 in {1, 2}."""
    cn = condition_number_db(h)
    return torch.where(cn < cn_threshold_db, 2, 1).to(torch.int32)


def ue_measurement_report(h, noise_est=1e-3) -> dict:
    """Full (RI, PMI, CQI) report from a 2-port channel estimate
    h [..., rx, port, n]."""
    ri = select_rank_2x2(h, noise_est)
    pmi2, _ = pmi_select_2layer(h, noise_est)
    pmi1, sinr1 = pmi_select_1layer(h, noise_est)
    # wideband SNR proxy: best single-layer beamforming gain
    snr_db = 10.0 * torch.log10(torch.clamp(torch.amax(sinr1, dim=-1),
                                            min=1e-10))
    return dict(ri=ri, pmi=torch.where(ri == 2, pmi2, pmi1),
                cqi=cqi_from_snr(snr_db), snr_db=snr_db)


def subband_snrs(samples, cell: Cell, sf_idx: int,
                 noise_floor: float = 1e-3) -> np.ndarray:
    """Per-subband post-chest SNR (dB) from one subframe of IQ
    samples [sf_len]: LS CRS estimate of port 0 -> per-RE |h|^2 grouped
    into 36.213 Table 7.2.1-3 subbands of k PRBs (12k subcarriers), the
    tail subband rescaled for its zero padding (cqi.c:45 hl-subband
    report). Returns np.float32 [cqi_nof_subbands(cell.nof_prb)]."""
    n_sub = cqi_nof_subbands(cell.nof_prb)
    k_sc = 12 * cqi_hl_subband_size(cell.nof_prb)
    grid = ofdm_rx_sf(samples[None], cell)                  # [1, S, K]
    h, noise = chest_dl_ports(grid, cell, sf_idx, (0,))
    h = h[0, 0]
    noise = torch.clamp(noise[0, 0], min=noise_floor)
    p = h.abs() ** 2                                        # [nsymb, nre]
    p = torch.nn.functional.pad(p, (0, (-p.shape[-1]) % k_sc))
    sb = torch.mean(p.reshape(p.shape[0], -1, k_sc), dim=(0, 2))
    scale = torch.tensor([k_sc / min(k_sc, cell.nof_re - i * k_sc)
                          for i in range(sb.shape[0])], dtype=torch.float32,
                         device=sb.device)
    out = 10.0 * torch.log10(torch.clamp(sb * scale / noise, min=1e-10))
    return out.cpu().numpy().astype(np.float32)[:n_sub]


def cell_rsrp(samples, cell: Cell, sf_idx: int) -> float:
    """RSRP (dB) of a (serving or neighbour) cell from one subframe of IQ
    samples [sf_len]: LS channel estimate at that cell's CRS positions,
    mean |h|^2 (chest_dl.c get_rsrp; srsue intra-frequency measurement)."""
    grid = ofdm_rx_sf(samples[None], cell)
    p = float(torch.mean(chest_dl(grid, cell, sf_idx, port=0).abs() ** 2))
    return 10.0 * float(np.log10(max(p, 1e-12)))
