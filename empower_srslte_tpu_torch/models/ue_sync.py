"""UE synchronization: capture alignment, SFO and cell search.

Capability parity with lib/src/phy/ue/ue_sync.c (the FIND -> TRACK state
machine in file mode, ue_sync.c:675-707) and ue_cell_search.c (scan the 3
N_id_2 roots, vote, keep the strongest cell). A recorded or buffered IQ
capture is aligned in one pass: a batched PSS correlation over the first
10 ms, the PSS CFO estimate and correction, SSS detection for the cell
identity and the half-frame, then a reshape into [nof_sf, sf_len]
subframes for the batched receivers.

Devices: a tensor capture stays on its device; a numpy capture goes to
``device`` (the CUDA card unless ``device="cpu"``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.ofdm import ofdm_rx_sf
from ..ops.sync import (cfo_correct, pss_cfo_estimate, pss_find, pss_freq,
                        sss_detect, sync_re_indices)
from ..utils.cell import Cell
from ..utils.device import as_samples, device_table


@dataclass
class SyncResult:
    """Outcome of cell search and alignment on a capture."""

    cell_id: int
    n_id_2: int
    sf0_offset: int          # sample index where subframe 0 starts
    cfo: float               # subcarrier-normalized CFO estimate
    metric: float            # SSS correlation metric
    subframes: torch.Tensor  # [nof_sf, sf_sample_len] aligned, corrected


def pss_start_to_sf_start(peak_start: int, cell: Cell) -> int:
    """The PSS data region ends the last symbol of slot 0: the subframe
    starts one slot length before that end."""
    slot_len = cell.sf_sample_len // 2
    return peak_start + cell.fft_size - slot_len


def sync_and_align(samples, cell_prb: int, max_id2_scan: int = 3,
                   exclude_id2: tuple = (), *, device=None) -> SyncResult:
    """Find the cell in a raw capture and return aligned subframes.

    ``samples``: 1-D complex64 at the standard rate for ``cell_prb``, more
    than one frame plus one subframe long. Searches the PSS over the first
    10 ms for each N_id_2, keeps the strongest root (ue_cell_search.c:249's
    vote as an argmax over the batched correlations), estimates the CFO
    from the PSS symbol, corrects the whole capture, and decodes the SSS
    against the PSS-referenced channel for N_id_1 and the half-frame.
    ``exclude_id2``: roots to skip, cells found earlier but rejected by
    PLMN / S-criterion checks (srsue rrc.cc plmn_search). ``max_id2_scan``
    is accepted for the JAX package's signature; every root is scanned.
    """
    cell_probe = Cell(nof_prb=cell_prb, id=0)
    fft = cell_probe.fft_size
    sf_len = cell_probe.sf_sample_len
    frame = 10 * sf_len
    samples = as_samples(samples, device)
    if samples.shape[-1] < frame + sf_len:
        raise ValueError("need one frame and one subframe of samples")

    window = samples[:frame + fft]
    _mag, peak, psr = pss_find(window[None], fft)           # [1, 3]
    psr_np = psr[0].cpu().numpy().astype(np.float64)
    for i in exclude_id2:
        psr_np[int(i)] = -np.inf
    n_id_2 = int(np.argmax(psr_np))
    peak_start = int(peak[0, n_id_2])
    cfo = float(pss_cfo_estimate(
        window[None], torch.tensor([peak_start], device=samples.device),
        n_id_2, fft)[0])
    corrected = cfo_correct(samples, cfo, fft)

    # tentative subframe start (subframe 0 or 5)
    start = pss_start_to_sf_start(peak_start, cell_probe)
    if start < 0:
        start += sf_len * 5
    grid = ofdm_rx_sf(corrected[None, start:start + sf_len], cell_probe)[0]
    k = device_table(("sync_re_k", cell_prb), samples.device,
                     lambda: sync_re_indices(cell_probe))
    nsym = cell_probe.nsymb_slot
    # equalize the SSS with the PSS-derived channel: both share the 62 REs
    pss_re = grid[nsym - 1, k]
    h = pss_re * torch.conj(device_table(("pss", n_id_2), samples.device,
                                         lambda: pss_freq(n_id_2)))
    sss_re = grid[nsym - 2, k] * torch.conj(h) \
        / torch.clamp(h.abs() ** 2, min=1e-12)
    n_id_1, is_sf5, metric = sss_detect(sss_re[None], n_id_2)
    sf0 = start + (5 * sf_len if bool(is_sf5[0]) else 0)
    sf0 = sf0 % frame

    nof = (samples.shape[-1] - sf0) // sf_len
    sub = corrected[sf0:sf0 + nof * sf_len].reshape(nof, sf_len)
    return SyncResult(cell_id=3 * int(n_id_1[0]) + n_id_2, n_id_2=n_id_2,
                      sf0_offset=sf0, cfo=cfo, metric=float(metric[0]),
                      subframes=sub)


def sfo_estimate(samples, n_id_2: int, cell_prb: int,
                 max_windows: int = 16, *, device=None) -> dict:
    """Sample-frequency-offset estimate from the PSS peak drift.

    Parity with sfo.c (srslte_sfo_estimate: least-squares slope of the
    PSS timing over successive half-frames) and the SFO feedback of
    ue_sync.c's TRACK loop: the capture is cut into 5 ms windows, one
    batched PSS correlation finds every peak, and the slope is a
    closed-form least-squares fit on the host.

    Returns dict(sfo_hz, drift_samples_per_frame, positions, srate_hz);
    +1 Hz means the transmitter clock runs 1 sample/second faster than
    the receiver's.
    """
    cell = Cell(nof_prb=cell_prb, id=0)
    half_frame = 5 * cell.sf_sample_len
    samples = as_samples(samples, device)
    n_win = min(max_windows, samples.shape[-1] // half_frame)
    if n_win < 2:
        raise ValueError("need 2 or more half-frames for a drift estimate")
    wins = samples[:n_win * half_frame].reshape(n_win, half_frame)
    _mag, peaks, _psr = pss_find(wins, cell.fft_size)
    pos = peaks[:, n_id_2].cpu().numpy().astype(np.float64)
    # unwrap window-relative positions: a peak drifting past the window
    # edge wraps by half_frame
    pos = np.unwrap(pos * 2 * np.pi / half_frame) * half_frame / (2 * np.pi)
    # least-squares slope: samples of drift per half-frame (sfo.c:34-55)
    x = np.arange(n_win)
    slope = (np.mean(x * pos) - np.mean(x) * np.mean(pos)) / \
        (np.mean(x * x) - np.mean(x) ** 2)
    return dict(sfo_hz=slope / 5e-3,
                drift_samples_per_frame=2 * slope,
                positions=pos,
                srate_hz=cell.sf_sample_len * 1000.0)


def cell_search_vote(samples, cell_prb: int = 6, max_frames: int = 3, *,
                     device=None):
    """Scan the 3 N_id_2 roots over several frames and vote for the
    strongest cell (srslte_ue_cellsearch_scan, ue_cell_search.c:249).

    Returns (n_id_2, votes dict, mean peak-to-sidelobe per root).
    """
    cell = Cell(nof_prb=cell_prb, id=0)
    frame = 10 * cell.sf_sample_len
    samples = as_samples(samples, device)
    n_frames = min(max_frames, samples.shape[-1] // frame)
    if n_frames < 1:
        raise ValueError("need at least one frame")
    wins = samples[:n_frames * frame].reshape(n_frames, frame)
    _mag, _peaks, psr = pss_find(wins, cell.fft_size)        # [F, 3]
    psr_np = psr.cpu().numpy()
    votes: dict[int, int] = {0: 0, 1: 0, 2: 0}
    for f in range(n_frames):
        votes[int(np.argmax(psr_np[f]))] += 1
    best = max(votes, key=votes.get)
    return best, votes, psr_np.mean(axis=0)
