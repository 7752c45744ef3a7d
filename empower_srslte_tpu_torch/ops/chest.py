"""Downlink channel estimation from CRS pilots.

Capability parity with lib/src/phy/ch_estimation/chest_dl.c: LS estimates
at pilot REs (chest_dl.c:641-663), 3-tap or Gaussian frequency-domain
smoothing, linear frequency interpolation and linear time interpolation
with edge extrapolation (interpolate_pilots, chest_dl.c:365-446), and the
measurements: pilot, PSS and empty-subcarrier noise, RSRP, RSSI, RSRQ and
the pilot CFO (chest_dl.c:268-361, 583-603, 741-840). Pilot extraction
and interpolation follow static per-(cell, sf_idx, port) plans;
everything is batched over subframes and rx antennas.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..models.refsignal import crs_pilots
from ..utils.cell import Cell
from ..utils.device import device_table

#: 3-tap frequency smoothing filter (chest_dl.c default smooth filter).
SMOOTH_3TAP = np.array([0.3333, 0.3334, 0.3333], np.float32)


@functools.lru_cache(maxsize=512)
def _interp_plan(cell: Cell, sf_idx: int, port: int):
    """Static plan: pilot rows, comb offsets and time-interpolation weights.

    re_idx [P, M] pilot subcarrier per pilot-symbol row, syms [P] subframe
    symbol per row, conj_vals [P, M] conjugate pilots (LS by multiply),
    comb_offsets [P] first pilot subcarrier of each 6-spaced comb row,
    tw [nsymb, P] linear time-interpolation weights row -> symbol.
    """
    re_idx, syms, vals = crs_pilots(cell, sf_idx, port)
    p, _m = re_idx.shape
    nsymb = cell.nsymb_sf
    assert all(np.all(np.diff(re_idx[r]) == 6) for r in range(p))
    tsy = syms.astype(np.float64)
    order = np.argsort(tsy)
    tsy_sorted = tsy[order]
    tw = np.zeros((nsymb, p), np.float32)
    for s in range(nsymb):
        j = np.searchsorted(tsy_sorted, s) - 1
        j = min(max(j, 0), p - 2)
        t0, t1 = tsy_sorted[j], tsy_sorted[j + 1]
        w = (s - t0) / (t1 - t0)
        tw[s, order[j]] = 1.0 - w
        tw[s, order[j + 1]] = w
    return dict(re_idx=re_idx, syms=syms, conj_vals=np.conj(vals),
                comb_offsets=tuple(int(re_idx[r][0]) for r in range(p)),
                tw=tw)


def _ls_pilots(grid, plan, key):
    """LS pilot estimates h_p [..., P, M] = y(pilot) * conj(r): one
    strided slice per pilot-symbol row (CRS pilots sit on a 6-comb)."""
    cvals = device_table(("chest_cv",) + key, grid.device,
                         lambda: plan["conj_vals"])
    rows = [grid[..., int(sy), off::6]
            for sy, off in zip(plan["syms"], plan["comb_offsets"])]
    return torch.stack(rows, dim=-2) * cvals


def _freq_interp_row(h_p_row, off: int, nre: int):
    """Linear pilot->subcarrier interpolation for one comb row (pilots at
    off + 6m): interior phases d/6, linear extrapolation at the edges."""
    m = h_p_row.shape[-1]
    dev = h_p_row.device
    d = torch.arange(6, dtype=torch.float32, device=dev) / 6.0
    hl = h_p_row[..., :-1, None]
    hr = h_p_row[..., 1:, None]
    interior = (hl * (1.0 - d) + hr * d).reshape(*h_p_row.shape[:-1],
                                                 6 * (m - 1))
    parts = []
    if off:
        wl = (torch.arange(off, dtype=torch.float32, device=dev) - off) / 6.0
        parts.append(h_p_row[..., 0:1] * (1.0 - wl)
                     + h_p_row[..., 1:2] * wl)
    parts.append(interior)
    n_r = nre - off - 6 * (m - 1)
    if n_r:
        wr = (torch.arange(n_r, dtype=torch.float32, device=dev)
              + 6 * (m - 1)) / 6.0 - (m - 2)
        parts.append(h_p_row[..., m - 2:m - 1] * (1.0 - wr)
                     + h_p_row[..., m - 1:m] * wr)
    return torch.cat(parts, dim=-1)


def _smooth_taps(h_p, taps: np.ndarray):
    """Edge-replicated FIR along the pilot axis with static taps."""
    n = len(taps)
    half = (n - 1) // 2
    padded = torch.cat([h_p[..., :1].expand(*h_p.shape[:-1], half), h_p,
                        h_p[..., -1:].expand(*h_p.shape[:-1], n - 1 - half)],
                       dim=-1)
    acc = None
    for i, w in enumerate(taps):
        term = float(w) * padded[..., i:i + h_p.shape[-1]]
        acc = term if acc is None else acc + term
    return acc


def time_interp_apply(tw, h_f):
    """Apply a static [nsymb, P] time-interpolation weight matrix to
    per-pilot-symbol estimates h_f[..., P, k] as per-symbol scaled sums
    (<= 2 nonzeros per row, interpolate_pilots chest_dl.c:365-446)."""
    outs = []
    for srow in np.asarray(tw):
        acc = None
        for pcol in np.nonzero(srow)[0]:
            term = float(srow[pcol]) * h_f[..., pcol, :]
            acc = term if acc is None else acc + term
        outs.append(acc if acc is not None
                    else torch.zeros_like(h_f[..., 0, :]))
    return torch.stack(outs, dim=-2)


def gauss_taps(std_dev: float, order: int = 4) -> np.ndarray:
    """Gaussian frequency-smoothing taps, sum-normalized
    (chest_dl.c:475-494 set_smooth_filter_gauss)."""
    std_dev = max(float(std_dev), 1e-4)
    n = order + 1
    center = (n - 1) // 2
    taps = np.exp(-((np.arange(n) - center) ** 2) / (2.0 * std_dev ** 2))
    return (taps / taps.sum()).astype(np.float32)


def auto_gauss_std(noise_est: float) -> float:
    """SNR-adaptive Gaussian bandwidth, std = N0 * 200 (chest_dl.c:616-618:
    narrower smoothing at high SNR; fed from the previous subframe's
    noise estimate)."""
    return float(noise_est) * 200.0


def chest_dl(grid, cell: Cell, sf_idx: int, port: int = 0,
             smooth: bool = True, gauss_std: float | None = None):
    """Estimate h for one TX port: grid [..., nsymb, nre] -> same shape.

    LS at pilots, 3-tap freq smoothing (or the SNR-adaptive Gaussian of
    ``gauss_std``, chest_dl.c:616 smooth_filter_auto, see
    ``auto_gauss_std``), then freq + time linear interpolation. Batched
    over all leading dims.
    """
    plan = _interp_plan(cell, sf_idx, port)
    h_p = _ls_pilots(grid, plan, (cell, sf_idx, port))    # [..., P, M]
    if gauss_std is not None:
        h_p = _smooth_taps(h_p, gauss_taps(gauss_std))
    elif smooth:
        h_p = _smooth_taps(h_p, SMOOTH_3TAP)
    h_f = torch.stack(
        [_freq_interp_row(h_p[..., r, :], off, cell.nof_re)
         for r, off in enumerate(plan["comb_offsets"])], dim=-2)
    return time_interp_apply(plan["tw"], h_f)


def noise_est_pilots(grid, cell: Cell, sf_idx: int, port: int = 0):
    """Noise power from pilot residuals after 3-tap smoothing
    (chest_dl.c:268-329 estimate_noise_pilots): E|h_ls - smooth(h_ls)|^2,
    unbiased by 3/2. Returns [...] per batch element."""
    plan = _interp_plan(cell, sf_idx, port)
    h_p = _ls_pilots(grid, plan, (cell, sf_idx, port))
    padded = torch.cat([h_p[..., :1], h_p, h_p[..., -1:]], dim=-1)
    sm = (float(SMOOTH_3TAP[0]) * padded[..., :-2]
          + float(SMOOTH_3TAP[1]) * padded[..., 1:-1]
          + float(SMOOTH_3TAP[2]) * padded[..., 2:])
    resid = h_p - sm
    return torch.mean(resid.abs() ** 2, dim=(-1, -2)) * 1.5


def noise_est_pss(grid, ce, cell: Cell):
    """Noise power from the PSS residual (chest_dl.c:331-348
    estimate_noise_pss): the known PSS through the channel estimate
    against the received symbols. grid/ce [..., nsymb, nre] of subframe 0
    or 5 -> [...]."""
    from .sync import pss_freq

    sym = cell.nsymb_slot - 1                 # last symbol of slot 0
    k0 = cell.nof_re // 2 - 31
    rx = grid[..., sym, k0:k0 + 62]
    h = ce[..., sym, k0:k0 + 62]
    pss = device_table(("pss", cell.n_id_2), grid.device,
                       lambda: pss_freq(cell.n_id_2))
    power = torch.mean((h * pss - rx).abs() ** 2, dim=-1)
    return cell.nof_ports * power / float(np.sqrt(2.0))


def rsrp(grid, cell: Cell, sf_idx: int, port: int = 0):
    """Reference-signal received power (chest_dl.c:741-): |mean h_ls|^2
    over the port's pilots. -> [...]"""
    plan = _interp_plan(cell, sf_idx, port)
    h_p = _ls_pilots(grid, plan, (cell, sf_idx, port))
    return torch.mean(h_p, dim=(-1, -2)).abs() ** 2


def rssi(grid):
    """Mean received power per RE over the grid (chest_dl.c rssi)."""
    return torch.mean(grid.abs() ** 2, dim=(-1, -2))


def noise_est_empty_sc(grid, cell: Cell):
    """Noise from the 5 unused REs on each side of the 62-RE sync band in
    the PSS symbol (chest_dl.c:351-361's empty-subcarrier estimator; the
    grid skips DC, so these are the empty REs it has). Subframes 0 and 5
    only. -> [...] noise power."""
    nsym = cell.nsymb_slot
    mid = cell.nof_re // 2
    row = grid[..., nsym - 1, :]
    re = torch.cat([row[..., mid - 36:mid - 31], row[..., mid + 31:mid + 36]],
                   dim=-1)
    return torch.mean(re.abs() ** 2, dim=-1)


def rsrq(grid, cell: Cell, sf_idx: int, port: int = 0):
    """RSRQ = N * RSRP / RSSI over the measurement bandwidth
    (chest_dl.c:790-840)."""
    return cell.nof_prb * rsrp(grid, cell, sf_idx, port) / torch.clamp(
        rssi(grid) * cell.nof_re, min=1e-20)


def cfo_est_pilots(grid, cell: Cell, sf_idx: int, port: int = 0):
    """Residual CFO from the phase drift between the two CRS symbols of
    each slot (chest_dl.c:583-603). -> CFO in subcarrier spacings [...]."""
    plan = _interp_plan(cell, sf_idx, port)
    h_p = _ls_pilots(grid, plan, (cell, sf_idx, port))
    # pilot rows (0, 1) and (2, 3): the two CRS symbols of each slot
    corr = (torch.sum(h_p[..., 1, :] * torch.conj(h_p[..., 0, :]), dim=-1)
            + torch.sum(h_p[..., 3, :] * torch.conj(h_p[..., 2, :]), dim=-1))
    syms = plan["syms"]
    dsym = int(syms[1] - syms[0])
    fft = cell.fft_size
    cp = cell.cp_len_slot[1]
    return torch.angle(corr) / (2 * np.pi) * fft / ((fft + cp) * dsym)
