"""Downlink channel estimation from CRS pilots.

Capability parity with lib/src/phy/ch_estimation/chest_dl.c: LS estimates
at pilot REs (chest_dl.c:641-663), 3-tap or Gaussian frequency-domain
smoothing, linear frequency interpolation and linear time interpolation
with edge extrapolation (interpolate_pilots, chest_dl.c:365-446), and the
measurements: pilot, PSS and empty-subcarrier noise, RSRP, RSSI, RSRQ and
the pilot CFO (chest_dl.c:268-361, 583-603, 741-840). Pilot extraction
and interpolation follow static per-(cell, sf_idx, port) plans;
everything is batched over subframes and rx antennas.

On the card the channel and pilot noise estimates of every requested
port are one launch of ``csrc/chest_dl.cu`` (``chest_dl_ports``, which
``chest_dl`` and ``noise_est_pilots`` go through); on the CPU they are
the plain twins ``_chest_dl_plain`` and ``_noise_est_plain``, which the
kernel repeats operation for operation.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..models.refsignal import crs_pilots
from ..utils.cell import Cell
from ..utils.cuda_build import Kernel
from ..utils.device import device_table

#: 3-tap frequency smoothing filter (chest_dl.c default smooth filter).
SMOOTH_3TAP = np.array([0.3333, 0.3334, 0.3333], np.float32)
#: the launcher: grid, cv, meta, tw, taps, n_taps, h, noise; grids, ports,
#: nsymb, nre, pilots a row, symbol split. A launch's shape in the launch
#: registry is (grids, ports, PRB)
CHEST_DL = Kernel("chest_dl", "chest_dl_launch",
                  [ctypes.c_void_p] * 5 + [ctypes.c_int]
                  + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6)
#: the kernel's limits: FIR taps, pilot rows per port (csrc/chest_dl.cu)
MAX_TAPS, MAX_ROWS = 5, 4
#: blocks a launch aims for: a block per (grid, port), split over
#: symbols while there are fewer (about two per SM of an H100)
TARGET_BLOCKS = 264


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


def _chest_dl_plain(grid, cell: Cell, sf_idx: int, port: int,
                    smooth: bool, gauss_std: float | None):
    """``chest_dl`` in plain PyTorch (the kernel's twin)."""
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


def _noise_est_plain(grid, cell: Cell, sf_idx: int, port: int):
    """``noise_est_pilots`` in plain PyTorch (the kernel's twin)."""
    plan = _interp_plan(cell, sf_idx, port)
    h_p = _ls_pilots(grid, plan, (cell, sf_idx, port))
    padded = torch.cat([h_p[..., :1], h_p, h_p[..., -1:]], dim=-1)
    sm = (float(SMOOTH_3TAP[0]) * padded[..., :-2]
          + float(SMOOTH_3TAP[1]) * padded[..., 1:-1]
          + float(SMOOTH_3TAP[2]) * padded[..., 2:])
    resid = h_p - sm
    return torch.mean(resid.abs() ** 2, dim=(-1, -2)) * 1.5


def fir_taps(smooth: bool = True,
             gauss_std: float | None = None) -> np.ndarray:
    """The estimate's FIR along the pilot axis: the SNR-adaptive Gaussian
    of ``gauss_std``, else the 3-tap default, or [1] without smoothing."""
    if gauss_std is not None:
        return gauss_taps(gauss_std)
    return SMOOTH_3TAP if smooth else np.ones(1, np.float32)


@functools.lru_cache(maxsize=512)
def kernel_tables(cell: Cell, sf_idx: int, ports: tuple):
    """The tables ``csrc/chest_dl.cu`` reads for ``ports``, from each
    port's ``_interp_plan``: conj_vals [P, MAX_ROWS, M] complex64 (a
    port's rows past its own are 0); meta [P, 1 + 2 MAX_ROWS + 2 S]
    int32: its pilot rows, each row's symbol and comb offset (-1 past its
    rows), then per symbol the first and the second pilot row of its time
    weights (-1: none); tw [P, S, 2] float32, those two weights. The
    weights are ``tw``'s nonzeros in column order, as
    ``time_interp_apply`` sums them."""
    m, nsymb = 2 * cell.nof_prb, cell.nsymb_sf
    cv = np.zeros((len(ports), MAX_ROWS, m), np.complex64)
    meta = np.full((len(ports), 1 + 2 * MAX_ROWS + 2 * nsymb), -1, np.int32)
    tw = np.zeros((len(ports), nsymb, 2), np.float32)
    for i, port in enumerate(ports):
        plan = _interp_plan(cell, sf_idx, port)
        rows = len(plan["syms"])
        cv[i, :rows] = plan["conj_vals"]
        meta[i, 0] = rows
        meta[i, 1:1 + rows] = plan["syms"]
        meta[i, 1 + MAX_ROWS:1 + MAX_ROWS + rows] = plan["comb_offsets"]
        for s, srow in enumerate(plan["tw"]):
            cols = np.nonzero(srow)[0]
            assert len(cols) <= 2, "time weights span more than two rows"
            for j, col in enumerate(cols):
                meta[i, 1 + 2 * MAX_ROWS + j * nsymb + s] = col
                tw[i, s, j] = srow[col]
    return cv, meta, tw


def chest_dl_cuda(grid, cell: Cell, sf_idx: int, ports: tuple, taps,
                  with_h: bool = True):
    """One launch of ``csrc/chest_dl.cu``: grid [..., S, K] contiguous
    complex64 on the card -> (h [..., P, S, K] complex64, or None without
    ``with_h``; noise [..., P] float32), P = len(ports), with the FIR
    ``taps`` (1 to MAX_TAPS)."""
    if grid.dtype != torch.complex64 or not grid.is_contiguous():
        raise ValueError("grid must be contiguous complex64")
    if not grid.is_cuda:
        raise ValueError("chest_dl_cuda takes a CUDA tensor")
    nsymb, nre = cell.nsymb_sf, cell.nof_re
    if grid.dim() < 2 or tuple(grid.shape[-2:]) != (nsymb, nre):
        raise ValueError(f"grid shape {tuple(grid.shape)}, want "
                         f"[..., {nsymb}, {nre}]")
    taps = np.asarray(taps, np.float32)
    if not 1 <= len(taps) <= MAX_TAPS:
        raise ValueError(f"{len(taps)} FIR taps, the kernel takes 1 to "
                         f"{MAX_TAPS}")
    ports = tuple(int(p) for p in ports)
    lead, npt = grid.shape[:-2], len(ports)
    n = grid.numel() // (nsymb * nre)
    dev = grid.device
    h = (torch.empty((*lead, npt, nsymb, nre), dtype=torch.complex64,
                     device=dev) if with_h else None)
    noise = torch.empty((*lead, npt), dtype=torch.float32, device=dev)
    if n == 0:
        return h, noise
    key = (cell, sf_idx, ports)
    tabs = [device_table((name,) + key, dev,
                         lambda i=i: kernel_tables(*key)[i])
            for i, name in enumerate(("chest_k_cv", "chest_k_meta",
                                      "chest_k_tw"))]
    host_taps = (ctypes.c_float * (MAX_TAPS + 3))(
        *taps, *[0.0] * (MAX_TAPS - len(taps)), *SMOOTH_3TAP)
    split = min(nsymb, max(1, -(-TARGET_BLOCKS // (n * npt))))
    CHEST_DL.launch(dev, (n, npt, cell.nof_prb), grid.data_ptr(),
                    *(t.data_ptr() for t in tabs), host_taps, len(taps),
                    None if h is None else h.data_ptr(), noise.data_ptr(),
                    n, npt, nsymb, nre, 2 * cell.nof_prb, split)
    return h, noise


def chest_dl_ports(grid, cell: Cell, sf_idx: int, ports,
                   smooth: bool = True, gauss_std: float | None = None):
    """Channel and pilot noise estimates of several TX ports at once:
    grid [..., nsymb, nre] -> (h [..., P, nsymb, nre], noise [..., P]),
    P = len(ports), each port's as ``chest_dl`` and ``noise_est_pilots``
    give them. On the card one kernel launch (``chest_dl_cuda``); on the
    CPU the plain twins."""
    ports = tuple(int(p) for p in ports)
    if grid.is_cuda:
        return chest_dl_cuda(grid.contiguous(), cell, sf_idx, ports,
                             fir_taps(smooth, gauss_std))
    h = torch.stack([_chest_dl_plain(grid, cell, sf_idx, p, smooth,
                                     gauss_std) for p in ports], dim=-3)
    noise = torch.stack([_noise_est_plain(grid, cell, sf_idx, p)
                         for p in ports], dim=-1)
    return h, noise


def chest_dl(grid, cell: Cell, sf_idx: int, port: int = 0,
             smooth: bool = True, gauss_std: float | None = None):
    """Estimate h for one TX port: grid [..., nsymb, nre] -> same shape.

    LS at pilots, 3-tap freq smoothing (or the SNR-adaptive Gaussian of
    ``gauss_std``, chest_dl.c:616 smooth_filter_auto, see
    ``auto_gauss_std``), then freq + time linear interpolation. Batched
    over all leading dims.
    """
    if grid.is_cuda:
        return chest_dl_ports(grid, cell, sf_idx, (port,), smooth,
                              gauss_std)[0][..., 0, :, :]
    return _chest_dl_plain(grid, cell, sf_idx, port, smooth, gauss_std)


def noise_est_pilots(grid, cell: Cell, sf_idx: int, port: int = 0):
    """Noise power from pilot residuals after 3-tap smoothing
    (chest_dl.c:268-329 estimate_noise_pilots): E|h_ls - smooth(h_ls)|^2,
    unbiased by 3/2. Returns [...] per batch element."""
    if grid.is_cuda:
        return chest_dl_cuda(grid.contiguous(), cell, sf_idx, (port,),
                             SMOOTH_3TAP, with_h=False)[1][..., 0]
    return _noise_est_plain(grid, cell, sf_idx, port)


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
