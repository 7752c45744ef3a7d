"""The plain receiver of the 2x2 TM4 downlink, from the specification.

It imports nothing of the program and nothing of ``phybench.frozen``: only
``spec`` beside it, NumPy, and the configuration's numbers. From the
samples [B, rx, sf_len] of one subframe each:

* OFDM: the normal cyclic prefix (160 and 144 samples at 2048) dropped,
  an unnormalised FFT per symbol, the 12 N_RB subcarriers taken around
  the unused DC bin (TS 36.211 6.12);
* CRS (6.10.1) of each port, a least-squares estimate at every pilot,
  the three-tap average (1/3, 1/3, 1/3 to four places, ends repeated)
  along each pilot row, linear interpolation in frequency and in time
  between pilot rows, extrapolated at the edges (srsLTE's
  ``chest_dl.c``);
* the noise estimate: 1.5 times the mean squared distance of port 0's
  least-squares pilots on rx 0 from their three-tap average;
* the PDSCH REs (6.3.5: after the control region, skipping every
  port's CRS), the TM4 precoder of the PMI (Table 6.3.4.2.3-1) folded
  into the channel, a 2x2 MMSE solve per RE, the piecewise-linear
  max-log LLRs of the constellation (TS 36.211 7.1; srsLTE's
  ``demod_soft.c``) weighted by 1 / [(H^H H + N0 I)^-1]_ll, and the
  descrambling of each codeword (6.3.1);
* the DL-SCH (TS 36.212 5.3.2): each code block's LLRs de-rate-matched
  into the three turbo streams, a float32 max-log-MAP turbo decode
  with each block stopping at its CRC, and the TB CRC.

Each stage's output passes through ``Rounding``: unchanged for the
reference, bfloat16 for the control.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from . import spec

N_RB_MAX = 110


def qm_of_mcs(mcs: int) -> int:
    """Modulation order of a PDSCH MCS (TS 36.213 Table 7.1.7.1-1)."""
    return 2 if mcs <= 9 else 4 if mcs <= 16 else 6


def ofdm_demod(samples: np.ndarray, nof_prb: int) -> np.ndarray:
    """[..., sf_len] -> grid [..., 14, 12 N_RB] complex128."""
    n = spec.FFT[nof_prb]
    cp0, cp = 160 * n // 2048, 144 * n // 2048
    starts, pos = [], 0
    for sym in range(14):
        pos += cp0 if sym % 7 == 0 else cp
        starts.append(pos)
        pos += n
    x = np.stack([samples[..., s:s + n] for s in starts], -2)
    spec_ = np.fft.fft(x.astype(np.complex128), axis=-1)
    half = 6 * nof_prb
    return np.concatenate([spec_[..., n - half:], spec_[..., 1:1 + half]], -1)


@functools.lru_cache(maxsize=64)
def crs(cell_id: int, nof_prb: int, sf_idx: int, port: int) -> tuple:
    """Port 0 or 1's CRS in one subframe: (symbols [4], first subcarrier
    of each row [4], values [4, 2 N_RB])."""
    syms, offs, vals = [], [], []
    for slot in range(2):
        ns = 2 * sf_idx + slot
        for l in (0, 4):
            c_init = ((1 << 10) * (7 * (ns + 1) + l + 1) * (2 * cell_id + 1)
                      + 2 * cell_id + 1)
            c = spec.gold(c_init, 4 * N_RB_MAX).astype(np.float64)
            m = np.arange(2 * nof_prb) + N_RB_MAX - nof_prb
            r = ((1 - 2 * c[2 * m]) + 1j * (1 - 2 * c[2 * m + 1])) / math.sqrt(2)
            v = (0 if l == 0 else 3) if port == 0 else (3 if l == 0 else 0)
            syms.append(7 * slot + l)
            offs.append((v + cell_id % 6) % 6)
            vals.append(r)
    return np.asarray(syms), np.asarray(offs), np.stack(vals)


def _ls(grid: np.ndarray, cell_id: int, nof_prb: int, sf_idx: int,
        port: int) -> np.ndarray:
    """Least-squares pilots [..., 4, 2 N_RB]: y conj(r), |r| = 1."""
    syms, offs, vals = crs(cell_id, nof_prb, sf_idx, port)
    return np.stack([grid[..., s, o::6][..., :2 * nof_prb]
                     for s, o in zip(syms, offs)], -2) * np.conj(vals)


def _avg3(h: np.ndarray) -> np.ndarray:
    """The three-tap average along the last axis, the ends repeated."""
    pad = np.concatenate([h[..., :1], h, h[..., -1:]], -1)
    return 0.3333 * pad[..., :-2] + 0.3334 * pad[..., 1:-1] \
        + 0.3333 * pad[..., 2:]


def _linear(x_known: np.ndarray, values: np.ndarray, x: np.ndarray,
            axis: int) -> np.ndarray:
    """Piecewise-linear through ``values`` at the increasing positions
    ``x_known`` along ``axis``, extrapolated from the two end points."""
    j = np.clip(np.searchsorted(x_known, x, side="right") - 1, 0,
                len(x_known) - 2)
    w = (x - x_known[j]) / (x_known[j + 1] - x_known[j])
    lo = np.take(values, j, axis=axis)
    hi = np.take(values, j + 1, axis=axis)
    shape = [1] * values.ndim
    shape[axis] = len(x)
    w = w.reshape(shape)
    return (1 - w) * lo + w * hi


def chest(grid: np.ndarray, cell_id: int, nof_prb: int, sf_idx: int,
          port: int) -> np.ndarray:
    """grid [..., 14, K] -> the port's channel [..., 14, K]."""
    syms, offs, _ = crs(cell_id, nof_prb, sf_idx, port)
    h = _avg3(_ls(grid, cell_id, nof_prb, sf_idx, port))   # [..., 4, M]
    k = np.arange(12 * nof_prb)
    rows = np.stack([_linear(o + 6.0 * np.arange(h.shape[-1]), h[..., i, :],
                             k, -1) for i, o in enumerate(offs)], -2)
    return _linear(syms.astype(np.float64), rows, np.arange(14), -2)


def noise(grid0: np.ndarray, cell_id: int, nof_prb: int,
          sf_idx: int) -> np.ndarray:
    """rx 0's grid [B, 14, K] -> the noise estimate [B]."""
    h = _ls(grid0, cell_id, nof_prb, sf_idx, 0)
    return 1.5 * np.mean(np.abs(h - _avg3(h)) ** 2, axis=(-1, -2))


@functools.lru_cache(maxsize=16)
def pdsch_res(cell_id: int, nof_prb: int, ports: int, cfi: int,
              sf_idx: int) -> np.ndarray:
    """Flat grid indices (symbol 14 + subcarrier) of the PDSCH REs,
    subcarrier first (6.3.5). Subframes 0 and 5 (sync, PBCH) are not
    covered."""
    if sf_idx in (0, 5):
        raise NotImplementedError("subframes 0 and 5 carry sync and PBCH")
    ctrl = cfi + 1 if nof_prb <= 10 else cfi
    used = np.ones((14, 12 * nof_prb), bool)
    used[:ctrl] = False
    for p in range(ports):
        syms, offs, _ = crs(cell_id, nof_prb, sf_idx, p)
        for s, o in zip(syms, offs):
            used[s, o::6] = False
    s, k = np.nonzero(used)
    return s * 12 * nof_prb + k


def precoder(pmi: int) -> np.ndarray:
    """Two ports, two layers (TS 36.211 Table 6.3.4.2.3-1)."""
    if pmi == 0:
        return np.eye(2) / math.sqrt(2)
    if pmi == 1:
        return np.array([[1, 1], [1, -1]]) / 2
    if pmi == 2:
        return np.array([[1, 1], [1j, -1j]]) / 2
    raise ValueError(f"PMI {pmi} has no two-layer precoder")


def mmse(y: np.ndarray, h: np.ndarray, n0: np.ndarray) -> tuple:
    """y [..., 2, M], h [..., rx 2, layer 2, M], n0 [..., 1] -> (x [..., 2,
    M], weight [..., 2, M]): x = (H^H H + N0 I)^-1 H^H y and the weight
    1 / [(H^H H + N0 I)^-1]_ll."""
    hm = np.moveaxis(h, -1, -3)                            # [..., M, 2, 2]
    ym = np.moveaxis(y, -1, -2)[..., None]                 # [..., M, 2, 1]
    a = np.conj(np.swapaxes(hm, -1, -2)) @ hm \
        + n0[..., None, None] * np.eye(2)
    inv = np.linalg.inv(a)
    x = (inv @ (np.conj(np.swapaxes(hm, -1, -2)) @ ym))[..., 0]
    w = 1.0 / np.real(np.diagonal(inv, axis1=-2, axis2=-1))
    return np.moveaxis(x, -2, -1), np.moveaxis(w, -2, -1)


def receive(samples: np.ndarray, conf: dict, lower: bool = False) -> dict:
    """samples [B, rx 2, sf_len] -> dict(soft [cw, B, C, 3 (K+4)] the
    de-rate-matched LLRs, bits [cw, B, tbs] uint8, crc [cw, B] bool,
    iterations [cw, B, C])."""
    rnd = spec.Rounding(lower)
    prb, cid, sf = conf["nof_prb"], conf["cell_id"], conf["sf_idx"]
    ports, cfi, tbs = conf["nof_ports"], conf["cfi"], conf["tbs"]
    if ports != 2 or conf["nof_layers"] != 2 or conf["nof_codewords"] != 2:
        raise NotImplementedError("two ports, two layers, two codewords")
    grid = rnd(ofdm_demod(np.asarray(samples), prb))       # [B, rx, 14, K]
    h = rnd(np.stack([chest(grid, cid, prb, sf, p) for p in range(ports)],
                     -3))                                  # [B, rx, p, 14, K]
    n0 = rnd(np.maximum(noise(grid[:, 0], cid, prb, sf), 1e-7))
    re = pdsch_res(cid, prb, ports, cfi, sf)
    y = grid.reshape(*grid.shape[:-2], -1)[..., re]        # [B, rx, M]
    hp = h.reshape(*h.shape[:-2], -1)[..., re]             # [B, rx, p, M]
    heff = np.einsum("brpm,pl->brlm", hp, precoder(conf["pmi"]))
    x, w = mmse(y, heff, n0[:, None])
    x, w = rnd(x), rnd(w)
    qm = qm_of_mcs(conf["mcs"])
    cws = []
    for cw in range(2):
        llr = rnd(spec.llrs(x[:, cw], qm) * np.repeat(w[:, cw], qm, -1))
        c_init = (conf["rnti"] << 14) + (cw << 13) + (sf << 9) + cid
        cws.append(llr * spec.signs(c_init, llr.shape[-1]))
    # both codewords' blocks in one decode: [cw, B, ...]
    soft = [rnd(s) for s in spec.sch_softbuffers(np.stack(cws), tbs, qm)]
    bits, ok, its = spec.sch_decode(soft, tbs, conf["max_iterations"])
    return dict(soft=np.stack(soft, -2), bits=bits, crc=ok, iterations=its)
