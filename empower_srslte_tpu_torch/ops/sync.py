"""Synchronization signals and estimators: PSS, SSS, CFO, CP type, SFO.

Capability parity with lib/src/phy/sync/: Zadoff-Chu PSS generation and
FFT-convolution detection (pss.c:354,457-541), SSS m0/m1 m-sequence
generation and detection (gen_sss.c:115-162, find_sss.c:91-178,
sss.c:132-152), CFO estimation from the PSS half-symbol correlation
(pss.c:614-627) and the CP autocorrelation (cp.c:66), CFO correction by a
complex-exponential multiply (cfo.c:97), CP detection (sync.c:377-432).

The PSS search is one batched FFT correlation over the 3 roots; SSS
detection is one [336, 62] correlation over every (N_id_1, half-frame)
hypothesis. Sequences are numpy tables built on the host and cached on
the tensors' device.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..utils.cell import CP, Cell
from ..utils.device import device_table

#: PSS Zadoff-Chu root per N_id_2 (36.211 Table 6.11.1.1-1).
PSS_ROOTS = (25, 29, 34)
#: PSS/SSS occupy 62 subcarriers around DC.
SYNC_LEN = 62


# --- PSS --------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def pss_freq(n_id_2: int) -> np.ndarray:
    """Frequency-domain PSS d_u(n), length 62 (36.211 6.11.1.1)."""
    u = PSS_ROOTS[n_id_2]
    n = np.arange(31)
    top = np.exp(-1j * np.pi * u * n * (n + 1) / 63.0)
    n2 = np.arange(31, 62)
    bot = np.exp(-1j * np.pi * u * (n2 + 1) * (n2 + 2) / 63.0)
    return np.concatenate([top, bot]).astype(np.complex64)


@functools.lru_cache(maxsize=32)
def pss_time(n_id_2: int, fft_size: int = 128) -> np.ndarray:
    """Time-domain PSS replica: 62 subcarriers around DC -> IFFT, unit
    norm (pss.c srslte_pss_generate + ifft; the matched filter)."""
    spec = np.zeros(fft_size, np.complex64)
    d = pss_freq(n_id_2)
    spec[fft_size - 31:fft_size] = d[:31]
    spec[1:32] = d[31:]
    t = np.fft.ifft(spec).astype(np.complex64)
    return t / np.linalg.norm(t)


def pss_find(samples: torch.Tensor, fft_size: int = 128):
    """Batched PSS search over all 3 roots.

    samples [..., N] -> (corr_mag [..., 3, N], peak_pos [..., 3],
    peak_to_sidelobe [..., 3]). Cross-correlation in the frequency domain
    (srslte_pss_find_pss, pss.c:457-541) at an FFT length of the next
    power of two >= N + fft_size; the peak index is the start of the PSS
    data region (after its CP).
    """
    n = samples.shape[-1]
    nfft = 1 << int(np.ceil(np.log2(n + fft_size)))
    filt = device_table(
        ("pss_filt", fft_size, nfft), samples.device,
        lambda: np.stack([np.conj(np.fft.fft(pss_time(r, fft_size), nfft))
                          for r in range(3)]).astype(np.complex64))
    spec = torch.fft.fft(samples, n=nfft, dim=-1)[..., None, :]
    corr = torch.fft.ifft(spec * filt, dim=-1)[..., :n]
    mag = corr.abs()
    peak = torch.argmax(mag, dim=-1)
    psr = torch.amax(mag, dim=-1) / torch.clamp(mag.mean(-1), min=1e-12)
    return mag, peak, psr


def pss_cfo_estimate(samples: torch.Tensor, peak_start: torch.Tensor,
                     n_id_2: int, fft_size: int = 128):
    """CFO from the phase between the two PSS half-symbol correlations
    (pss.c:614-627). samples [..., N], ``peak_start`` [...] the index of
    the first PSS data sample. Returns the CFO in subcarrier spacings."""
    half = fft_size // 2
    idx = peak_start[..., None] + torch.arange(fft_size,
                                               device=samples.device)
    seg = torch.gather(samples, -1, idx)
    replica = device_table(("pss_time", n_id_2, fft_size), samples.device,
                           lambda: pss_time(n_id_2, fft_size))
    prod = seg * torch.conj(replica)
    c0 = prod[..., :half].sum(-1)
    c1 = prod[..., half:].sum(-1)
    # phase drift over half a symbol = pi * cfo (in subcarrier units)
    return torch.angle(c1 * torch.conj(c0)) / math.pi


def cfo_correct(samples: torch.Tensor, cfo, fft_size: int) -> torch.Tensor:
    """Multiply by exp(-j 2 pi cfo n / fft) (srslte_cfo_correct, cfo.c:97).

    ``cfo`` in subcarrier spacings, a float or a tensor broadcasting over
    the leading dims. The phase is reduced to a fraction of a cycle in
    float64 before the float32 exponential, so it stays exact over a long
    capture (a float32 phase of 2 pi cfo n / fft drifts by ~1e-5 rad
    after 1e6 samples).
    """
    dev = samples.device
    n = torch.arange(samples.shape[-1], dtype=torch.float64, device=dev)
    c = torch.as_tensor(cfo, dtype=torch.float64, device=dev)[..., None]
    cyc = c * n / fft_size
    frac = (cyc - torch.round(cyc)).to(torch.float32)
    ph = torch.polar(torch.ones_like(frac), -2.0 * math.pi * frac)
    return samples * ph.to(samples.dtype)


def _cp_correlations(samples: torch.Tensor, cell: Cell, magnitude: bool):
    """Sum over one subframe's symbols of sum_t r(t) r*(t + fft) over each
    CP (its magnitude per symbol when ``magnitude``)."""
    fft = cell.fft_size
    cps = cell.cp_len_slot
    acc = None
    pos = 0
    for rep in range(2 * cell.nsymb_slot):
        cp_len = cps[rep % cell.nsymb_slot]
        a = samples[..., pos:pos + cp_len]
        b = samples[..., pos + fft:pos + fft + cp_len]
        c = (a * torch.conj(b)).sum(-1)
        if magnitude:
            c = c.abs()
        acc = c if acc is None else acc + c
        pos += cp_len + fft
    return acc


def cp_cfo_estimate(samples: torch.Tensor, cell: Cell):
    """Coarse CFO from the CP autocorrelation r(t) r*(t+N) (cp.c:66,
    sync.c:474-481) over one subframe. Returns the CFO in subcarrier
    spacings [...]."""
    acc = _cp_correlations(samples, cell, magnitude=False)
    return -torch.angle(torch.conj(acc)) / (2 * math.pi)


# --- SSS --------------------------------------------------------------------


def _mseq(taps: tuple[int, ...]) -> np.ndarray:
    """Length-31 m-sequence +-1 from x(i+5) = sum(taps) with x=...00001."""
    x = np.zeros(31, np.int64)
    x[4] = 1
    for i in range(26):
        x[i + 5] = np.sum(x[np.array(taps) + i]) % 2
    return (1 - 2 * x).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _sss_bases():
    s_t = _mseq((2, 0))          # s~: x5 = x2 + x0
    c_t = _mseq((3, 0))          # c~: x5 = x3 + x0
    z_t = _mseq((4, 2, 1, 0))    # z~: x5 = x4 + x2 + x1 + x0
    return s_t, c_t, z_t


def _m0m1(n_id_1: int) -> tuple[int, int]:
    """m0/m1 from N_id_1 (36.211 Table 6.11.2.1-1 generation rule)."""
    q_prime = n_id_1 // 30
    q = (n_id_1 + q_prime * (q_prime + 1) // 2) // 30
    m_prime = n_id_1 + q * (q + 1) // 2
    m0 = m_prime % 31
    m1 = (m0 + m_prime // 31 + 1) % 31
    return m0, m1


@functools.lru_cache(maxsize=2048)
def sss_freq(n_id_1: int, n_id_2: int, sf_idx: int) -> np.ndarray:
    """SSS d(n), length 62, for subframe 0 or 5 (36.211 6.11.2.1)."""
    assert sf_idx in (0, 5)
    s_t, c_t, z_t = _sss_bases()
    m0, m1 = _m0m1(n_id_1)
    if sf_idx == 5:
        m0, m1 = m1, m0
    n = np.arange(31)
    s0 = s_t[(n + m0) % 31]
    s1 = s_t[(n + m1) % 31]
    c0 = c_t[(n + n_id_2) % 31]
    c1 = c_t[(n + n_id_2 + 3) % 31]
    z1 = z_t[(n + (m0 % 8)) % 31]
    d = np.empty(62, np.float32)
    d[0::2] = s0 * c0
    d[1::2] = s1 * c1 * z1
    return d.astype(np.complex64)


@functools.lru_cache(maxsize=8)
def _sss_table(n_id_2: int) -> np.ndarray:
    """[2*168, 62] hypothesis matrix: rows = (sf in {0,5}) x N_id_1."""
    rows = [sss_freq(nid1, n_id_2, sf) for sf in (0, 5)
            for nid1 in range(168)]
    return np.stack(rows).astype(np.complex64)


def sss_detect(sss_re: torch.Tensor, n_id_2: int):
    """N_id_1 and the frame half from the equalized 62-RE SSS symbol.

    sss_re [..., 62] -> (n_id_1 [...], sf_is_5 [...], metric [...]): one
    correlation against all 336 hypotheses (find_sss.c's partial
    correlation stages as a single product).
    """
    table_c = device_table(("sss_table_conj", n_id_2), sss_re.device,
                           lambda: np.conj(_sss_table(n_id_2)))
    corr = torch.einsum("...k,hk->...h", sss_re, table_c)
    mag = corr.abs()
    best = torch.argmax(mag, dim=-1)
    power = (sss_re.abs() ** 2).sum(-1) * SYNC_LEN
    metric = torch.amax(mag, dim=-1) / torch.clamp(torch.sqrt(power),
                                                    min=1e-12)
    return best % 168, best >= 168, metric


def sync_re_indices(cell: Cell) -> np.ndarray:
    """Subcarrier indices of the central 62 sync REs in the cell grid."""
    mid = cell.nof_re // 2
    return np.arange(mid - 31, mid + 31)


def detect_cp(samples: torch.Tensor, nof_prb: int):
    """Normal vs extended CP from one subframe of aligned samples (the Kim
    et al. correlation test, sync.c:377-432): the CP autocorrelation
    energy under both hypotheses.

    Returns (is_normal [...], metric_norm [...], metric_ext [...]).
    """
    m_norm = _cp_correlations(samples, Cell(nof_prb=nof_prb, id=0,
                                            cp=CP.NORM), magnitude=True)
    m_ext = _cp_correlations(samples, Cell(nof_prb=nof_prb, id=0,
                                           cp=CP.EXT), magnitude=True)
    return m_norm >= m_ext, m_norm, m_ext


def sfo_estimate(peak_positions: torch.Tensor, frame_len: int):
    """Sampling frequency offset from the PSS peak drift across frames
    (sfo.c): peaks [..., n_frames] -> SFO in samples per frame (the
    least-squares slope, frame jumps unwrapped)."""
    n = peak_positions.shape[-1]
    x = torch.arange(n, dtype=torch.float32, device=peak_positions.device)
    y = (peak_positions - peak_positions[..., :1]).to(torch.float32)
    y = y - torch.round(y / frame_len) * frame_len
    xm = x - x.mean()
    return (xm * y).sum(-1) / torch.clamp((xm * xm).sum(), min=1e-9)
