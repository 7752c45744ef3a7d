"""Windowed-overlap max-log-MAP constituent decoder: CUDA kernel and twin.

Counterpart of the JAX package's Pallas kernel ``map_decode_fused`` (body
``_half_iter_kernel``, empower_srslte_tpu/ops/fec/turbo_decoder_pallas.py:
62-235), the windowed scheme of srsLTE's turbodecoder_win.h: one call is
one constituent decode. The K payload steps are cut into W = K/L windows,
all decoded in parallel. Each window trains its alpha recursion over the O
steps before it and its beta recursion over the O steps after it, starting
from uniform metrics; window 0's alpha and the last window's beta start
from the exact boundary metric {0, -1e30 x 7}. Trellis rows outside
[0, K+3) are padding: the systematic/a-priori rows read as ``PAD_LLR``
and the parity rows as 0, so the exact boundary metric survives the
padded steps (turbo_decoder.py:136-144 of the JAX package).

Arithmetic copied from the JAX kernel, for bit parity: real rows are
halved at load (the JAX decoder halves before padding; x0.5 is exact),
gammas are g00 = ls + lp, g01 = ls - lp, g10 = -g01, g11 = -g00; both
sweeps renormalize once per 8-step group by the 8-state maximum; the beta
sweep stores the carry that enters each step (only the first of each
group is normalized); the alpha sweep emits
``llr = max_s(a_s + g(0) + b_ns0) - max_s(a_s + g(1) + b_ns1)``
after its O training steps.

Layout is time-major: ``lsa``, ``lp`` [K+3, B] full-scale (payload plus
the 3 termination rows), code blocks minor; the output is the full-scale
a-posteriori ``llr`` [K, B]. Both inputs are float32, or both bfloat16,
and the output comes back in their dtype. In bfloat16 every operation
rounds to bfloat16, as the JAX kernel does when the v1 decoder feeds it
bfloat16 (``TurboDecoder(dtype="auto")`` on its kernel path): rows are
halved in bfloat16 before the padding, the padding's systematic value is
``PAD_LLR`` rounded to bfloat16 (99,840, as ``jnp.full(..., 1e5, bf16)``
gives) and the boundary metric is bfloat16(-1e30). The kernel
(``win_kernel<OpsBf16x2>``) decodes two neighbouring code blocks per
thread in bf16x2 registers.

On a CUDA tensor ``map_decode_win`` launches ``csrc/turbo_win.cu``; on a
CPU tensor it runs ``map_decode_win_plain``, the same recursion in torch
vectorized over (window, code block). The kernel keeps no beta store: it
checkpoints the beta carry once per 8-row segment (32 B per segment and
window, in a device-memory buffer the wrapper allocates) and recomputes
each segment's betas in registers; ``win_plan`` gives its block size,
segments and shared-memory bytes.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from ...utils.device import device_table
from .turbo_encoder import trellis
from .turbo_nii import DTYPES, LaunchPlan, _pad_even

NEG = -1e30
#: steps per renormalization (the JAX kernel's GROUP)
GROUP = 8
#: systematic LLR of the padding rows, in the pre-halved domain
PAD_LLR = 1e5
#: overlap training length (turbodecoder_win.h win_overlap_len)
DEFAULT_OVERLAP = 40

#: float32 kernel launches made by ``map_decode_win`` (read by
#: chip_smoke.py)
LAUNCHES = 0
#: bfloat16 kernel launches made by ``map_decode_win``
LAUNCHES_BF16 = 0
#: the same launches per shape (K, window l, code blocks, dtype name);
#: reset it with ``LAUNCHES_BY_SHAPE.clear()``
LAUNCHES_BY_SHAPE: collections.Counter = collections.Counter()


@functools.lru_cache(maxsize=1)
def _wiring_np():
    t = trellis()
    ns, par, ps = t.next_state, t.parity, t.prev_state
    # gamma slot per (state, input): g[(0, p)] -> p, g[(1, p)] -> 2 + p
    return (ns[:, 0].astype(np.int64), ns[:, 1].astype(np.int64),
            par[:, 0].astype(np.int64), 2 + par[:, 1].astype(np.int64),
            ps[:, 0].astype(np.int64), ps[:, 1].astype(np.int64))


def _check(lsa, lp, k: int, l: int, o: int) -> int:
    if k % l or l % GROUP or o % GROUP or not 3 <= o <= l:
        raise ValueError(f"K={k}, window {l}, overlap {o}: need K % L == 0 "
                         f"and L, O multiples of {GROUP} with 3 <= O <= L")
    for name, x in (("lsa", lsa), ("lp", lp)):
        if tuple(x.shape) != (k + 3, lsa.shape[1]):
            raise ValueError(f"{name}: shape {tuple(x.shape)}, "
                             f"want ({k + 3}, B)")
        if x.dtype != lsa.dtype or lsa.dtype not in DTYPES:
            raise TypeError(f"{name}: dtype {x.dtype}, lsa {lsa.dtype}; "
                            f"both must share one of {DTYPES}")
        if x.device != lsa.device:
            raise ValueError(f"{name} is on {x.device}, lsa on {lsa.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return lsa.shape[1]


def win_plan(l: int, o: int, dtype=torch.float32) -> LaunchPlan:
    """Launch plan of ``csrc/turbo_win.cu`` for window ``l``, overlap
    ``o`` and metric ``dtype``: 32 threads per block, the window's rows in
    8-row segments (the renormalization group; the backward sweep
    checkpoints its carry entering each one above the first, into a
    device-memory buffer of ``[len(segments) - 1, 8, W*B]`` in ``dtype``
    that the wrapper allocates), and a two-slot shared-memory ring of 8
    staged rows x 4 values of 4 bytes per thread. A bfloat16 thread
    decodes two code blocks (one bf16x2 value), so the same bytes cover
    twice the code blocks. Raises ``ValueError`` when the geometry does
    not fit."""
    if dtype not in DTYPES:
        raise TypeError(f"dtype {dtype}: the kernel takes {DTYPES}")
    if l % GROUP or o % GROUP or not GROUP <= o <= l:
        raise ValueError(f"window {l}, overlap {o}: need multiples of "
                         f"{GROUP} with {GROUP} <= O <= L")
    threads = 32
    segments = tuple((lo, lo + GROUP) for lo in range(0, l, GROUP))
    return LaunchPlan(threads, segments, threads * 4 * 2 * GROUP * 4,
                      2 if dtype == torch.bfloat16 else 1)


def _window_rows(x, pad: float, k: int, l: int, o: int):
    """[K+3, B] full-scale -> halved, padded rows per window
    [L+2O, W*B] (row r of window w is trellis row w*L - O + r)."""
    b = x.shape[1]
    w = k // l
    lead = x.new_full((o, b), pad)
    trail = x.new_full((o - 3, b), pad)
    pd = torch.cat([lead, x * 0.5, trail])                 # [K+2O, B]
    idx = device_table(("win_rows", k, l, o), x.device, lambda: (
        np.arange(w)[None, :] * l + np.arange(l + 2 * o)[:, None]))
    return pd[idx].reshape(l + 2 * o, w * b)


def map_decode_win_plain(lsa, lp, *, k: int, l: int, o: int = DEFAULT_OVERLAP):
    """Plain torch twin of the windowed kernel (see the module docstring)."""
    b = _check(lsa, lp, k, l, o)
    w = k // l
    n = w * b
    dev, dt = lsa.device, lsa.dtype
    ns0, ns1, gi0, gi1, ps0, ps1 = [
        device_table(("win_wiring", i), dev, lambda a=a: a)
        for i, a in enumerate(_wiring_np())]
    ls = _window_rows(lsa, PAD_LLR, k, l, o)
    lq = _window_rows(lp, 0.0, k, l, o)

    def gammas(r):
        g00 = ls[r] + lq[r]
        g01 = ls[r] - lq[r]
        return torch.stack([g00, g01, -g01, -g00])

    def edge(first: bool):
        m = torch.zeros((8, w, b), dtype=dt, device=dev)
        m[1:, 0 if first else w - 1] = NEG
        return m.reshape(8, n)

    beta = edge(False)
    betas = torch.empty((l, 8, n), dtype=dt, device=dev)
    for i in range(l + o - 1, -1, -1):
        g = gammas(o + i)
        if i < l:
            betas[i] = beta
        beta = torch.maximum(beta[ns0] + g[gi0], beta[ns1] + g[gi1])
        if i % GROUP == 0:
            beta = beta - torch.amax(beta, 0)

    alpha = edge(True)
    llr = torch.empty((l, n), dtype=dt, device=dev)
    for i in range(l + o):
        g = gammas(i)
        br0 = alpha + g[gi0]
        br1 = alpha + g[gi1]
        if i >= o:
            bk1 = betas[i - o]
            llr[i - o] = (torch.amax(br0 + bk1[ns0], 0)
                          - torch.amax(br1 + bk1[ns1], 0))
        alpha = torch.maximum(br0[ps0], br1[ps1])
        if i % GROUP == GROUP - 1:
            alpha = alpha - torch.amax(alpha, 0)
    return llr.view(l, w, b).transpose(0, 1).reshape(k, b)


@functools.lru_cache(maxsize=2)
def _lib(dtype):
    from ...utils.cuda_build import load

    lib = load("turbo_win")
    fn = (lib.turbo_win_launch_bf16 if dtype == torch.bfloat16
          else lib.turbo_win_launch)
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def map_decode_win(lsa, lp, *, k: int, l: int, o: int = DEFAULT_OVERLAP):
    """One windowed constituent decode: lsa, lp [K+3, B] -> llr [K, B]
    in the inputs' dtype (see the module docstring). In bfloat16 an odd
    batch is padded with one code block of zeros for the launch and
    dropped again."""
    global LAUNCHES, LAUNCHES_BF16
    if not lsa.is_cuda:
        return map_decode_win_plain(lsa, lp, k=k, l=l, o=o)
    b = _check(lsa, lp, k, l, o)
    dt = lsa.dtype
    plan = win_plan(l, o, dt)
    odd = dt == torch.bfloat16 and b % 2
    if odd:
        lsa, lp = _pad_even(lsa), _pad_even(lp)
    bp = lsa.shape[1]
    llr = torch.empty((k, bp), dtype=dt, device=lsa.device)
    # the beta carry entering each segment above the first, per window
    ckpt = torch.empty((len(plan.checkpoints), 8, k // l * bp), dtype=dt,
                       device=lsa.device)
    with torch.cuda.device(lsa.device):      # the launcher's device
        rc = _lib(dt)(lsa.data_ptr(), lp.data_ptr(), llr.data_ptr(),
                      ckpt.data_ptr(), bp, k, l, o, plan.threads, plan.smem,
                      torch.cuda.current_stream(lsa.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"turbo_win kernel launch failed: CUDA error {rc}")
    if dt == torch.bfloat16:
        LAUNCHES_BF16 += 1
    else:
        LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(k, l, b, str(dt).removeprefix("torch."))] += 1
    return llr[:, :b].contiguous() if odd else llr
