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
gives) and the boundary metric is bfloat16(-1e30). The bfloat16 kernels
hold two neighbouring code blocks per bf16x2 register; up to the 20 MHz
uplink's size and for odd batches the split kernel (``win_split_kernel``)
gives each window two threads, the alpha side and the beta side (see
``win_plan``). Any batch launches without padding.

On a CUDA tensor ``map_decode_win`` launches ``csrc/turbo_win.cu``; on a
CPU tensor it runs ``map_decode_win_plain``, the same recursion in torch
vectorized over (window, code block). The kernels keep no beta store:
they checkpoint a carry once per 8-row segment (32 B per segment and
window; in float32 in a device-memory buffer the wrapper allocates, in
bfloat16 in shared memory) and recompute each segment's metrics in
registers; ``win_plan`` gives the block size, segments and shared-memory
bytes.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ...utils.cuda_build import Kernel
from ...utils.device import H100_SMS, aligned4, device_table, sm_count
from .turbo_nii import DTYPES, LaunchPlan, _wiring, split_blocks, split_plan

NEG = -1e30
#: steps per renormalization (the JAX kernel's GROUP)
GROUP = 8
#: systematic LLR of the padding rows, in the pre-halved domain
PAD_LLR = 1e5
#: overlap training length (turbodecoder_win.h win_overlap_len)
DEFAULT_OVERLAP = 40

#: the launchers per metric dtype: lsa, lp, llr, ckpt; B, K, L, O,
#: threads, (bfloat16: the plan's columns), smem. A launch's shape in the
#: launch registry is (K, window l, code blocks, dtype name)
WIN_KERNELS = {
    torch.float32: Kernel("turbo_win", "turbo_win_launch",
                          [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6),
    torch.bfloat16: Kernel("turbo_win", "turbo_win_launch_bf16",
                           [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7)}
#: the largest bfloat16 launch, in split blocks (windows x ceil(B / 64))
#: per SM of the card, that takes the split kernel when the one-thread
#: kernel could run it: one wave of split blocks at the uplink's window
#: (shared memory holds six a SM), past which the split kernel's shorter
#: chains stop paying for its extra instructions (timed in turns on an
#: H100, PERF.md)
WIN_SPLIT_BLOCKS_PER_SM = 6


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


@functools.lru_cache(maxsize=256)
def win_plan(l: int, o: int, dtype=torch.float32, cbs: int | None = None,
             windows: int = 1, aligned: bool = True,
             sms: int = H100_SMS) -> LaunchPlan:
    """Launch plan of ``csrc/turbo_win.cu`` for window ``l``, overlap
    ``o``, metric ``dtype`` and, in bfloat16, the launch's ``cbs`` code
    blocks over ``windows`` windows, whose arrays all start on 4-byte
    boundaries when ``aligned``, on a card of ``sms`` SMs; the window's
    rows in 8-row segments (the renormalization group). The one-thread
    kernel: one warp, a thread per code block (float32) or code block pair
    (bf16x2), which checkpoints its beta carry entering each segment above
    the first into a device-memory buffer of ``[len(segments) - 1, 8,
    W*B]`` that the wrapper allocates, and a two-slot shared-memory ring
    of 8 staged rows x 4 values of 4 bytes per thread. bfloat16 takes it
    for an even batch on aligned arrays above ``WIN_SPLIT_BLOCKS_PER_SM``
    split blocks a SM, and the split kernel (``split_plan``) otherwise:
    two warps over 32 code block pairs, the alpha side training over the O
    rows before the window, the beta side over the O rows after it, a
    checkpoint per segment in shared memory, and each side's two-slot ring
    of 8 rows x 2 inputs (32 words a row, or 33 for an odd batch or
    unaligned arrays). Raises ``ValueError`` when the geometry does not
    fit."""
    if dtype not in DTYPES:
        raise TypeError(f"dtype {dtype}: the kernel takes {DTYPES}")
    if l % GROUP or o % GROUP or not GROUP <= o <= l:
        raise ValueError(f"window {l}, overlap {o}: need multiples of "
                         f"{GROUP} with {GROUP} <= O <= L")
    segments = tuple((lo, lo + GROUP) for lo in range(0, l, GROUP))
    shifted = cbs is not None and (cbs % 2 == 1 or not aligned)
    if dtype == torch.bfloat16 and (
            cbs is None or shifted
            or split_blocks(windows, cbs) <= WIN_SPLIT_BLOCKS_PER_SM * sms):
        return split_plan(segments, GROUP, 2, shifted)
    threads = 32
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
    ns0, ns1, gi0, gi1, ps0, ps1 = _wiring(dev)
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


def map_decode_win(lsa, lp, *, k: int, l: int, o: int = DEFAULT_OVERLAP):
    """One windowed constituent decode: lsa, lp [K+3, B] -> llr [K, B]
    in the inputs' dtype (see the module docstring)."""
    if not lsa.is_cuda:
        return map_decode_win_plain(lsa, lp, k=k, l=l, o=o)
    b = _check(lsa, lp, k, l, o)
    dt = lsa.dtype
    llr = torch.empty((k, b), dtype=dt, device=lsa.device)
    plan = win_plan(l, o, dt, b, k // l, aligned4(lsa, lp, llr),
                    sm_count(lsa.device))
    # the one-thread kernel (either dtype): the beta carry entering each
    # segment above the first, per window (the split kernel keeps its
    # checkpoints on chip)
    ckpt = (torch.empty((len(plan.checkpoints), 8, k // l * b), dtype=dt,
                        device=lsa.device) if plan.sides == 1 else None)
    WIN_KERNELS[dt].launch(
        lsa.device, (k, l, b, str(dt).removeprefix("torch.")),
        lsa.data_ptr(), lp.data_ptr(), llr.data_ptr(),
        None if ckpt is None else ckpt.data_ptr(), b, k, l, o, plan.threads,
        *((plan.shifted,) if dt == torch.bfloat16 else ()), plan.smem)
    return llr
