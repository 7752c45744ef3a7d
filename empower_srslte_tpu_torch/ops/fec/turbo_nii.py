"""NII max-log-MAP constituent decoder: CUDA kernel and its plain twin.

Counterpart of the JAX package's Pallas kernel ``map_decode_nii``
(empower_srslte_tpu/ops/fec/turbo_decoder_pallas2.py:220). One call runs
one half-iteration of the LTE 8-state RSC constituent over K/l windows
with next-iteration initialization (NII): every window starts from the
boundary metrics its neighbours produced in the previous half-iteration
of the same constituent, so all (code block, window) pairs are
independent. Per window: a backward beta sweep whose metrics are stored,
then a forward alpha sweep emitting ``ext = llr - (u + apr)``; metrics
renormalize every 16 steps; the globally last window walks the 3 tail
steps from the terminated state.

Layout is time-major: rows (trellis steps) major, code blocks minor, so
the kernel's threads — one per (window, code block), code block fastest —
read and write neighbouring addresses.

  u, p, apr        [K, B] float32 or bfloat16 (systematic, parity,
                   a-priori), every input of a call in one dtype
  tail_u, tail_p   [3, B] termination rows of this constituent
  a_st, b_st       [W+1, 8, B] boundary metrics; slot w holds window w's
                   alpha init, slot w+1 window w's beta init (the JAX
                   kernel's a_st[:, :W] / b_st[:, 1:] convention)

On a CUDA tensor ``map_decode_nii`` launches ``csrc/turbo_nii.cu``; on a
CPU tensor it runs ``map_decode_nii_plain``, a torch recursion
vectorized over windows and code blocks with the same operation order
(so the two agree bit for bit on the same device). The outputs and the
boundary metrics come back in the inputs' dtype. In bfloat16 every add,
subtraction and halving rounds to bfloat16, as the JAX kernel does when
its input is bfloat16 (``TurboDecoder(dtype="auto")`` on its kernel
path): the twin's torch bfloat16 ops round per op, the kernels run bf16x2
instructions on two neighbouring code blocks per register. The kernels
keep no beta store in device memory: one thread per window (float32, and
a large even bfloat16 launch) checkpoints the backward carry once per
16-row segment and recomputes each segment's betas on chip; the
bfloat16 split kernel (``nii_split_kernel``, for smaller or odd
launches) gives each window two threads: one runs alpha up the lower
half while the other runs beta down the upper half, then each crosses
into the other's half, recomputing the other recursion's segments from
its checkpoints and emitting. Any batch launches without padding.
``nii_plan`` picks the kernel and gives its block size, segments and
shared-memory bytes.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ...utils.cuda_build import Kernel
from ...utils.device import H100_SMS, MAX_SMEM, aligned4, device_table, \
    sm_count
from .turbo_encoder import trellis

NEG = -1e30
#: steps between renormalizations (the JAX kernel's ``group``)
GROUP = 16

#: the launchers per metric dtype: u, p, apr, tail_u, tail_p, a_st, b_st,
#: ext, a_next, b_next; B, l, W, first, last, threads, (bfloat16: the
#: plan's segment rows and columns), smem. A launch's shape in the launch
#: registry is (K, window l, code blocks, dtype name: "float32" or
#: "bfloat16", first, last) with the resolved ``bounds``: a whole trellis
#: launches at (0, W-1), a trellis-sharded decode (parallel/turbo_sp.py)
#: its edge shards at (0, -1) and (-1, last), its interior ones at (-1, -1)
NII_KERNELS = {
    torch.float32: Kernel("turbo_nii", "turbo_nii_launch",
                          [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7),
    torch.bfloat16: Kernel("turbo_nii", "turbo_nii_launch_bf16",
                           [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9)}

#: metric dtypes the kernel takes
DTYPES = (torch.float32, torch.bfloat16)
#: the bfloat16 split kernels (here and in turbo_win.py): code block pairs
#: per block (one warp per side) and slots of each side's input ring
SPLIT_PAIRS, SPLIT_SLOTS = 32, 2
#: 32-bit words per staged row of a split block: a lane's aligned pair,
#: or (an odd batch, or arrays off a 4-byte boundary) the 33 words its
#: 32 pairs may straddle
SPLIT_ROW_WORDS = {"aligned": 32, "shifted": 33}
#: the largest bfloat16 launch, in split blocks (windows x ceil(B / 64))
#: per SM of the card, that takes the split kernel when the one-thread
#: kernel could run it: one wave of split blocks at the main shape's
#: window (shared memory holds five a SM). Above it the one-thread
#: kernel's fewer instructions per code block win (timed in turns on an
#: H100, PERF.md)
NII_SPLIT_BLOCKS_PER_SM = 5
#: rows per segment of the split kernel: half the renormalization group
#: (64 registers of recomputed metrics; 16 rows took 255 and spilled),
#: or the whole group where a long window's 8-row checkpoints do not fit
SPLIT_SEGMENTS = (8, 16)


@dataclass(frozen=True)
class LaunchPlan:
    """Geometry of one kernel launch: ``threads`` per block, each
    holding ``cbs_per_thread`` code blocks in a register (1 in float32, 2
    packed in bf16x2), ``segments`` ([lo, hi) window rows, bottom up, the
    unit of the checkpoints), the block's dynamic shared-memory ``smem``
    bytes, and ``sides``: 1 when a thread runs a window's whole schedule,
    2 in the split bfloat16 kernels, where one warp runs alpha up the
    lower ``split`` segments and the other beta down the rest before
    each crosses into the other's half, staging each lane's pair as one
    aligned word or, ``shifted``, as the two words it may straddle."""

    threads: int
    segments: tuple
    smem: int
    cbs_per_thread: int = 1
    sides: int = 1
    split: int = 0
    shifted: bool = False

    @property
    def checkpoints(self) -> tuple:
        """Window rows whose entering carry is kept. One thread per
        window: the backward carry at the top row of every segment but
        the first. Split: the alpha carry at the first row of each of the
        ``split`` lower segments, then the beta carry at the top row of
        each upper one."""
        if self.sides == 1:
            return tuple(hi - 1 for _, hi in self.segments[1:])
        return (tuple(lo for lo, _ in self.segments[:self.split])
                + tuple(hi - 1 for _, hi in self.segments[self.split:]))

    @property
    def threads_per_cb(self) -> float:
        """Threads that work on one code block's window."""
        return self.sides / self.cbs_per_thread


def split_plan(segments: tuple, rows: int, inputs: int,
               shifted: bool) -> LaunchPlan:
    """The bfloat16 split kernels' plan: two warps of ``SPLIT_PAIRS``
    code block pairs, a 32-byte checkpoint per segment and pair, and the
    two sides' rings of ``SPLIT_SLOTS`` slots of ``rows`` x ``inputs``
    staged rows (``SPLIT_ROW_WORDS``); the alpha side starts on the lower
    half of the segments."""
    words = SPLIT_ROW_WORDS["shifted" if shifted else "aligned"]
    smem = (len(segments) * 2 * SPLIT_PAIRS * 16
            + 2 * SPLIT_SLOTS * rows * inputs * words * 4)
    return LaunchPlan(2 * SPLIT_PAIRS, segments, smem, 2, 2,
                      len(segments) // 2, shifted)


def split_blocks(windows: int, cbs: int) -> int:
    """Blocks of a bfloat16 split launch: windows x ceil(B / 64)."""
    return windows * -(-cbs // (2 * SPLIT_PAIRS))


@functools.lru_cache(maxsize=256)
def nii_plan(l: int, apr: bool, dtype=torch.float32, cbs: int | None = None,
             windows: int = 1, aligned: bool = True,
             sms: int = H100_SMS) -> LaunchPlan:
    """Launch plan of ``csrc/turbo_nii.cu`` for window ``l`` (with or
    without an a-priori input), metric ``dtype`` and, in bfloat16, the
    launch's ``cbs`` code blocks over ``windows`` windows, whose arrays
    all start on 4-byte boundaries when ``aligned``, on a card of ``sms``
    SMs. The one-thread kernel: one warp, a thread per code block
    (float32) or code block pair (bf16x2); segments are the 16-row
    renormalization groups, the top one 8 rows when l % 16 == 8; shared
    memory per thread holds one checkpoint (8 metrics, 32 B) per segment
    above the first and a two-slot ring of 16 staged rows of u, p (and
    apr) at 4 B; the segment's betas stay in registers. bfloat16 takes it
    for an even batch on aligned arrays above ``NII_SPLIT_BLOCKS_PER_SM``
    split blocks a SM, and the split kernel (``split_plan``) otherwise:
    two warps over 32 code block pairs, 8-row segments (16 where those do
    not fit) with a checkpoint each, and each side's two-slot ring of one
    segment's rows x 2 or 3 inputs (32 words a row, or 33 for an odd batch
    or unaligned arrays). Raises ``ValueError`` when the window does not
    fit."""
    if dtype not in DTYPES:
        raise TypeError(f"dtype {dtype}: the kernel takes {DTYPES}")
    if l % 8 or l < GROUP:
        raise ValueError(f"window {l}: the kernel needs a multiple of 8 "
                         f">= {GROUP}")
    segments = tuple((lo, min(lo + GROUP, l)) for lo in range(0, l, GROUP))
    nin = 3 if apr else 2
    shifted = cbs is not None and (cbs % 2 == 1 or not aligned)
    if dtype == torch.bfloat16 and (
            cbs is None or shifted
            or split_blocks(windows, cbs) <= NII_SPLIT_BLOCKS_PER_SM * sms):
        for rows in SPLIT_SEGMENTS:
            plan = split_plan(tuple((lo, min(lo + rows, l))
                                    for lo in range(0, l, rows)),
                              rows, nin, shifted)
            if plan.smem <= MAX_SMEM:
                break
    else:
        threads = 32
        plan = LaunchPlan(threads, segments, threads * (
            32 * (len(segments) - 1) + 4 * 2 * GROUP * nin),
            2 if dtype == torch.bfloat16 else 1)
    if plan.smem > MAX_SMEM:
        raise ValueError(f"window {l}: {plan.smem} B of shared memory per "
                         f"block exceeds {MAX_SMEM}")
    return plan


@functools.lru_cache(maxsize=1)
def _wiring_np():
    t = trellis()
    ns, par, ps = t.next_state, t.parity, t.prev_state
    # gamma slot per (state, input): g[(0, p)] -> p, g[(1, p)] -> 2 + p
    return (ns[:, 0].astype(np.int64), ns[:, 1].astype(np.int64),
            par[:, 0].astype(np.int64), 2 + par[:, 1].astype(np.int64),
            ps[:, 0].astype(np.int64), ps[:, 1].astype(np.int64))


def _wiring(device):
    return [device_table(("nii_wiring", i), device, lambda a=a: a)
            for i, a in enumerate(_wiring_np())]


def _gammas(uu, pp):
    """[4, ...]: g(0,0), g(0,1), g(1,0), g(1,1) = g00, g01, -g01, -g00."""
    g00 = (uu + pp) * 0.5
    g01 = (uu - pp) * 0.5
    return torch.stack([g00, g01, -g01, -g00])


def _exact(shape, device, dtype=torch.float32):
    e = torch.full((8, *shape), NEG, dtype=dtype, device=device)
    e[0] = 0.0
    return e


def _check(u, p, tail_u, tail_p, a_st, b_st, l, apr):
    """Shapes, one dtype of ``DTYPES``, one device, contiguity: -> (K, B,
    W)."""
    k, b = u.shape
    if k % l:
        raise ValueError(f"K={k} is not a multiple of the window {l}")
    w = k // l
    want = {"u": (u, (k, b)), "p": (p, (k, b)), "tail_u": (tail_u, (3, b)),
            "tail_p": (tail_p, (3, b)), "a_st": (a_st, (w + 1, 8, b)),
            "b_st": (b_st, (w + 1, 8, b))}
    if apr is not None:
        want["apr"] = (apr, (k, b))
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(x.shape)}, want {shape}")
        if x.dtype != u.dtype or u.dtype not in DTYPES:
            raise TypeError(f"{name}: dtype {x.dtype}, u {u.dtype}; all "
                            f"inputs must share one of {DTYPES}")
        if x.device != u.device:
            raise ValueError(f"{name} is on {x.device}, u on {u.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return k, b, w


def map_decode_nii_plain(u, p, tail_u, tail_p, a_st, b_st, *, l: int,
                         apr=None, bounds=None):
    """Plain torch twin of the NII kernel (see the module docstring).
    Returns (ext [K, B], a_next [W+1, 8, B], b_next [W+1, 8, B])."""
    k, b, w_count = _check(u, p, tail_u, tail_p, a_st, b_st, l, apr)
    first, last = (0, w_count - 1) if bounds is None else bounds
    dev, dt = u.device, u.dtype
    ns0, ns1, gi0, gi1, ps0, ps1 = _wiring(dev)
    uu_all = u + apr if apr is not None else u
    uw = uu_all.view(w_count, l, b)
    pw = p.view(w_count, l, b)

    beta = b_st[1:].permute(1, 0, 2).clone()               # [8, W, B]
    if 0 <= last < w_count:
        bt = _exact((b,), dev, dt)
        for j in (2, 1, 0):
            g = _gammas(tail_u[j], tail_p[j])
            bt = torch.maximum(bt[ns0] + g[gi0], bt[ns1] + g[gi1])
        beta[:, last] = bt - torch.amax(bt, 0)
    betas = torch.empty((l, 8, w_count, b), dtype=dt, device=dev)
    for r in range(l - 1, -1, -1):
        g = _gammas(uw[:, r], pw[:, r])                    # [4, W, B]
        betas[r] = beta
        beta = torch.maximum(beta[ns0] + g[gi0], beta[ns1] + g[gi1])
        if r % GROUP == 0:
            beta = beta - torch.amax(beta, 0)
    b_next = torch.zeros_like(b_st)
    b_next[:w_count] = beta.permute(1, 0, 2)

    alpha = a_st[:w_count].permute(1, 0, 2).clone()
    if 0 <= first < w_count:
        alpha[:, first] = _exact((b,), dev, dt)
    ext = torch.empty((w_count, l, b), dtype=dt, device=dev)
    for r in range(l):
        g = _gammas(uw[:, r], pw[:, r])
        br0 = alpha + g[gi0]
        br1 = alpha + g[gi1]
        bk1 = betas[r]
        tot0 = torch.amax(br0 + bk1[ns0], 0)
        tot1 = torch.amax(br1 + bk1[ns1], 0)
        ext[:, r] = tot0 - tot1 - uw[:, r]
        alpha = torch.maximum(br0[ps0], br1[ps1])
        if r % GROUP == GROUP - 1 or r == l - 1:
            alpha = alpha - torch.amax(alpha, 0)
    a_next = torch.zeros_like(a_st)
    a_next[1:] = alpha.permute(1, 0, 2)
    return ext.reshape(k, b), a_next, b_next


def map_decode_nii(u, p, tail_u, tail_p, a_st, b_st, *, l: int, apr=None,
                   bounds=None):
    """One NII constituent decode; see the module docstring.

    Inputs are all float32 or all bfloat16; the outputs come back in that
    dtype. ``bounds`` = (first, last): the windows holding the globally
    first / last trellis step (default (0, W-1); (-1, -1) marks a trellis
    slice with no edge, every boundary metric coming from a_st / b_st).
    Returns (ext [K, B], a_next, b_next) in the slot convention above,
    ready to pass back on the next call. Any batch launches as it is.
    """
    if not u.is_cuda:
        return map_decode_nii_plain(u, p, tail_u, tail_p, a_st, b_st, l=l,
                                    apr=apr, bounds=bounds)
    k, b, w_count = _check(u, p, tail_u, tail_p, a_st, b_st, l, apr)
    first, last = (0, w_count - 1) if bounds is None else bounds
    dt = u.dtype
    ext = torch.empty_like(u)
    a_next = torch.empty_like(a_st)
    b_next = torch.empty_like(b_st)
    plan = nii_plan(l, apr is not None, dt, b, w_count,
                    aligned4(u, p, apr, tail_u, tail_p, a_st, b_st, ext,
                             a_next, b_next), sm_count(u.device))
    NII_KERNELS[dt].launch(
        u.device, (k, l, b, str(dt).removeprefix("torch."), first, last),
        u.data_ptr(), p.data_ptr(), None if apr is None else apr.data_ptr(),
        tail_u.data_ptr(), tail_p.data_ptr(), a_st.data_ptr(),
        b_st.data_ptr(), ext.data_ptr(), a_next.data_ptr(),
        b_next.data_ptr(), b, l, w_count, first, last, plan.threads,
        *((plan.segments[0][1], plan.shifted) if dt == torch.bfloat16
          else ()),
        plan.smem)
    return ext, a_next, b_next
