"""64-state tail-biting Viterbi (K=7, rate 1/3): the CUDA kernel wrapper.

Counterpart of the JAX package's Pallas kernel ``viterbi_regs_pallas``
(empower_srslte_tpu/ops/fec/viterbi_pallas.py:146) and its host wrapper
``viterbi_decode_pallas`` (:171). The kernel (csrc/viterbi37.cu) runs the
same three-segment recursion as the plain twin
``convcoder.viterbi_decode_plain``: one warp per code word (lane j holds
states j and j+32), several words per block, no block barrier; it keeps
each step's decisions as two ballot words and recovers the winner's
survivor bits by traceback instead of register exchange. It returns them
packed as the twin's winner registers; unpacking them to bits is a tensor
op here. ``vit_plan`` gives the launch geometry.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from ...utils.cuda_build import Kernel
from ...utils.device import MAX_SMEM
from .convcoder import TRAIN_LEN, unpack_regs

#: the launcher: llr, regs; B, K, halo, registers a word, warps, smem. A
#: launch's shape in the launch registry is (K, halo, code words)
VITERBI37 = Kernel("viterbi37", "viterbi37_launch",
                   [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6)
#: code words (warps) per block
WARPS = 4
#: shared bytes per warp besides the per-column and per-step arrays: the
#: double-buffered 64-float metric array
_METRIC_BYTES = 2 * 64 * 4
#: largest K the kernel takes: a block's WARPS words with halo = K fit
MAX_K = (MAX_SMEM // WARPS - _METRIC_BYTES) // (32 + 2 * 8)


@dataclass(frozen=True)
class VitPlan:
    """Geometry of one kernel launch: code words (``warps``) per block and
    the block's dynamic shared-memory ``smem`` bytes."""

    warps: int
    smem: int


def vit_plan(k: int, halo: int) -> VitPlan:
    """Launch plan of ``csrc/viterbi37.cu`` for K and a circular halo:
    ``WARPS`` words per block; shared memory per warp: the metric array,
    8 float32 branch-metric combinations per column (32·K) and two
    decision words per middle and flush step (8·(K + halo)). Raises
    ``ValueError`` out of range."""
    if not 0 < k <= MAX_K or not 0 <= halo <= k:
        raise ValueError(f"K={k}, halo={halo} out of range (K <= {MAX_K})")
    return VitPlan(WARPS, WARPS * (_METRIC_BYTES + 32 * k + 8 * (k + halo)))


def viterbi_regs_cuda(llr: torch.Tensor, halo: int) -> torch.Tensor:
    """llr [B, 3, K] float32 contiguous CUDA -> winner registers
    [B, ceil(K/32)] int32 (middle-copy decision t at bit k-1-t)."""
    if not llr.is_cuda:
        raise ValueError("viterbi_regs_cuda takes a CUDA tensor")
    if llr.dtype != torch.float32 or not llr.is_contiguous():
        raise ValueError("llr must be contiguous float32")
    if llr.dim() != 3 or llr.shape[1] != 3:
        raise ValueError(f"llr shape {tuple(llr.shape)}, want [B, 3, K]")
    b, _, k = llr.shape
    plan = vit_plan(k, halo)
    n_regs = (k - 1) // 32 + 1
    regs = torch.empty((b, n_regs), dtype=torch.int32, device=llr.device)
    if b == 0:
        return regs
    VITERBI37.launch(llr.device, (k, halo, b), llr.data_ptr(),
                     regs.data_ptr(), b, k, halo, n_regs, plan.warps,
                     plan.smem)
    return regs


def viterbi_decode_cuda(llr, train: int | None = TRAIN_LEN):
    """llr [..., 3, K] on the card -> bits [..., K] int8 (the kernel)."""
    *lead, _three, k = llr.shape
    x = llr.reshape(-1, 3, k).to(torch.float32).contiguous()
    halo = k if train is None else min(train, k)
    return unpack_regs(viterbi_regs_cuda(x, halo), k).reshape(*lead, k)
