"""64-state tail-biting Viterbi (K=7, rate 1/3): the CUDA kernel wrapper.

Counterpart of the JAX package's Pallas kernel ``viterbi_regs_pallas``
(empower_srslte_tpu/ops/fec/viterbi_pallas.py:146) and its host wrapper
``viterbi_decode_pallas`` (:171). The kernel (csrc/viterbi37.cu) runs the
same three-segment recursion as the plain twin
``convcoder.viterbi_decode_plain``: one block of 64 threads per code
word, one thread per trellis state, metrics and survivor registers
double-buffered in shared memory. It returns the winning state's
survivor registers; unpacking them to bits is a tensor op here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .convcoder import TRAIN_LEN, unpack_regs

#: kernel launches made by ``viterbi_decode_cuda`` (read by chip_smoke.py)
LAUNCHES = 0
#: largest K the kernel takes (its register file holds 8 words per state)
MAX_K = 256


@functools.lru_cache(maxsize=1)
def _lib():
    from ...utils.cuda_build import load

    fn = load("viterbi37").viterbi37_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def viterbi_regs_cuda(llr: torch.Tensor, halo: int) -> torch.Tensor:
    """llr [B, 3, K] float32 contiguous CUDA -> winner registers
    [B, ceil(K/32)] int32 (middle-copy decision t at bit k-1-t)."""
    global LAUNCHES
    if not llr.is_cuda:
        raise ValueError("viterbi_regs_cuda takes a CUDA tensor")
    if llr.dtype != torch.float32 or not llr.is_contiguous():
        raise ValueError("llr must be contiguous float32")
    if llr.dim() != 3 or llr.shape[1] != 3:
        raise ValueError(f"llr shape {tuple(llr.shape)}, want [B, 3, K]")
    b, _, k = llr.shape
    if not 0 < k <= MAX_K or not 0 <= halo <= k:
        raise ValueError(f"K={k}, halo={halo} out of range")
    n_regs = (k - 1) // 32 + 1
    regs = torch.empty((b, n_regs), dtype=torch.int32, device=llr.device)
    if b == 0:
        return regs
    rc = _lib()(llr.data_ptr(), regs.data_ptr(), b, k, halo, n_regs,
                torch.cuda.current_stream(llr.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"viterbi37 kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return regs


def viterbi_decode_cuda(llr, train: int | None = TRAIN_LEN):
    """llr [..., 3, K] on the card -> bits [..., K] int8 (the kernel)."""
    *lead, _three, k = llr.shape
    x = llr.reshape(-1, 3, k).to(torch.float32).contiguous()
    halo = k if train is None else min(train, k)
    return unpack_regs(viterbi_regs_cuda(x, halo), k).reshape(*lead, k)
