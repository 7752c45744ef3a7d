"""Recursion-rate probe: float32 vs bfloat16 vs int8 add/max chains.

    python3 -m empower_srslte_tpu_torch.tools.microbench_recursion [steps] [lanes]

Counterpart of the JAX package's tool ``tools/microbench_vpu.py``, whose
Pallas kernel (``bench`` -> ``pl.pallas_call(make_kernel(...))``, :55)
measured how fast the TPU runs the turbo decoder's inner loop in each
metric type. The recursion is 8 parallel states, serial across steps:
per step ``out[s] = max(m[s] + x[(s+1)%8], m[(s+3)%8] + x[s])``, then
``m = out - max(out)``, starting from ``m = x``.

``recursion_probe`` launches the hand-written kernel
(csrc/recursion_probe.cu) on a CUDA tensor and runs ``recursion_plain``,
the same recursion in torch, on a CPU tensor. The tool runs the kernel on
a shape that fills the card — [8, sub, lanes] with sub 8 (float32), 16
(bfloat16) or 32 (int8), as the JAX tool's tiles, and ``lanes`` wide —
and prints its time and rate per type, counting 39 operations per
element and step (microbench_vpu.py:68-69). Needs a CUDA card unless
given ``device="cpu"``.
"""

from __future__ import annotations

import ctypes
import json
import sys

import numpy as np
import torch

from ..utils.cuda_build import Kernel
from ..utils.device import resolve_device


def _kernel(symbol: str) -> Kernel:
    """A type's launcher: x, out, words per state, steps. A launch's shape
    in the launch registry is (words per state, steps)."""
    return Kernel("recursion_probe", symbol,
                  [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int])


#: (name, torch dtype, sub, launcher, elements per packed word)
TYPES = (("f32", torch.float32, 8, _kernel("recursion_f32_launch"), 1),
         ("bf16", torch.bfloat16, 16, _kernel("recursion_bf16_launch"), 2),
         ("int8", torch.int8, 32, _kernel("recursion_i8_launch"), 4))
#: operations per element and step: 8 x (2 adds + 1 max) + 7 maxes + 8 subs
OPS_PER_STEP = 8 * 3 + 15
DEFAULT_STEPS = 4096
#: 131072 lanes give every type 2^20 threads: about 7900 per SM of an H100
DEFAULT_LANES = 131072


def recursion_plain(x: torch.Tensor, steps: int) -> torch.Tensor:
    """The recursion in torch: x [8, ...] -> m [8, ...], same dtype (every
    op rounded to it; int8 wraps around)."""
    xs = list(x)
    ms = list(xs)
    for _ in range(steps):
        out = [torch.maximum(ms[s] + xs[(s + 1) % 8], ms[(s + 3) % 8] + xs[s])
               for s in range(8)]
        m = out[0]
        for v in out[1:]:
            m = torch.maximum(m, v)
        ms = [v - m for v in out]
    return torch.stack(ms)


def recursion_probe(x: torch.Tensor, steps: int) -> torch.Tensor:
    """x [8, ...] float32/bfloat16/int8 -> m [8, ...]: the kernel on a
    CUDA tensor, ``recursion_plain`` on a CPU tensor."""
    if not x.is_cuda:
        return recursion_plain(x, steps)
    kind = next((t for t in TYPES if t[1] == x.dtype), None)
    if kind is None:
        raise TypeError(f"dtype {x.dtype}: float32, bfloat16 or int8")
    _, _, _, kernel, pack = kind
    if x.shape[0] != 8 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous [8, ...], got "
                         f"{tuple(x.shape)}")
    per_state = x[0].numel()
    if per_state % pack:
        raise ValueError(f"{per_state} elements per state: not a multiple "
                         f"of {pack}")
    out = torch.empty_like(x)
    words = per_state // pack
    kernel.launch(x.device, (words, steps), x.data_ptr(), out.data_ptr(),
                  words, steps)
    return out


def probe_input(name: str, lanes: int, device=None, seed: int = 0):
    """The JAX tool's inputs at [8, sub, lanes]: int8 uniform in [-4, 4),
    else N(0, 0.1^2) rounded to the type."""
    _, dtype, sub, _, _ = next(t for t in TYPES if t[0] == name)
    rng = np.random.default_rng(seed)
    shape = (8, sub, lanes)
    if dtype == torch.int8:
        x = rng.integers(-4, 4, size=shape).astype(np.int8)
    else:
        x = (rng.normal(size=shape) * 0.1).astype(np.float32)
    return torch.as_tensor(x, device=resolve_device(device)).to(dtype)


def run(steps: int = DEFAULT_STEPS, lanes: int = DEFAULT_LANES,
        device=None) -> list[dict]:
    """Time the kernel per type (CUDA events, mean of 3 launches after a
    warm-up). Returns one dict per type: ms, Tops/s (None on the CPU)."""
    dev = resolve_device(device)
    out = []
    for name, _dtype, sub, _, _ in TYPES:
        x = probe_input(name, lanes, dev)
        recursion_probe(x, steps)                          # warm-up
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(3):
                recursion_probe(x, steps)
            e1.record()
            torch.cuda.synchronize(dev)
            ms = e0.elapsed_time(e1) / 3
        else:
            ms = None                     # no device time on the CPU
        ops = steps * OPS_PER_STEP * sub * lanes
        out.append({"type": name, "sub": sub, "lanes": lanes,
                    "steps": steps, "ms": ms, "ops": ops,
                    "tops": None if ms is None else ops / (ms * 1e-3) / 1e12})
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    steps = int(argv[0]) if len(argv) > 0 else DEFAULT_STEPS
    lanes = int(argv[1]) if len(argv) > 1 else DEFAULT_LANES
    rows = run(steps, lanes)
    print(torch.cuda.get_device_name(0))
    for r in rows:
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
