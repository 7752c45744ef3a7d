"""Device selection, per-device constant tables and the card's limits.

Every entry point that creates tensors takes ``device``: None means the
CUDA card, and raises when there is none — the port never drops to the
CPU unless the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..runtime import trace

#: shared memory one block may use on sm_90 (227 KB)
MAX_SMEM = 232_448
#: SMs of an NVIDIA H100 SXM: the launch plans' card where none is given
H100_SMS = 132


def resolve_device(device=None) -> torch.device:
    """None -> the current CUDA device (raises without one); else as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: pass device='cpu' to run on "
                "the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def as_samples(samples, device=None) -> torch.Tensor:
    """A capture as complex64 samples: a tensor keeps its device; anything
    else (a numpy capture) goes to ``resolve_device(device)``."""
    if isinstance(samples, torch.Tensor):
        return samples.to(torch.complex64)
    return torch.as_tensor(np.asarray(samples, np.complex64),
                           device=resolve_device(device))


def host_ints(rows, device) -> torch.Tensor:
    """A call's few integers, ``rows`` of 3, as int32 [len(rows), 3] on
    the host, pinned where ``device`` is a card, so that a copy to it
    (``non_blocking``) needs no wait: a copy from pageable memory waits
    for the card's queue. Made from NumPy, with no op of its own."""
    t = torch.from_numpy(np.asarray(list(rows), np.int32).reshape(-1, 3))
    return t.pin_memory() if torch.device(device).type == "cuda" else t


_TABLES: dict = {}


def device_table(key, device: torch.device, build):
    """Host-built constant (numpy array from ``build()``) as a tensor on
    ``device``, cached per (key, device) so static index tables cross the
    host-device boundary once. A bare ``"cuda"`` is the current card. A
    miss (the build and its copy to the card) runs in the range
    ``runtime.table_build`` and counts one ``table_build``."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    k = (key, str(device))
    t = _TABLES.get(k)
    if t is None:
        with trace.span("runtime.table_build"):
            t = _TABLES[k] = torch.tensor(build(), device=device)
        trace.count("table_build")
    return t


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """SMs of a CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def aligned4(*xs) -> bool:
    """Every tensor's data starts on a 4-byte boundary (a bfloat16 pair
    is then one aligned word)."""
    return all(x is None or x.data_ptr() % 4 == 0 for x in xs)
