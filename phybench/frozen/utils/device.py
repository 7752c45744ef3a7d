"""Device selection and per-device constant tables.

Every entry point that creates tensors takes ``device``: None means the
CUDA card, and raises when there is none — the port never drops to the
CPU unless the caller asks for it with ``device="cpu"``.
"""

from __future__ import annotations

import torch


_TABLES: dict = {}


def device_table(key, device: torch.device, build):
    """Host-built constant (numpy array from ``build()``) as a tensor on
    ``device``, cached per (key, device) so static index tables cross the
    host-device boundary once. A bare ``"cuda"`` is the current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    k = (key, str(device))
    t = _TABLES.get(k)
    if t is None:
        t = _TABLES[k] = torch.tensor(build(), device=device)
    return t
