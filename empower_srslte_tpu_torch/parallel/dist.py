"""Multi-process (multi-host) meshes: the host axis.

Counterpart of the JAX package's ``parallel/dist.py``. The reference
scales past one machine by running one process per cell and wiring them
at the application layer (lib/src/radio/radio_multi.cc one PHY per
carrier; srsenb/srsepc as separate hosts over S1). Here a ``host`` mesh
axis goes in front of the single-process (carrier, sf) axes:
``torch.distributed`` forms the process group, every process contributes
its local devices, and the collectives along ``host`` cross processes
(``parallel/comm.py DistComm``: NCCL between cards, gloo through host
memory) while those along carrier and sf stay inside each process.

``empower_srslte_tpu_torch/tools/multihost_dryrun.py`` launches N OS
processes, builds the global (host, carrier, sf) mesh here and runs the
no-genie UE downlink chain and the trellis-sharded NII decode across
them.
"""

from __future__ import annotations

import numpy as np
import torch

from .mesh import Mesh, visible_devices


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None, backend: str | None = None
                     ) -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    ``coordinator_address``: ``"host:port"`` or ``"tcp://host:port"`` (a
    TCP store that process 0 serves) or ``"file:///path"`` (a file store
    every process can reach); ``num_processes`` and ``process_id`` are
    the world size and this process's rank. ``backend`` must be named:
    ``"nccl"`` (collectives on the cards, one card per process) or
    ``"gloo"`` (collectives through host memory). ``local_device_ids``:
    this process's CUDA cards; the first becomes the current device (NCCL
    needs it).
    """
    import torch.distributed as dist

    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: name 'nccl' or 'gloo'")
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("coordinator_address, num_processes and "
                         "process_id are required")
    init = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)


def make_global_mesh(carriers: int = 1, devices=None) -> Mesh:
    """Build the (host, carrier, sf) mesh over every process's devices.

    The ``host`` axis maps one to one onto the processes (row h is rank
    h's devices), so a collective over it crosses processes and one over
    carrier or sf stays within a process. ``devices``: this process's
    devices (default every visible card; raises without one); every
    process must contribute as many. Other processes' entries are None.
    """
    import torch.distributed as dist

    if not dist.is_initialized():
        raise RuntimeError("call init_distributed first")
    if devices is None:
        devices = visible_devices()
    devices = [torch.device(d) for d in devices]
    n_host, rank = dist.get_world_size(), dist.get_rank()
    counts = [None] * n_host
    dist.all_gather_object(counts, len(devices))
    if len(set(counts)) != 1:
        raise ValueError(f"processes contribute {counts} devices; the host "
                         f"axis needs the same number from each")
    per_host = len(devices)
    if per_host % carriers:
        raise ValueError(f"{per_host} devices per process over {carriers} "
                         f"carriers")
    arr = np.full((n_host, carriers, per_host // carriers), None,
                  dtype=object)
    arr[rank] = np.asarray(devices, dtype=object).reshape(
        carriers, per_host // carriers)
    return Mesh(arr, ("host", "carrier", "sf"), process_axis="host")
