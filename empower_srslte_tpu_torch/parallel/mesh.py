"""Device meshes, batch sharding and the per-shard map.

Counterpart of the JAX package's ``parallel/mesh.py``. Axes:
  carrier — component carriers / cells (reference analog: one process per
            cell, lib/src/radio/radio_multi.cc; eMBMS multi-cell pmch.c)
  sf      — subframe batch (reference analog: the PHY worker pipeline,
            lib/include/srslte/common/thread_pool.h:46)
  host    — processes (``dist.make_global_mesh``), ahead of the two

A ``Mesh`` is an array of ``torch.device``s with named axes. Several of
its shards may share one device: a mesh larger than the visible cards is
built only from a ``devices`` list the caller passes (``[cuda:0] * 4``,
``["cpu"] * 8``), never by padding. In a mesh that spans processes the
entries another process owns are None, and its ``process_axis`` names
the axis whose collectives cross processes (``parallel/comm.py``).

JAX's ``shard_map`` has its counterpart in ``smap``: the function runs
once per shard this process holds, in turn, and its per-shard results
gather back into one tensor (``Sharded.gather``). A per-shard body that
talks to its neighbours runs in lockstep over the shards instead, with
the communicators of ``parallel/comm.py`` (``parallel/turbo_sp.py``).
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch


class Mesh:
    """Devices [*shape] with ``axis_names``; ``shape`` maps each axis name
    to its size, as JAX's ``Mesh.shape`` does. ``process_axis`` (or None)
    is the axis that maps one to one onto the processes of the default
    ``torch.distributed`` group."""

    def __init__(self, devices, axis_names, process_axis: str | None = None):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            arr[idx] = None if src[idx] is None else torch.device(src[idx])
        if arr.ndim != len(axis_names):
            raise ValueError(f"devices of shape {arr.shape} for axes "
                             f"{tuple(axis_names)}")
        if process_axis is not None and process_axis not in axis_names:
            raise ValueError(f"process axis {process_axis!r} not in "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.process_axis = process_axis

    def local(self) -> list:
        """The coordinates of the shards this process holds, in C order
        (the same order in every process)."""
        return [c for c in np.ndindex(self.devices.shape)
                if self.devices[c] is not None]

    def axis_index(self, axis: str) -> int:
        return self.axis_names.index(axis)

    def comm(self, axis: str):
        """The communicator of ``axis`` (``parallel/comm.py``): across
        processes for the process axis, within this process otherwise."""
        from .comm import DistComm, LocalComm

        if axis == self.process_axis:
            return DistComm(self, axis)
        return LocalComm(self, axis)


def visible_devices() -> list:
    """Every visible CUDA card; raises when there is none (the port never
    falls back to the CPU unless the caller passes CPU devices)."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available: pass devices=[...] "
                           "(e.g. ['cpu'] * n) to build a mesh without one")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(n_devices: int | None = None, carriers: int | None = None,
              devices=None, hosts: int | None = None) -> Mesh:
    """Build a (carrier, sf) mesh over the given devices, or every visible
    card when ``devices`` is None (raises without one).

    ``carriers`` defaults to the largest power of two <= sqrt(n) so both
    axes are populated when possible. ``hosts`` prepends a host axis
    (single-process shape parity with the multi-process mesh of
    ``dist.make_global_mesh``, which maps that axis onto processes).
    A mesh of more shards than ``devices`` raises: pass a longer list
    (repeats allowed) instead.
    """
    if devices is None:
        devices = visible_devices()
    if n_devices is None:
        n_devices = len(devices)
    if n_devices > len(devices):
        raise ValueError(f"a mesh of {n_devices} shards over {len(devices)} "
                         f"devices: pass a devices list of {n_devices}")
    devices = np.asarray([torch.device(d) for d in devices[:n_devices]],
                         dtype=object)
    if hosts:
        if n_devices % hosts:
            raise ValueError(f"{n_devices} devices over {hosts} hosts")
        per = n_devices // hosts
        carriers = carriers or 1
        if per % carriers:
            raise ValueError(f"{per} devices per host over {carriers} "
                             f"carriers")
        return Mesh(devices.reshape(hosts, carriers, per // carriers),
                    ("host", "carrier", "sf"))
    if carriers is None:
        carriers = 1
        while carriers * 2 * carriers * 2 <= n_devices:
            carriers *= 2
        while n_devices % carriers:
            carriers //= 2
    if n_devices % carriers:
        raise ValueError(f"{n_devices} devices over {carriers} carriers")
    return Mesh(devices.reshape(carriers, n_devices // carriers),
                ("carrier", "sf"))


@dataclass(frozen=True)
class Sharding:
    """How a tensor lies on a mesh: ``spec`` gives, per tensor dim, None
    (whole), an axis name, or a tuple of axis names (the dim split over
    their product, the last fastest), as JAX's ``PartitionSpec``. Axes the
    spec does not name replicate the tensor."""

    mesh: Mesh
    spec: tuple

    def _dims(self) -> list:
        """Per tensor dim named by the spec: the mesh axis indices it is
        split over."""
        names = set()
        out = []
        for entry in self.spec:
            axes = () if entry is None else (
                (entry,) if isinstance(entry, str) else tuple(entry))
            for a in axes:
                if a in names:
                    raise ValueError(f"axis {a!r} twice in {self.spec}")
                names.add(a)
            out.append([self.mesh.axis_index(a) for a in axes])
        return out

    def parts(self, ndim: int) -> list:
        """Per dim of an ``ndim`` tensor: the blocks it is split into."""
        dims = self._dims()
        if len(dims) > ndim:
            raise ValueError(f"spec {self.spec} for a tensor of {ndim} dims")
        size = self.mesh.devices.shape
        return [int(np.prod([size[a] for a in dims[d]])) if d < len(dims)
                else 1 for d in range(ndim)]

    def block(self, shape, coord) -> tuple:
        """The slices of a tensor of ``shape`` that shard ``coord`` holds."""
        dims, size = self._dims(), self.mesh.devices.shape
        sl = []
        for d, (n, parts) in enumerate(zip(shape, self.parts(len(shape)))):
            if n % parts:
                raise ValueError(f"dim {d} of {tuple(shape)} does not split "
                                 f"into {parts}")
            idx = 0
            for a in dims[d] if d < len(dims) else ():
                idx = idx * size[a] + coord[a]
            sl.append(slice(idx * (n // parts), (idx + 1) * (n // parts)))
        return tuple(sl)

    def place(self, x: torch.Tensor) -> "Sharded":
        """Each local shard's block of ``x`` on its device (the
        counterpart of ``jax.device_put`` with a NamedSharding). Every
        process passes the whole ``x``, as JAX's
        ``make_array_from_callback`` reads it."""
        return Sharded(self, {c: x[self.block(x.shape, c)].to(
            self.mesh.devices[c]).contiguous() for c in self.mesh.local()},
            tuple(x.shape))


@dataclass
class Sharded:
    """A tensor of global ``shape`` laid out by ``sharding``: ``shards``
    maps each local coordinate to its block, on its device."""

    sharding: Sharding
    shards: dict
    shape: tuple

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor, on ``device`` (default the first shard's).
        Needs every block in this process."""
        first = next(iter(self.shards.values()))
        out = torch.empty(self.shape, dtype=first.dtype,
                          device=device or first.device)
        blocks = set()
        for c, x in self.shards.items():
            sl = self.sharding.block(self.shape, c)
            out[sl] = x.to(out.device)
            blocks.add(tuple((b.start, b.stop) for b in sl))
        if len(blocks) != np.prod(self.sharding.parts(len(self.shape))):
            raise ValueError("gather needs every block: some shards live in "
                             "other processes")
        return out


def batch_sharding(mesh: Mesh, ndim: int, carrier_dim: int = 0,
                   sf_dim: int = 1) -> Sharding:
    """Leading [carrier, sf, ...] dims of an ``ndim`` tensor over the
    mesh's carrier and sf axes."""
    spec = [None] * ndim
    spec[carrier_dim] = "carrier"
    spec[sf_dim] = "sf"
    return Sharding(mesh, tuple(spec))


def shard_batch(mesh: Mesh, x: torch.Tensor, carrier_dim: int = 0,
                sf_dim: int = 1) -> Sharded:
    """Place a tensor with leading [carrier, sf, ...] dims onto the mesh."""
    return batch_sharding(mesh, x.ndim, carrier_dim, sf_dim).place(x)


def _on_device(device: torch.device):
    """The context that makes ``device`` the current CUDA device (a no-op
    for a CPU one), so that what a body allocates on ``"cuda"`` lands on
    its shard's card."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def smap(fn, *args, out_specs=None):
    """``fn`` once per local shard, in turn, with the shard's card the
    current device: a ``Sharded`` argument gives each call its own block,
    any other argument goes to every call as it is (replicated).
    -> {coordinate: result}, or with ``out_specs`` (the spec of a tensor
    result) the results as a ``Sharded``."""
    sharded = [a for a in args if isinstance(a, Sharded)]
    if not sharded:
        raise ValueError("smap needs at least one Sharded argument")
    mesh = sharded[0].sharding.mesh
    out = {}
    for c in mesh.local():
        with _on_device(mesh.devices[c]):
            out[c] = fn(*(a.shards[c] if isinstance(a, Sharded) else a
                          for a in args))
    if out_specs is None:
        return out
    sharding = Sharding(mesh, tuple(out_specs))
    block = next(iter(out.values())).shape
    return Sharded(sharding, out, tuple(
        n * p for n, p in zip(block, sharding.parts(len(block)))))

