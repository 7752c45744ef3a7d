"""Collectives along one mesh axis: the port's ``ppermute``,
``all_gather``, ``psum`` and ``axis_index``.

A per-shard body runs in lockstep over the shards this process holds
(``Mesh.local()``): every collective takes and returns a dict from each
local coordinate to that shard's tensor. Two communicators implement the
same four operations, so one body serves both:

* ``LocalComm``: every shard of the axis lives in this process (JAX's
  single-process mesh over several devices). A ring shift is a rotation
  of the dict with ``.to(device)``, an all-gather a ``torch.cat``.
* ``DistComm``: the axis is the mesh's process axis, one position of it
  per process of a ``torch.distributed`` group (JAX's multi-process mesh,
  whose collectives cross DCN). A ring shift is ``batch_isend_irecv``
  point-to-point, the gather ``all_gather_into_tensor``, the sum
  ``all_reduce``. The backend fixes where a collective's tensors live:
  NCCL takes the card's tensors (a CPU tensor raises), gloo only host
  tensors, so under gloo each boundary slice or extrinsic chunk of a CUDA
  shard is copied to the host, exchanged, and copied back.

An axis of size 1 works as JAX's ``ppermute`` to self does: the shift
returns the shard's own tensor (``dist.send`` to one's own rank would
raise), the gather and the sum return it unchanged.
"""

from __future__ import annotations

import warnings

import torch


def each(fn, *dicts) -> dict:
    """``fn`` applied per coordinate of dicts sharing their keys."""
    return {c: fn(*(d[c] for d in dicts)) for c in dicts[0]}


class LocalComm:
    """Collectives along ``axis`` of ``mesh`` when this process holds all of
    its positions."""

    def __init__(self, mesh, axis: str):
        self.mesh = mesh
        self.ax = mesh.axis_index(axis)
        self.size = mesh.devices.shape[self.ax]
        if any(mesh.devices[c] is None for c in self._line(mesh.local()[0])):
            raise ValueError(f"axis {axis!r} has shards in other processes")

    def index(self, coord) -> int:
        """The shard's position along the axis (JAX's ``axis_index``)."""
        return coord[self.ax]

    def _line(self, coord) -> list:
        """The coordinates along the axis through ``coord``."""
        return [coord[:self.ax] + (j,) + coord[self.ax + 1:]
                for j in range(self.size)]

    def shift(self, xs: dict, step: int) -> dict:
        """Ring shift: position i receives the tensor of position i - step
        (``step`` +1 is JAX's ppermute i -> i + 1)."""
        return {c: xs[self._line(c)[(c[self.ax] - step) % self.size]]
                .to(self.mesh.devices[c]) for c in xs}

    def all_gather(self, xs: dict, dim: int = 0) -> dict:
        """Every position's tensor concatenated along ``dim``, in axis
        order, on each shard's device."""
        return {c: torch.cat([xs[p].to(self.mesh.devices[c])
                              for p in self._line(c)], dim) for c in xs}

    def psum(self, xs: dict) -> dict:
        """The sum over the axis, on each shard's device."""
        return {c: sum(xs[p].to(self.mesh.devices[c]) for p in self._line(c))
                for c in xs}


class DistComm:
    """Collectives along the mesh's process axis over the default
    ``torch.distributed`` group. This process holds one position of the
    axis, its rank; each local coordinate
    talks to the same coordinate in the other processes, every process
    walking its coordinates in the same order."""

    def __init__(self, mesh, axis: str):
        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("the process axis needs torch.distributed: "
                               "call parallel.init_distributed first")
        self.mesh = mesh
        self.ax = mesh.axis_index(axis)
        self.size = dist.get_world_size()
        self.rank = dist.get_rank()
        self.backend = str(dist.get_backend())
        if self.backend not in ("gloo", "nccl"):
            raise ValueError(f"backend {self.backend!r}: 'gloo' or 'nccl'")
        if self.size != mesh.devices.shape[self.ax]:
            raise ValueError(f"{self.size} processes for an axis of "
                             f"{mesh.devices.shape[self.ax]}")
        if any(c[self.ax] != self.rank for c in mesh.local()):
            raise ValueError(f"rank {self.rank} holds shards off its own "
                             f"position of axis {axis!r}")

    def index(self, coord) -> int:
        return coord[self.ax]

    def _wire(self, x: torch.Tensor) -> torch.Tensor:
        """The tensor as the backend takes it: the card's for NCCL (a host
        tensor raises), the host's for gloo (a CUDA tensor is copied)."""
        if self.backend == "nccl":
            if not x.is_cuda:
                raise ValueError(f"NCCL takes CUDA tensors, got {x.device}")
            return x.contiguous()
        return x.detach().to("cpu").contiguous()

    def shift(self, xs: dict, step: int) -> dict:
        import torch.distributed as dist

        if self.size == 1:
            return dict(xs)
        dst, src = ((self.rank + d) % self.size for d in (step, -step))
        out = {}
        for c, x in xs.items():
            send = self._wire(x)
            recv = torch.empty_like(send)
            ops = [dist.P2POp(dist.isend, send, dst),
                   dist.P2POp(dist.irecv, recv, src)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            out[c] = recv.to(x.device)
        return out

    def all_gather(self, xs: dict, dim: int = 0) -> dict:
        import torch.distributed as dist

        if self.size == 1:
            return dict(xs)
        out = {}
        for c, x in xs.items():
            send = self._wire(x.movedim(dim, 0))
            recv = send.new_empty((self.size * send.shape[0],
                                   *send.shape[1:]))
            with warnings.catch_warnings():
                # newer torch names it all_gather_single; the call is the same
                warnings.simplefilter("ignore", FutureWarning)
                dist.all_gather_into_tensor(recv, send)
            out[c] = recv.movedim(0, dim).to(x.device)
        return out

    def psum(self, xs: dict) -> dict:
        import torch.distributed as dist

        if self.size == 1:
            return dict(xs)
        out = {}
        for c, x in xs.items():
            t = self._wire(x).clone()
            dist.all_reduce(t)
            out[c] = t.to(x.device)
        return out


def psum(mesh, xs: dict, axes) -> dict:
    """The sum over several mesh axes (JAX's ``psum`` with a tuple of
    axis names), one axis after the other."""
    for axis in ((axes,) if isinstance(axes, str) else axes):
        xs = mesh.comm(axis).psum(xs)
    return xs
