"""Fixed-shape stages of a receiver call replayed from CUDA graphs.

A batched receiver call on the card launches a few hundred kernels, most
of them small, and the card waits on the host to launch them. ``Stages``
runs a call's fixed-shape stages, those without a host read inside: on
its first call each stage runs once on a side stream (which builds its
tables, plans and kernels), is captured as a CUDA graph and replayed; on
later calls each stage is one replay. Every stage runs in its program range
(``trace.span``), as its eager code did, so a traced call gives the
graph's kernels to that range; and each replay counts in the launch
registry the hand-written kernels its capture recorded.

A stage's tensor arguments that an earlier stage of the chain returned,
or views of them, are read where they lie; any other is copied, on every
call, into a buffer on the chain's device taken at the capture (a host
tensor from pinned memory, with no wait). Its other arguments must be
those of the capture. Its results are the graph's own buffers, which the
next call overwrites: a caller that keeps one past the call takes
``keep(result)``, a copy.
``EAGER`` runs the same stages as they are (the CPU, and every caller
without a chain).
"""

from __future__ import annotations

import torch

from . import trace


def _tensors(args, kwargs) -> list:
    return [a for a in (*args, *kwargs.values())
            if isinstance(a, torch.Tensor)]


def _flat(x) -> list:
    """The tensors of a stage's result: a tensor, or tuples and lists of
    them."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return []


class Eager:
    """Each stage run as it is, in its range."""

    def __call__(self, name: str, fn, *args, **kwargs):
        with trace.span(name):
            return fn(*args, **kwargs)

    @staticmethod
    def keep(result: torch.Tensor) -> torch.Tensor:
        """A stage's result that the caller keeps past the call."""
        return result


EAGER = Eager()


class Stages:
    """A chain of stages on one CUDA device (``device``, or by default its
    first stage's first tensor argument's), captured on its first call
    and replayed on the later ones. ``start()`` begins a call; each stage
    is then ``stages(name, fn, *args, **kwargs)``, in the capture's
    order."""

    def __init__(self, device=None):
        self._device = device
        #: per stage: (name, replay, static tensor arguments, result,
        #: launches of hand-written kernels)
        self._graphs: list = []
        #: the storages of the chain's results
        self._owned: set = set()
        self._pool = None
        self._pos = 0

    def start(self) -> "Stages":
        self._pos = 0
        return self

    @staticmethod
    def keep(result: torch.Tensor) -> torch.Tensor:
        """A stage's result that the caller keeps past the call: a copy,
        since the next call overwrites the graph's buffer."""
        return result.clone()

    def __call__(self, name: str, fn, *args, **kwargs):
        with trace.span(name):
            if self._pos == len(self._graphs):
                self._capture(name, fn, args, kwargs)
            stage, replay, static, result, launches = self._graphs[self._pos]
            if stage != name:
                raise RuntimeError(f"stage {name!r} where the chain has "
                                   f"{stage!r}")
            self._pos += 1
            for s, a in zip(static, _tensors(args, kwargs)):
                if a.shape != s.shape:
                    raise ValueError(f"stage {name!r}: an argument of shape "
                                     f"{tuple(a.shape)} where the chain "
                                     f"captured {tuple(s.shape)}")
                if a.device != s.device:
                    s.copy_(a, non_blocking=True)
                elif a.data_ptr() != s.data_ptr() or a.stride() != s.stride():
                    s.copy_(a)
            replay()
            trace.count_launches(launches)
            return result

    def _capture(self, name: str, fn, args, kwargs) -> None:
        tensors = _tensors(args, kwargs)
        if self._device is None:
            self._device = tensors[0].device
        static = [a if a.untyped_storage().data_ptr() in self._owned
                  else a.to(self._device, copy=True) for a in tensors]
        it = iter(static)
        args = [next(it) if isinstance(a, torch.Tensor) else a for a in args]
        kwargs = {k: next(it) if isinstance(v, torch.Tensor) else v
                  for k, v in kwargs.items()}
        replay, result, launches = self._record(self._device, fn, args,
                                                kwargs)
        self._owned.update(t.untyped_storage().data_ptr()
                           for t in _flat(result))
        self._graphs.append((name, replay, static, result, launches))

    def _record(self, device, fn, args, kwargs) -> tuple:
        """One run of ``fn`` on a side stream, then its capture: ->
        (the graph's replay, its result, the launches of hand-written
        kernels the capture recorded)."""
        with torch.cuda.device(device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                fn(*args, **kwargs)
            main.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with trace.launches_aside() as launches, \
                    torch.cuda.graph(graph, pool=self._pool):
                result = fn(*args, **kwargs)
        self._pool = graph.pool()
        return graph.replay, result, launches
