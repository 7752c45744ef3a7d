"""Tracing/profiling and intermediate-signal dumps.

Capability parity with the reference's observability hooks: program
ranges and first-use counters for ``torch.profiler`` traces, and
srslte_ue_dl_save_signal-style dumps of every intermediate buffer for
offline analysis (ue_dl.c:958).

Tracing is on while ``torch.profiler`` records, or between ``enable()``
and ``disable()``. Then ``span(name)`` opens a ``record_function`` range
(``layer.stage``, on the trace's timeline with the kernels launched in
it), and the counter registry counts first-use events by kind:

* ``table_build``: a ``utils.device.device_table`` miss (range
  ``runtime.table_build``);
* ``kernel_load``: a ``utils.cuda_build.load`` miss (range
  ``runtime.kernel_load``);
* ``alloc_segment``: the caching allocator's new device segments over a
  ``root`` range;
* ``cufft_plan``: the cuFFT plan cache's growth over a ``root`` range;
* ``gc_gen2``: a full garbage collection (every collection while tracing
  runs in a ``runtime.gc`` range).

Apart from those, which a steady state leaves at 0, the launch registry
counts every launch of a hand-written kernel, tracing or not, by kernel
and launch shape: ``utils.cuda_build.Kernel.launch`` calls
``count_launch``, and ``launch_counts()`` (launches by kernel) and
``launch_shapes(kernel)`` (launches by shape) read it. The kernels and
their shapes: ``turbo_nii`` / ``turbo_nii_bf16`` (K, window, code
blocks, dtype name, first, last), ``turbo_win`` / ``turbo_win_bf16`` (K,
window, code blocks, dtype name), ``viterbi37`` (K, halo, code words),
``chest_dl`` (grids, ports, PRB), ``ctrl_llr`` (subframes, ports,
region REs), ``pdcch_blind`` (DCI sizes, candidates, subframes),
``turbo_enc`` (K, code blocks),
``recursion_f32`` / ``recursion_bf16`` / ``recursion_i8`` (words per
state, steps). ``reset()`` clears both registries. A CUDA graph's capture
(``runtime.graphs``) records launches without making them: it counts
them aside (``launches_aside``), and each replay counts them
(``count_launches``).

Tracing off, ``span`` and ``root`` check one flag and return a shared
empty context manager, and no first use is counted.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import pathlib

import numpy as np
import torch
from torch.autograd import profiler as _profiler

_enabled = False
_OFF = contextlib.nullcontext()
_COUNTS: collections.Counter = collections.Counter()
_LAUNCH_REGISTRY: collections.Counter = collections.Counter()
#: counters that take launches in the registry's place, innermost last
_ASIDE: list = []


def enable() -> None:
    """Trace without the profiler: spans and counters on."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def tracing() -> bool:
    """True while ``torch.profiler`` records or after ``enable()``."""
    return _enabled or _profiler._is_profiler_enabled


def span(name: str):
    """A ``record_function`` range named ``name`` while tracing, else a
    shared empty context manager (the test is ``tracing()`` inlined: this
    runs at every stage of every call)."""
    if _enabled or _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


def count(kind: str, n: int = 1) -> None:
    """Count ``n`` events of ``kind`` while tracing."""
    if tracing():
        _COUNTS[kind] += n


def counts() -> dict:
    """A snapshot of the counters: {kind: events}."""
    return dict(_COUNTS)


def count_launch(kernel: str, shape) -> None:
    """Count one launch of the hand-written kernel ``kernel`` at
    ``shape``, tracing or not (kept out of ``counts()``, which holds first
    uses alone)."""
    (_ASIDE[-1] if _ASIDE else _LAUNCH_REGISTRY)[kernel, shape] += 1


@contextlib.contextmanager
def launches_aside():
    """Within, launches are counted in the yielded Counter ({(kernel,
    shape): launches}) and not in the registry."""
    aside: collections.Counter = collections.Counter()
    _ASIDE.append(aside)
    try:
        yield aside
    finally:
        _ASIDE.pop()


def count_launches(launches: collections.Counter) -> None:
    """Count ``launches`` ({(kernel, shape): launches}) in the registry."""
    _LAUNCH_REGISTRY.update(launches)


def launch_counts() -> dict:
    """A snapshot of the launch registry: {kernel: launches}."""
    out: collections.Counter = collections.Counter()
    for (kernel, _shape), n in _LAUNCH_REGISTRY.items():
        out[kernel] += n
    return dict(out)


def launch_shapes(kernel: str) -> dict:
    """A snapshot of one kernel's launches: {shape: launches}."""
    return {shape: n for (k, shape), n in _LAUNCH_REGISTRY.items()
            if k == kernel}


def reset() -> None:
    _COUNTS.clear()
    _LAUNCH_REGISTRY.clear()


def _device_counters(device: torch.device) -> tuple:
    """(device segments allocated so far, cuFFT plans cached) on a CUDA
    ``device``."""
    stats = torch.cuda.memory_stats(device)
    plans = torch.backends.cuda.cufft_plan_cache[device.index].size
    return stats.get("segment.all.allocated", 0), plans


class _Root:
    """A span around a whole receiver call that also counts the call's
    new allocator segments and cuFFT plans. The two counters are read
    before the range opens and after it closes, so that reading them
    enters no range's host time."""

    __slots__ = ("name", "device", "rec", "before")

    def __init__(self, name: str, device: torch.device):
        self.name, self.device = name, device

    def __enter__(self):
        self.before = _device_counters(self.device)
        self.rec = _profiler.record_function(self.name)
        self.rec.__enter__()
        return self

    def __exit__(self, *exc):
        self.rec.__exit__(*exc)
        after = _device_counters(self.device)
        for kind, b, a in zip(("alloc_segment", "cufft_plan"), self.before,
                              after):
            if a > b:
                _COUNTS[kind] += a - b


def root(name: str, device):
    """``span(name)`` for a receiver's whole call on ``device``; on a
    CUDA device it also counts ``alloc_segment`` and ``cufft_plan``."""
    if not tracing():
        return _OFF
    device = torch.device(device)
    if device.type != "cuda":
        return _profiler.record_function(name)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _Root(name, device)


_gc_open: list = []


def _on_gc(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a ``runtime.gc`` range over each collection
    that starts while tracing, and a ``gc_gen2`` count for a full one."""
    if phase == "start":
        if tracing():
            rec = _profiler.record_function("runtime.gc")
            rec.__enter__()
            _gc_open.append(rec)
            if info.get("generation") == 2:
                _COUNTS["gc_gen2"] += 1
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


gc.callbacks.append(_on_gc)


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """``torch.profiler`` trace around a region, over the CPU and, where
    there is a CUDA card, the card; written as a Chrome trace
    (``trace.json``, view in Perfetto or chrome://tracing) into
    ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = pathlib.Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(str(out / "trace.json"))


class SignalDump:
    """Collect named intermediate buffers and save one .npz
    (srslte_ue_dl_save_signal analog — the reference dumps every stage's
    buffer for offline MATLAB inspection)."""

    def __init__(self):
        self._bufs: dict[str, np.ndarray] = {}

    def add(self, name: str, array) -> None:
        if isinstance(array, torch.Tensor):
            array = array.detach().cpu().numpy()
        self._bufs[name] = np.asarray(array)

    def save(self, path: str) -> None:
        np.savez_compressed(path, **self._bufs)

    def __len__(self) -> int:
        return len(self._bufs)


def load_dump(path: str) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
