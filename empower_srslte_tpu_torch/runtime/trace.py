"""Tracing/profiling and intermediate-signal dumps.

Capability parity with the reference's observability hooks: per-stage
timing (the tests' Mbps printers, turbodecoder_test.c:264-281),
``torch.profiler`` traces for kernel-level inspection, and
srslte_ue_dl_save_signal-style dumps of every intermediate buffer for
offline analysis (ue_dl.c:958).
"""

from __future__ import annotations

import contextlib
import pathlib
import time

import numpy as np
import torch


@contextlib.contextmanager
def stage_timer(name: str, log=None, sync=None):
    """Time a pipeline stage; ``sync`` is called before stopping the clock
    (pass ``torch.cuda.synchronize``, or a read of the stage's output, to
    wait for the card's queued work)."""
    t0 = time.perf_counter()
    yield
    if sync is not None:
        sync()
    dt = time.perf_counter() - t0
    msg = f"{name}: {dt*1e3:.2f} ms"
    (log.info if log else print)(msg)


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
