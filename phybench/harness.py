"""One run of one cell: set-up, warm-up, the measured window (or the
traced calls), the check against the plain reference, and the result.

Everything a cell needs is found by name from ``BENCHMARK.json``: the
workload's ``config`` names ``phybench/configs/<config>.json``, whose
``driver`` names ``phybench/drivers/<driver>.py``; its ``traffic`` names
``phybench/traffic/<traffic>.json``; the limits of its compared numbers
are ``phybench/limits/<workload>.json``; each end-to-end metric is read
by ``phybench/end_to_end/<name>.py`` and each per-layer metric by
``phybench/metrics/<name>.py``.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import pathlib
import time

import torch

from .compare import judge

HERE = pathlib.Path(__file__).resolve().parent


class Spec:
    """``BENCHMARK.json`` and the files it names: the readers under
    ``root``, the configurations, traffic mixes and limits under ``data``
    (``root`` unless given)."""

    def __init__(self, bench: dict, root: pathlib.Path = HERE,
                 data: pathlib.Path | None = None):
        self.bench, self.root = bench, root
        self.data = data or root

    @classmethod
    def load(cls, path: pathlib.Path) -> "Spec":
        return cls(json.loads(path.read_text()))

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def limits(self, workload: str) -> dict:
        return self._json("limits", workload)

    def _json(self, folder: str, name: str) -> dict:
        return json.loads((self.data / folder / f"{name}.json").read_text())

    def metrics(self, section: str, workload: str, moves=None) -> list:
        """The ``section`` entries the workload reports: those that list
        it, or list no workloads (per-layer ones then only where the
        workload reports the end-to-end metric they move)."""
        out = []
        for m in self.bench[section]:
            if "workloads" in m:
                if workload in m["workloads"]:
                    out.append(m)
            elif moves is None or m["moves"] in moves:
                out.append(m)
        return out

    def reader(self, folder: str, name: str):
        """The module of ``phybench/<folder>/<name>.py`` (names may hold
        dots, so it is loaded from its path)."""
        path = self.root / folder / f"{name}.py"
        spec = importlib.util.spec_from_file_location(
            f"phybench_{folder}_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


class Window:
    """What a measured window saw: each call's host-clock seconds, the
    wall time from the first call's start to the last call's results on
    the host, the set-up seconds and the driver's totals."""

    def __init__(self, latencies, wall_s, setup_s, totals):
        self.latencies, self.wall_s = latencies, wall_s
        self.setup_s, self.totals = setup_s, totals


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def measure(drv, seconds: float) -> tuple:
    """Closed loop, one call in flight, pool entries in turn, until the
    window's length has passed: -> (latencies, wall_s)."""
    lat, i = [], 0
    first = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        res = drv.call(i % drv.n_calls)
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        drv.tally(i % drv.n_calls, res)
        i += 1
        if t1 - first >= seconds:
            return lat, t1 - first


def traced(drv, calls: int, device):
    """``calls`` calls under ``torch.profiler``: -> (Trace, iterations
    of each call)."""
    from torch.profiler import ProfilerActivity, profile

    from .tracing import Trace

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    its = []
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            res = drv.call(i % drv.n_calls)
            drv.tally(i % drv.n_calls, res)
            its.append(res["iterations"])
        _sync(device)
        wall = time.perf_counter() - t0
    return Trace(prof.events(), wall, calls), its


def run_cell(spec: Spec, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float) -> dict:
    """One run of ``workload``: -> the result's fields (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, ``breakdown``
    with ``trace``, and ``checks``) and ``log`` (lines for stderr)."""
    cell = spec.cell(workload)
    conf, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    driver = importlib.import_module(f"phybench.drivers.{conf['driver']}")
    t_import = time.perf_counter()
    drv = driver.Driver(conf, traffic, seed, device)
    cuda = torch.device(device).type == "cuda"
    _sync(device)
    t_inputs = time.perf_counter()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    for i in range(traffic["warmup_calls"]):
        drv.call(i % drv.n_calls)
    _sync(device)
    # what set-up left is not the window's garbage to collect
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    parts = (f"setup: imports {t_import - t_start} inputs "
             f"{t_inputs - t_import} warm-up {setup_s - (t_inputs - t_start)}")

    e2e = spec.metrics("end_to_end", workload)
    out: dict = {"metrics": {}}
    if trace:
        tr, its = traced(drv, traffic["trace_calls"], device)
        ctx = dict(driver=drv, conf=conf, traffic=traffic, iterations=its)
        for m in spec.metrics("per_layer", workload,
                              moves={e["name"] for e in e2e}):
            value = spec.reader("metrics", m["name"]).read(tr, ctx)
            if value is not None:
                out["metrics"][m["name"]] = {"value": value,
                                             "unit": m["unit"]}
        busy, window = tr.busy_s() if cuda else 0.0, tr.wall_s
        out["breakdown"] = tr.breakdown()
    else:
        lat, wall = measure(drv, seconds)
        thirds = [sorted(lat[i * len(lat) // 3:(i + 1) * len(lat) // 3])
                  for i in range(3)]
        parts += " window thirds' median ms " + " ".join(
            f"{t[len(t) // 2] * 1e3:.3f}" for t in thirds if t)
        win = Window(lat, wall, setup_s, drv.totals())
        for m in e2e:
            out["metrics"][m["name"]] = {
                "value": spec.reader("end_to_end", m["name"]).read(win),
                "unit": m["unit"]}
    _sync(device)
    gc.unfreeze()
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated()
                                 if cuda else 0)}
    if trace:
        dev["busy_s"], dev["window_s"] = busy, window

    totals = drv.totals()
    readings = drv.check()
    readings["wrong_tbs"] = totals["wrong"]
    readings.update(totals["counts"])
    ok, table = judge(readings, spec.limits(workload))
    iters = [it for e in drv.log for it in e[3]]
    log = [parts, f"calls {len(drv.log)} tbs {totals['attempted']} delivered "
           f"{totals['delivered']} turbo iterations min {min(iters)} max "
           f"{max(iters)} setup_s {setup_s}"]
    log += [f"{n} {v['value']} limit {v['limit']}" for n, v in table.items()]
    out.update(correct=ok, attempted=totals["attempted"],
               failed=totals["attempted"] - totals["delivered"], device=dev,
               checks=table, log=log)
    return out
