"""Readings that the limits of ``phybench/limits/<workload>.json`` are
set from.

    python3 -m phybench.calibrate --workload NAME --seeds 1,2,3 [--control]

For each seed, in one process: the cell's inputs and the port's plans at
the cell's own size, the warm-up calls, one call on each check entry (a
short window at the cell's own load), then the check. Prints one JSON
line a seed: the port's readings against the plain reference and, with
``--control``, the control's (the reference at the precision below the
configuration's, in the port's place), each with the verdict of the
cell's limits on it. The lower reading of a number is
the largest the port gives over a dozen seeds or more; the upper is the
smallest the control gives.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys

import torch

from .compare import judge
from .harness import Spec


def readings(spec: Spec, workload: str, seed: int, device,
             control: bool) -> dict:
    cell = spec.cell(workload)
    conf, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    driver = importlib.import_module(f"phybench.drivers.{conf['driver']}")
    drv = driver.Driver(conf, traffic, seed, device)
    for i in range(traffic["warmup_calls"]):
        drv.call(i % drv.n_calls)
    for j in drv.check_entries:
        drv.tally(j, drv.call(j))
    totals = drv.totals()
    window = dict(wrong_tbs=totals["wrong"], **totals["counts"])
    limits = spec.limits(workload)
    port = dict(drv.check(), **window)
    out = {"seed": seed, "port": port, "port_correct": judge(port, limits)[0],
           "iterations": sorted({it for e in drv.log for it in e[3]}),
           "failed": totals["attempted"] - totals["delivered"]}
    if control:
        # the control in the port's place; the window's counts are the
        # port's own calls'
        ctl = dict(drv.check(lower=True), **window)
        out["control"] = ctl
        out["control_correct"] = judge(ctl, limits)[0]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phybench.calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    root = pathlib.Path(__file__).resolve().parent.parent
    spec = Spec.load(root / "BENCHMARK.json")
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(spec, args.workload, seed, "cuda",
                                  args.control)), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
