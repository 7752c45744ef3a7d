"""The benchmark's command.

    python3 -m phybench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout. One run is one process: set-up (import, the
card, the inputs drawn from the seed on the card, the port's plans and
kernel builds, the warm-up calls), then the measured window of
``--seconds`` (or, with ``--trace 1``, a fixed number of calls under
``torch.profiler``), then the check of replayed calls against the plain
reference. The last line of standard output is one JSON object; the last
lines of standard error are each compared number beside its limit.

Exits 2 without a result when there is no CUDA card or fewer cards than
the cell asks for, and 3 when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: the fixed cache directories, inside the checkout
CACHE = ROOT / ".phybench_cache"
#: top-level module names no run may load
FORBIDDEN = ("jax", "jaxlib", "flax", "empower_srslte_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is forbidden."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for name, var in (("triton", "TRITON_CACHE_DIR"),
                      ("torch_kernels", "PYTORCH_KERNEL_CACHE_PATH")):
        (CACHE / name).mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(CACHE / name)

    import torch

    from .harness import Spec, run_cell

    spec = Spec.load(ROOT / "BENCHMARK.json")
    chips = spec.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"phybench: needs {chips} CUDA card(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = run_cell(spec, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"phybench: loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    log = out.pop("log")
    checks = out.pop("checks")
    result = {k: out[k] for k in ("correct", "attempted", "failed",
                                  "metrics", "device")}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["device"]["card"] = card()
    result["checks"] = checks
    print(f"card {result['device']['card']}", file=sys.stderr)
    for line in log:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
