"""Turbo-code BLER vs Eb/N0 sweep on the port: float32 against bfloat16.

    python3 -m empower_srslte_tpu_torch.tools.bler_sweep [--k K]
        [--cbs N] [--points dB,dB,...] [--seed S] [--cpu]

Counterpart of the JAX package's ``tools/bler_sweep.py``, on its grid:
K 1024, rate 1/3, 6 iterations without early stop, window 128 (64 when K
is not a multiple of 128), float32 LLRs and the int8 lane's (demod byte
scale 8 per LLR unit, saturated to +-127), at Eb/N0 0.0, 0.4, 0.8, 1.0,
1.2, 1.6 and 2.0 dB, plus 0.1 dB steps from 0.6 to 1.4 dB. It decodes
every point with both kernel decoders (``"nii"``, ``"windowed"``) at
both metric precisions (``"float32"``, ``"bfloat16"``): 8 curves on the
same code blocks and noise, ``--cbs`` (default 8192) code blocks per
point. It prints each curve's BLER and BER, then one JSON object with
the curves and ``gate``'s verdict: each bfloat16 curve within 0.1 dB of
its float32 curve, and every curve at or below srsLTE's own decoder
(0.378 at 1.0 dB, docs/BENCHMARKS.md:140-146) and below 0.05 at 1.2 dB.

Runs on the CUDA card unless given ``--cpu`` (there the kernels' plain
twins decode, slowly: use a small ``--cbs``). Data comes from ``--seed``.
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import torch

from ..ops.fec.turbo_decoder import TurboDecoder
from ..ops.fec.turbo_encoder import turbo_encode
from ..utils.device import resolve_device

#: the JAX tool's points, plus 0.1 dB steps from 0.6 to 1.4 dB
DEFAULT_POINTS = tuple(sorted({0.0, 0.4, 0.8, 1.0, 1.2, 1.6, 2.0}
                              | {round(0.6 + 0.1 * i, 1) for i in range(9)}))
IMPLS = ("nii", "windowed")
DTYPES = ("float32", "bfloat16")
LANES = ("f32", "int8")
#: turbo iterations, without early stop (tools/bler_sweep.py)
ITERATIONS = 6
#: the int8 lane's demod scale per LLR unit (tools/bler_sweep.py)
INT8_SCALE = 8.0
#: srsLTE's own decoder at 1.0 dB on this grid (docs/BENCHMARKS.md:140-146)
SRSLTE_BLER_1DB = 0.378
#: the most any curve may read at 1.2 dB
MAX_BLER_12DB = 0.05
#: the bfloat16 curve's allowed shift from the float32 curve, dB
SHIFT_DB = 0.1


def sweep(k: int = 1024, cbs: int = 8192, points=DEFAULT_POINTS,
          seed: int = 0, device=None) -> dict:
    """Decode ``cbs`` random code blocks of K=``k`` at each Eb/N0 point in
    every curve (decoder x metric dtype x LLR lane, the same blocks and
    noise for all 8). -> {"k", "cbs", "iterations", "window", "points",
    "device", "curves": [{"impl", "dtype", "llr", "bler": [...], "ber":
    [...]}]}."""
    dev = resolve_device(device)
    # the JAX tool's window
    window = 128 if k % 128 == 0 else 64
    g = torch.Generator(device=dev).manual_seed(seed)
    curves = {(impl, dt, lane): {"impl": impl, "dtype": dt, "llr": lane,
                                 "bler": [], "ber": []}
              for impl in IMPLS for dt in DTYPES for lane in LANES}
    for ebn0_db in points:
        u = torch.randint(0, 2, (cbs, k), generator=g, device=dev,
                          dtype=torch.int8)
        d = turbo_encode(u).to(torch.float32)
        n0 = 3.0 / 10 ** (ebn0_db / 10)
        y = 1.0 - 2.0 * d + math.sqrt(n0 / 2) * torch.randn(
            d.shape, generator=g, device=dev)
        llr_f = 4.0 / n0 * y
        llrs = {"f32": llr_f,
                "int8": torch.clamp(torch.round(llr_f * INT8_SCALE), -127,
                                    127).to(torch.int8)}
        for (impl, dt, lane), c in curves.items():
            bits, _ = TurboDecoder(k=k, iterations=ITERATIONS, window=window,
                                   impl=impl, dtype=dt).decode(llrs[lane])
            errs = bits != u
            c["bler"].append(float(errs.any(-1).float().mean()))
            c["ber"].append(float(errs.float().mean()))
    return {"k": k, "cbs": cbs, "iterations": ITERATIONS, "window": window,
            "points": [float(x) for x in points], "device": str(dev),
            "curves": list(curves.values())}


def within_shift(points, ref, test, n: int, shift_db: float = SHIFT_DB):
    """The 0.1 dB rule on two BLER curves over the same grid ``points``
    (dB), each point measured on ``n`` trials: at every x whose x -
    ``shift_db`` is a grid point with a ``ref`` BLER p in (0.01, 0.99),
    ``test``(x) must be <= p + 3 sqrt(p (1 - p) / n). -> [(x, test(x), p,
    limit)] for every such x, in grid order."""
    pts = [round(x, 1) for x in points]
    at = {x: i for i, x in enumerate(pts)}
    out = []
    for x in pts:
        j = at.get(round(x - shift_db, 1))
        if j is None or not 0.01 < ref[j] < 0.99:
            continue
        p = ref[j]
        out.append((x, test[at[x]], p,
                    p + 3.0 * math.sqrt(p * (1.0 - p) / n)))
    return out


def gate(res: dict) -> dict:
    """The bfloat16 gate on a ``sweep`` result.

    1. Per decoder and LLR lane, the bfloat16 curve lies within
       ``SHIFT_DB`` of the float32 curve: at every point x whose x - 0.1
       dB is a grid point with a float32 BLER p in (0.01, 0.99),
       BLER_bf16(x) <= p + 3 sqrt(p (1 - p) / cbs).
    2. Every curve reads <= ``SRSLTE_BLER_1DB`` at 1.0 dB and <=
       ``MAX_BLER_12DB`` at 1.2 dB (where the grid has those points).
    -> {"ok": bool, "checks": {name: bool}, "comparisons": [...]}."""
    at = {round(x, 1): i for i, x in enumerate(res["points"])}
    by = {(c["impl"], c["dtype"], c["llr"]): c for c in res["curves"]}
    checks, comps = {}, []
    for impl in IMPLS:
        for lane in LANES:
            f32, b16 = by[(impl, "float32", lane)], by[(impl, "bfloat16",
                                                         lane)]
            ok = True
            for x, got, p, limit in within_shift(
                    res["points"], f32["bler"], b16["bler"], res["cbs"]):
                comps.append({"impl": impl, "llr": lane, "ebn0_db": x,
                              "bler_bf16": got, "bler_f32_minus_shift": p,
                              "limit": limit, "ok": got <= limit})
                ok &= got <= limit
            checks[f"{impl}_{lane}_bf16_within_{SHIFT_DB}db"] = bool(ok)
    for c in res["curves"]:
        name = f"{c['impl']}_{c['dtype']}_{c['llr']}"
        for x, cap in ((1.0, SRSLTE_BLER_1DB), (1.2, MAX_BLER_12DB)):
            if x in at:
                checks[f"{name}_bler_at_{x}db_le_{cap}"] = \
                    c["bler"][at[x]] <= cap
    return {"ok": all(checks.values()), "checks": checks,
            "comparisons": comps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=1024)
    ap.add_argument("--cbs", type=int, default=8192)
    ap.add_argument("--points", default=None,
                    help="comma-separated Eb/N0 points in dB")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    points = (DEFAULT_POINTS if args.points is None
              else tuple(float(x) for x in args.points.split(",")))
    res = sweep(args.k, args.cbs, points, args.seed,
                device="cpu" if args.cpu else None)
    for c in res["curves"]:
        print(f"# K={res['k']}, rate 1/3, max-log-MAP {res['iterations']} "
              f"iter, window {res['window']}, {res['cbs']} CB/point, "
              f"decoder {c['impl']}, {c['dtype']} metrics, llr={c['llr']}")
        print("# EbN0_dB  BLER      BER")
        for x, bler, ber in zip(res["points"], c["bler"], c["ber"]):
            print(f"{x:8.1f}  {bler:8.4f}  {ber:.2e}")
    print(json.dumps({**res, "gate": gate(res)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
