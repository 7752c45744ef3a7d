"""Multi-process (multi-host) dry run: the host axis across OS processes.

    python -m empower_srslte_tpu_torch.tools.multihost_dryrun [N] [--cpu]
        [--backend gloo|nccl]

Counterpart of the JAX package's ``tools/multihost_dryrun.py``. Launches
N OS processes (default 2), each holding 4 local shards: the CUDA card
``rank % cards`` four times, or with ``--cpu`` the CPU four times. They
join one ``torch.distributed`` group (a file store in a temporary
directory; ``--backend gloo``, the default, exchanges through host
memory, ``nccl`` between cards, one card per process, so it needs N
cards), build the global (host, carrier, sf) mesh
(``parallel/dist.py make_global_mesh``) and run:

  A. the no-genie UE downlink chain (``parallel/validate.py
     build_uedl_mini``) sharded over (host, carrier, sf), one subframe
     per shard, with the decode successes summed over all three axes
     (a cross-process ``psum``) and every process checking its own
     shards' bits;
  B. the trellis-sharded NII turbo decode (``sp_turbo_decode_nii``) with
     axis ``"host"``, 8 code blocks of K 1024 and, on the card, of K 6144
     too, 2 iterations: the boundary-metric ring shifts and the extrinsic
     all-gathers cross the process boundary every half-iteration, and the
     bits must equal the encoder input.

Rank 0 prints one JSON line (each part's host-clock ms on rank 0, and
every rank's NII launches per (K, window, code blocks, dtype, bounds),
each process counting its own) and then ``MULTIHOST_OK``. One deadline
(``DEADLINE_S``) covers every worker; a worker that fails, or any still
running at the deadline, ends the run and the others are killed. Without
a card and without ``--cpu`` it raises.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

#: local shards per process (the JAX tool's virtual devices per process)
N_LOCAL = 4
#: the repository root, from which the workers import the package
ROOT = pathlib.Path(__file__).resolve().parents[2]
MODULE = "empower_srslte_tpu_torch.tools.multihost_dryrun"
#: seconds for the whole run, workers included (the card's 2-process run
#: takes ~20 s, the CPU's ~1 min): below the callers' own limits
DEADLINE_S = 240.0


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def part_a(mesh, device) -> dict:
    """The mini chain over (host, carrier, sf), successes summed across
    processes; -> its line."""
    from ..parallel.comm import psum
    from ..parallel.mesh import Sharding, smap
    from ..parallel.validate import build_uedl_mini

    n_host, n_sf = mesh.shape["host"], mesh.shape["sf"]
    local_step, tbs = build_uedl_mini(seed=7, device=device)
    rng = np.random.default_rng(7)
    tb_np = rng.integers(0, 2, size=(n_host, 1, n_sf, tbs)).astype(np.int8)
    sharding = Sharding(mesh, ("host", "carrier", "sf"))
    t0 = time.perf_counter()
    out = smap(local_step, sharding.place(torch.as_tensor(tb_np)))
    n_ok = psum(mesh, {c: ok.to(torch.int32).sum() for c, (_, ok)
                       in out.items()}, ("host", "carrier", "sf"))
    n_ok = {int(v) for v in n_ok.values()}
    ms = (time.perf_counter() - t0) * 1e3
    if n_ok != {n_host * n_sf}:
        raise AssertionError(f"ue_dl ok count {n_ok}, want {n_host * n_sf}")
    for c, (bits, _) in out.items():
        want = tb_np[sharding.block(tb_np.shape, c)]
        if not np.array_equal(bits.cpu().numpy(), want):
            raise AssertionError(f"ue_dl TB mismatch at {c}")
    return {"shards": len(out), "ok_global": n_ok.pop(), "ms": ms}


def part_b(mesh, device, k: int, seed: int) -> dict:
    """``sp_turbo_decode_nii`` with axis "host" on 8 code blocks of K
    ``k``: a counted first decode, then a timed one; -> its line."""
    from ..ops.fec.turbo_encoder import turbo_encode
    from ..parallel.turbo_sp import sp_turbo_decode_nii
    from ..runtime import trace

    rng = np.random.default_rng(seed)
    u = torch.as_tensor(rng.integers(0, 2, size=(8, k)).astype(np.int8))
    llr = ((1.0 - 2.0 * turbo_encode(u).to(torch.float32)) * 8.0).to(device)
    run = lambda: sp_turbo_decode_nii(llr, k, mesh, axis="host",
                                      iterations=2)
    _sync(device)
    trace.reset()
    t0 = time.perf_counter()
    bits, _ = run()
    _sync(device)
    ms_first = (time.perf_counter() - t0) * 1e3
    launches = trace.launch_counts().get("turbo_nii", 0)
    by_bounds = [[*key, c] for key, c in
                 sorted(trace.launch_shapes("turbo_nii").items())]
    if not torch.equal(bits.cpu(), u):
        raise AssertionError(f"cross-process NII decode mismatch at K {k}")
    t0 = time.perf_counter()
    run()
    _sync(device)
    return {"k": k, "cbs": 8, "iterations": 2, "bits_equal": True,
            "ms_first": ms_first, "ms": (time.perf_counter() - t0) * 1e3,
            "launches": launches, "by_bounds": by_bounds}


def worker(rank: int, nproc: int, store: str, backend: str,
           cpu: bool) -> None:
    import torch.distributed as dist

    from ..parallel.dist import init_distributed, make_global_mesh

    if cpu:
        torch.set_num_threads(1)
        device, ids = torch.device("cpu"), None
    else:
        card = rank % torch.cuda.device_count()
        device, ids = torch.device("cuda", card), [card]
    init_distributed(f"file://{store}", nproc, rank, local_device_ids=ids,
                     backend=backend)
    try:
        mesh = make_global_mesh(carriers=1, devices=[device] * N_LOCAL)
        line = {"rank": rank, "processes": nproc, "backend": backend,
                "device": str(device), "mesh": mesh.shape,
                "part_a": part_a(mesh, device)}
        ks = (1024,) if cpu else (1024, 6144)
        mine = [part_b(mesh, device, k, seed=7 + i)
                for i, k in enumerate(ks)]
        # every rank's launches: each launches its own shard's bounds
        ranks = [None] * nproc
        dist.all_gather_object(ranks, mine)
        line["part_b"] = [dict(
            b, launches=sum(r[i]["launches"] for r in ranks),
            launches_by_rank=[r[i]["launches"] for r in ranks],
            by_bounds=[x for r in ranks for x in r[i]["by_bounds"]])
            for i, b in enumerate(mine)]
    finally:
        dist.destroy_process_group()
    if rank == 0:
        print(json.dumps(line), flush=True)
        print("MULTIHOST_OK", flush=True)


def _run(args) -> int:
    """Launch the workers and wait for all of them under one deadline."""
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="multihost_"))
    procs, logs = [], []
    try:
        for r in range(args.n):
            logs.append(open(tmp / f"rank{r}.log", "wb"))
            procs.append(subprocess.Popen(
                [sys.executable, "-m", MODULE, str(args.n), "--worker", str(r),
                 "--store", str(tmp / "store"), "--backend", args.backend,
                 *(["--cpu"] if args.cpu else [])],
                cwd=ROOT, stdout=logs[-1], stderr=subprocess.STDOUT))
        end = time.monotonic() + DEADLINE_S
        while any(p.poll() is None for p in procs):
            if any(p.returncode for p in procs) or time.monotonic() > end:
                break
            time.sleep(0.1)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
        texts = [(tmp / f"rank{r}.log").read_text(errors="replace")
                 for r in range(len(procs))]
        shutil.rmtree(tmp, ignore_errors=True)
    rcs = [p.returncode for p in procs]
    sys.stdout.write(texts[0])
    if any(rcs) or "MULTIHOST_OK" not in texts[0]:
        for r, t in enumerate(texts[1:], 1):
            sys.stdout.write(f"--- rank {r} ---\n{t[-4000:]}")
        print(f"FAILED rcs={rcs} (deadline {DEADLINE_S} s)", flush=True)
        return 1
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", nargs="?", type=int, default=2,
                   help="processes (default 2)")
    p.add_argument("--cpu", action="store_true",
                   help="shards on the CPU (default: the CUDA card)")
    p.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    p.add_argument("--worker", type=int, help=argparse.SUPPRESS)
    p.add_argument("--store", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker is not None:
        worker(args.worker, args.n, args.store, args.backend, args.cpu)
        return 0
    if args.cpu and args.backend == "nccl":
        raise ValueError("NCCL runs between cards: drop --cpu or use gloo")
    if not args.cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available: pass --cpu to run "
                               "the shards on the CPU")
        if args.backend == "nccl" and torch.cuda.device_count() < args.n:
            raise RuntimeError(f"NCCL needs a card per process: "
                               f"{torch.cuda.device_count()} for {args.n}")
    return _run(args)


if __name__ == "__main__":
    sys.exit(main())
