"""Where a path's time goes on the card.

    python3 -m empower_srslte_tpu_torch.profile_main_path [--path PATH]

``--path downlink`` (the default) builds the 20 MHz 2x2 TM4 stimulus
(models/enb_dl.py tm4_stimulus) and profiles ``ue_dl_tm4_batch``;
``--path uplink`` builds the 20 MHz PUSCH+UCI stimulus at n0 1e-3
(models/ue_ul.py ul_uci_stimulus) and profiles the eNB receiver
``enb_ul_pusch_batch``; ``--path ul_control``
profiles the eNB's PUCCH/SRS decode of ``ul_control_stimulus``
(``ul_control_receive``); ``--path prach`` ``prach_detect`` on 256
format-0 windows of ``prach_stimulus``; ``--path pmch`` the MBSFN
receiver on ``pmch_stimulus`` (``pmch_receive``). All at a batch of 256
subframes (windows). ``--path stack`` attaches an eNB/UE pair (Cell(25
PRB, id 1), ideal air) and then profiles ``STACK_TTIS`` connected TTIs of
both stacks, each TTI carrying one IP packet up and one down:

1. times the receiver with CUDA events (mean of 3 calls after a
   warm-up);
2. traces one more call with ``torch.profiler`` and reads, for each of
   the receiver's ranges (``runtime.trace`` spans: ``ue_dl.*``,
   ``pdsch.*``, ``enb_ul.*``, ``pusch.*``, ``uci.*``, ``dlsch.*``,
   ``pucch.*``, ``srs.*``, ``prach.*``, ``pmch.*``, the early-stop
   reads ``turbo.stop_read`` and the first-use events ``runtime.*``),
   its host time and the device time of the kernels launched in it,
   each kernel given to the innermost range open at its launch (and the
   device time launched outside every range); plus device time by
   kernel name, the kernel count and the device's idle share of the
   traced call's wall time.

Prints one JSON object and writes it to
chiprun_out/profile_<path>.json. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import torch

BATCH = 256
#: TTIs per call of ``--path stack``
STACK_TTIS = 10
RANGE_PREFIXES = ("ue_dl.", "pdsch.", "enb_ul.", "pusch.", "uci.", "dlsch.",
                  "pucch.", "srs.", "prach.", "pmch.", "turbo.", "runtime.")


def call_ms(run, reps: int = 3) -> float:
    """Mean CUDA-event time of ``run()`` over ``reps`` calls after one
    warm-up."""
    run()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def trace(run) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return read_trace(prof.events(), wall_ms)


def read_trace(events, wall_ms: float) -> dict:
    """The per-range host and device times, kernel count, idle share and
    top kernels of a traced call's profiler ``events``."""
    cpu, cuda = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA
    ranges = [e for e in events
              if e.device_type == cpu and e.name.startswith(RANGE_PREFIXES)]
    kernels = [e for e in events
               if e.device_type == cuda and not e.is_user_annotation]
    # a kernel belongs to the innermost range its launch call (CUDA
    # runtime API, same correlation id) was made in; the profiler's own
    # op linking misses kernels launched outside an aten op (the ctypes
    # kernels)
    launch_us = {e.id: e.time_range.start for e in events
                 if e.device_type == cpu and e.name.startswith("cu")}
    stages = {r.name: {"host_ms": 0.0, "device_ms": 0.0} for r in ranges}
    for r in ranges:
        stages[r.name]["host_ms"] += r.cpu_time_total / 1e3
    outside_ms = 0.0
    for k in kernels:
        t = launch_us.get(k.id)
        owner = max((r for r in ranges if t is not None
                     and r.time_range.start <= t <= r.time_range.end),
                    key=lambda r: r.time_range.start, default=None)
        if owner is None:
            outside_ms += k.device_time / 1e3
        else:
            stages[owner.name]["device_ms"] += k.device_time / 1e3
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.device_time / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "kernel_launches": len(kernels),
            "stages": stages, "device_ms_outside_stages": outside_ms,
            "top_kernels": [{"name": n[:80], "ms": t, "count": c}
                            for n, (t, c) in top]}


def stack_ttis():
    """An attached eNB/UE pair on the card; -> a call that runs
    ``STACK_TTIS`` more TTIs, one ping up and one pong down each."""
    from .apps.lte_attach import epc
    from .stack import Air, EnbStack, UeStack
    from .tools.stack_drive import StackDrive
    from .utils.cell import Cell

    mme, nas = epc()
    cell = Cell(nof_prb=25, id=1)
    enb = EnbStack(cell, mme, device="cuda")
    ue = UeStack(cell, nas, device="cuda")
    drive = StackDrive([enb], [ue], air=Air(cell.sf_sample_len))
    drive.run(100, lambda tti: ue.rrc.nas.attached and bool(ue.rrc.drbs))
    if not (ue.rrc.nas.attached and ue.rrc.drbs):
        raise RuntimeError("the stack did not attach in 100 TTIs")
    pong = (b"\x45\x00" + bytes(14)
            + bytes(map(int, ue.rrc.nas.ue_ip.split("."))) + b"PONG")

    def run():
        for _ in range(STACK_TTIS):
            ue.send_ip(b"\x45\x00" + bytes(18) + b"PING")
            enb.deliver_gtpu(mme.spgw.downlink(pong)[1])
            drive.step()
    return run


def receiver(path: str):
    """The path's receiver call on its stimulus; it records the turbo
    iteration counts into the returned list."""
    iters: list = []
    if path == "downlink":
        from .models.enb_dl import tm4_stimulus
        from .models.ue_dl import ue_dl_tm4_batch

        st = tm4_stimulus(BATCH, device="cuda")

        def run():
            iters[:] = ue_dl_tm4_batch(st.samples, st.cfg,
                                       st.plan).iterations
    elif path == "ul_control":
        from .models.ue_ul import ul_control_receive, ul_control_stimulus

        st = ul_control_stimulus(BATCH, device="cuda")

        def run():
            ul_control_receive(st.samples, st)
    elif path == "prach":
        from .models import prach

        st = prach.prach_stimulus(BATCH, cell=prach.Cell(nof_prb=100, id=1),
                                  device="cuda")

        def run():
            prach.prach_detect(st.samples, st.cell, prach.STACK_RSI,
                               zcz=st.zcz,
                               freq_offset_prb=prach.STACK_FREQ_OFFSET)
    elif path == "pmch":
        from .models.pmch import pmch_receive, pmch_stimulus

        st = pmch_stimulus(BATCH, device="cuda")

        def run():
            iters.clear()
            pmch_receive(st.samples, st, iters_out=iters)
    elif path == "stack":
        run = stack_ttis()
    else:
        from .models.ue_ul import enb_ul_pusch_batch, ul_uci_stimulus

        n0 = 1e-3
        st = ul_uci_stimulus(BATCH, n0, device="cuda")

        def run():
            iters[:] = enb_ul_pusch_batch(st.samples, st.cfg, st.plan,
                                          n0).iterations
    return run, iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--path", choices=("downlink", "uplink", "ul_control",
                                       "prach", "pmch", "stack"),
                    default="downlink")
    path = ap.parse_args(argv).path
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    run, iters = receiver(path)
    out = {"card": card, "path": path,
           "batch": STACK_TTIS if path == "stack" else BATCH,
           "ms_per_batch": call_ms(run), "trace": trace(run),
           "turbo_iterations": iters}
    print(json.dumps(out, indent=1))
    name = "main_path" if path == "downlink" else path
    out_file = pathlib.Path("chiprun_out") / f"profile_{name}.json"
    out_file.parent.mkdir(parents=True, exist_ok=True)
    out_file.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
