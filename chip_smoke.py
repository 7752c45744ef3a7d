#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch twin on the card, then drives the port's paths
on a batch of 256 subframes each and checks what they decode:

* the no-genie 20 MHz 2x2 TM4 two-codeword UE downlink receiver
  (NII turbo kernel, Viterbi kernel);
* the 20 MHz eNB PUSCH receiver with UCI (windowed turbo kernel, Viterbi
  kernel for the CQI), at a high and at a mid SNR;
* the recursion-rate probe tool (its own kernel).

    python3 chip_smoke.py [--baseline FILE]

``--baseline FILE`` names a Python file that defines ``PTXAS`` (its ptxas
log per kernel name) and any of ``map_decode_nii``, ``map_decode_win``
and ``viterbi_regs``, with the signatures of the port's
``map_decode_nii``, ``map_decode_win`` and ``viterbi_regs_cuda`` (another
design of those kernels): each kernel check with a baseline then times it
and the port's kernel in turns (baseline, port, port, baseline) and puts
both on its phase line.

Needs one CUDA card (H100, sm_90a) and the CUDA toolkit's nvcc. Prints
one JSON line per phase, the card's name and power limit as nvidia-smi
reports them, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}`` — only when every phase passed. Any
failure exits nonzero. Build logs go to chiprun_out/chip_smoke/.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth, and the
#: non-tensor-core float32 rate for operations that are not FMAs (the
#: published 67 TFLOP/s counts each FMA as 2); both kernels do adds,
#: maxes, compares and selects
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 33.5e12

BATCH = 256
#: the uplink path's noise per grid RE: high SNR, and a mid SNR at which
#: the early stop iterates (bench.py MIDSNR_N0["20ul"])
UL_N0, UL_N0_MID = 1e-3, 0.045
#: float32 adds/subs/maxes per trellis step and window of the NII
#: algorithm: backward step 2 gamma + 2 scale + 1 apr add + 16 adds + 8
#: maxes + 1 (renorm share) = 30; forward step 2 + 2 + 1 + 16 (branch)
#: + 16 (totals) + 14 maxes + 2 (ext) + 8 maxes + 1 (renorm share) = 62.
#: A bound counts the algorithm's work, whatever implements it: the
#: kernel's recompute of the stored betas (~30 more per step) is not in it
NII_OPS_PER_STEP = 92
#: float32 operations per step and window of the windowed algorithm:
#: every step of either sweep 2 (halving) + 2 (gammas) + 16 adds + 8 maxes
#: = 28; each emit step adds 16 adds + 14 maxes + 1 sub = 31; each 8-step
#: group of either sweep renormalizes with 7 maxes + 8 subs = 15. As for
#: NII, the kernel's recompute is not counted
WIN_OPS_STEP, WIN_OPS_EMIT, WIN_OPS_RENORM = 28, 31, 15
#: operations per trellis step and word of the Viterbi algorithm: 64
#: states x (2 adds, compare, select, renormalizing sub) + 8 branch
#: metrics; per survivor step (middle and flush), the traceback's word
#: select, shift, mask and next state. Survivor bookkeeping beyond that
#: (register exchange) is a design's cost, not the algorithm's
VIT_OPS_STEP, VIT_OPS_TRACE = 64 * 5 + 8, 4
#: ptxas report of each built kernel (phase_build), for the phase lines
PTXAS: dict = {}
#: the --baseline module, or None
BASELINE = None


def emit(obj):
    print(json.dumps(obj), flush=True)


def bound(nbytes: float, ops: float) -> dict:
    """Least time for the work: bytes over the HBM rate or float32
    operations over the non-FMA rate, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, reps: int, replays: int = 5) -> float:
    """Device time per call of a kernel shorter than its host call: ``reps``
    calls captured in one CUDA graph and replayed, so that the launches
    run back to back on the card (the wrapper's Python cost per call would
    otherwise be what a timing of ``cuda_ms`` reads)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(replays):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (reps * replays)


def ptxas_summary(log: str) -> dict:
    """{entry function: registers, static shared bytes, spill bytes} from
    an ``nvcc -Xptxas -v`` log."""
    import re

    out, fn = {}, None
    for ln in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", ln)
        if m:
            fn = m.group(1)
            out.setdefault(fn, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and fn:
            out[fn].update(spill_stores=int(m.group(1)),
                           spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            sm = re.search(r"(\d+) bytes smem", ln)
            out[fn].update(registers=int(m.group(1)),
                           smem_static=int(sm.group(1)) if sm else 0)
    return {k: v for k, v in out.items() if "registers" in v}


def paired_ms(new_fn, old_fn, reps: int, timer=cuda_ms) -> dict:
    """The port's kernel timed alone, or beside a baseline in turns
    (baseline, port, port, baseline) when one is given."""
    if old_fn is None:
        return {"ms": timer(new_fn, reps)}
    o1 = timer(old_fn, reps)
    n1 = timer(new_fn, reps)
    n2 = timer(new_fn, reps)
    o2 = timer(old_fn, reps)
    return {"ms": (n1 + n2) / 2, "baseline_ms": (o1 + o2) / 2,
            "turns_ms": [o1, n1, n2, o2]}


def max_abs_err(got, ref) -> float:
    if isinstance(got, tuple):
        return max(max_abs_err(x, y) for x, y in zip(got, ref))
    return float((got - ref).abs().max())


def phase_device():
    import torch

    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"phase": "device", "nvidia_smi": line,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "count": torch.cuda.device_count()})
    return line


def phase_build():
    from empower_srslte_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    took = cuda_build.build(["turbo_nii", "viterbi37", "turbo_win",
                             "recursion_probe"])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for name, log in cuda_build.BUILD_LOGS.items():
        (OUT_DIR / f"build_{name}.log").write_text(log)
        PTXAS[name] = ptxas_summary(log)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_source_s": {k: round(v, 3) for k, v in took.items()},
          "ptxas": PTXAS})


def turbo_kernel_check():
    """map_decode_nii against the plain twin, max abs error exactly 0, at
    the geometries the kernel's code paths take: the main path's (5120
    code blocks of K=5760, l=240, with apr), a ragged single window
    (K=56, l=K, no apr: the top segment is 8 rows) and a trellis slice
    with no edge (bounds (-1, -1)); then one full decode of 64 code
    blocks where the hard bits and iteration counts must be equal."""
    import numpy as np
    import torch

    from empower_srslte_tpu_torch.ops.fec.turbo_decoder import TurboDecoder
    from empower_srslte_tpu_torch.ops.fec.turbo_encoder import turbo_encode
    from empower_srslte_tpu_torch.ops.fec.turbo_nii import (
        map_decode_nii, map_decode_nii_plain, nii_plan)
    from empower_srslte_tpu_torch.utils.crc import CRC24B

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    rn = lambda *s, sc=4.0: torch.randn(*s, generator=g, device=dev) * sc

    def case(k, l, b, apr, bounds):
        w = k // l
        args = (rn(k, b), rn(k, b), rn(3, b), rn(3, b),
                rn(w + 1, 8, b, sc=2.0), rn(w + 1, 8, b, sc=2.0))
        kw = dict(l=l, apr=rn(k, b) if apr else None, bounds=bounds)
        return args, kw

    k, l, b = 5760, 240, 2 * BATCH * 10
    w = k // l
    geos = {"main": (k, l, b, True, None),
            "ragged_single_window": (56, 56, b, False, None),
            "no_edge": (k, l, 512, True, (-1, -1))}
    errs = {}
    for name, geo in geos.items():
        args, kw = case(*geo)
        got = map_decode_nii(*args, **kw)
        ref = map_decode_nii_plain(*args, **kw)
        torch.cuda.synchronize()
        # the same float32 adds in the same order on both sides
        errs[name] = max_abs_err(got, ref)
        if name == "main":
            main_args, main_kw, main_ref = args, kw, ref
    assert not any(errs.values()), f"NII kernel vs plain twin: {errs}"
    err = max(errs.values())

    base = None
    base_fn = getattr(BASELINE, "map_decode_nii", None)
    if base_fn is not None:
        base_err = max_abs_err(base_fn(*main_args, **main_kw), main_ref)
        base = lambda: base_fn(*main_args, **main_kw)
    times = paired_ms(lambda: map_decode_nii(*main_args, **main_kw), base,
                      reps=10)
    ms = times["ms"]
    plain_ms = cuda_ms(lambda: map_decode_nii_plain(*main_args, **main_kw),
                       reps=1)
    # compulsory traffic: u, p, apr, tails, a_st, b_st in; ext, a/b out
    nbytes = 4 * (4 * k * b + 2 * 3 * b + 4 * (w + 1) * 8 * b)
    ops = NII_OPS_PER_STEP * k * b
    # what this design moves: u, p, apr read by both sweeps, ext written
    moved = 4 * (7 * k * b + 2 * 3 * b + 4 * (w + 1) * 8 * b)

    # full decode: 64 CRC24B-protected code blocks in AWGN
    nb = 64
    rng = np.random.default_rng(5)
    payload = torch.as_tensor(rng.integers(0, 2, (nb, k - 24)), device=dev)
    u = torch.cat([payload, CRC24B.compute(payload)], -1).to(torch.int8)
    d = turbo_encode(u).to(torch.float32)
    ebn0 = 10 ** (0.9 / 10)
    n0 = 3.0 / ebn0
    y = 1.0 - 2.0 * d + (n0 / 2) ** 0.5 * torch.randn(d.shape, generator=g,
                                                       device=dev)
    llr = 4.0 / n0 * y
    dec = TurboDecoder(k=k, iterations=8, window=l)
    it_k, it_p = [], []
    bits_k, _ = dec.decode(llr, crc=CRC24B, iters_out=it_k)
    bits_p, _ = dec.decode(llr, crc=CRC24B, iters_out=it_p,
                           map_decode=map_decode_nii_plain)
    assert torch.equal(bits_k, bits_p), "turbo hard bits differ from twin"
    assert it_k == it_p, (it_k, it_p)
    n_err = int((bits_k != u).sum())
    line = {"phase": "kernel_turbo", "cbs": b, "k": k, "window": l,
            "max_abs_err": err, "max_abs_err_by_geometry": errs,
            **times, "plain_ms": plain_ms,
            "smem_dynamic": nii_plan(l, True).smem,
            "ptxas": PTXAS.get("turbo_nii"), "moved_gb": moved / 1e9,
            "moved_tb_s": moved / (ms * 1e-3) / 1e12,
            "decode_cbs": nb, "decode_iterations": it_k,
            "decode_bit_errors": n_err, "hard_bits_equal": True}
    if base_fn is not None:
        line.update(baseline_max_abs_err=base_err,
                    baseline_ptxas=ptxas_summary(
                        BASELINE.PTXAS.get("turbo_nii", "")))
    emit(line)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **bound(nbytes, ops))


def viterbi_kernel_check(phase: str, sizes, seed: int, extra=()):
    """The Viterbi kernel against its plain twin on noisy codewords, for
    each (K, words) in ``sizes``, timed there by CUDA-graph replay (in
    turns with a baseline's ``viterbi_regs`` when one is given;
    ``ms_ungraphed`` times the same call launch by launch, which at the
    CQI's shape reads the wrapper's host cost); then at each (K, words, train,
    kind) of ``extra``, checked only (kind "ints": LLRs in {-1, 0, 1},
    which tie often). Every geometry must read 0 mismatched bits. The
    downlink's blind search decodes K=55 and K=44; the uplink's CQI decode
    K=38, where the training halo is clamped to K."""
    import torch

    from empower_srslte_tpu_torch.ops.fec.convcoder import (
        TRAIN_LEN, conv_encode, unpack_regs, viterbi_decode_plain)
    from empower_srslte_tpu_torch.ops.fec.viterbi37 import (
        viterbi_decode_cuda, viterbi_regs_cuda, vit_plan)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    base_fn = getattr(BASELINE, "viterbi_regs", None)

    def inputs(k, words, kind="noisy"):
        if kind == "ints":
            return torch.randint(-1, 2, (words, 3, k), generator=g,
                                 device=dev).to(torch.float32)
        u = torch.randint(0, 2, (words, k), generator=g, device=dev)
        d = conv_encode(u).to(torch.float32)
        return (1.0 - 2.0 * d
                + 0.8 * torch.randn(d.shape, generator=g, device=dev))

    mism, base_mism, per_k = {}, {}, {}
    ms = plain_ms = err = 0.0
    nbytes = ops = 0
    for k, words in sizes:
        llr = inputs(k, words)
        got = viterbi_decode_cuda(llr)
        ref = viterbi_decode_plain(llr)
        torch.cuda.synchronize()
        mism[f"k{k}"] = int((got != ref).sum())
        err = max(err, float((got.int() - ref.int()).abs().max()))
        halo = min(TRAIN_LEN, k)
        base = None
        if base_fn is not None:
            base_bits = unpack_regs(base_fn(llr, halo), k)
            base_mism[f"k{k}"] = int((base_bits != ref).sum())
            base = lambda: base_fn(llr, halo)
        times = paired_ms(lambda: viterbi_regs_cuda(llr, halo), base,
                          reps=20, timer=graph_ms)
        host_ms = cuda_ms(lambda: viterbi_regs_cuda(llr, halo), reps=20)
        k_plain = cuda_ms(lambda: viterbi_decode_plain(llr), reps=1)
        steps = 2 * halo + k
        k_bytes = 4 * words * (3 * k + (k - 1) // 32 + 1)
        k_ops = words * (steps * VIT_OPS_STEP + (k + halo) * VIT_OPS_TRACE)
        plan = vit_plan(k, halo)
        per_k[f"k{k}"] = {"words": words, "halo": halo, "steps": steps,
                          **times, "ms_ungraphed": host_ms,
                          "plain_ms": k_plain,
                          "ns_per_step": times["ms"] * 1e6 / steps,
                          "warps_per_block": plan.warps,
                          "smem_dynamic": plan.smem,
                          **bound(k_bytes, k_ops)}
        ms += times["ms"]
        plain_ms += k_plain
        nbytes += k_bytes
        ops += k_ops
    for k, words, train, kind in extra:
        llr = inputs(k, words, kind)
        got = viterbi_decode_cuda(llr, train=train)
        ref = viterbi_decode_plain(llr, train=train)
        torch.cuda.synchronize()
        mism[f"k{k}_{kind}_train_{train}"] = int((got != ref).sum())
    total = sum(mism.values())
    line = {"phase": phase, "sizes": [list(s) for s in sizes],
            "mismatched_bits": total, "mismatched_bits_by_geometry": mism,
            "ms": ms, "plain_ms": plain_ms, "by_k": per_k,
            "ptxas": PTXAS.get("viterbi37"), **bound(nbytes, ops)}
    if base_fn is not None:
        line.update(baseline_mismatched_bits=base_mism,
                    baseline_ptxas=ptxas_summary(
                        BASELINE.PTXAS.get("viterbi37", "")))
    emit(line)
    assert total == 0, f"Viterbi kernel decisions differ: {mism}"
    return dict(max_abs_err=err, mismatched_bits=total, ms=ms,
                plain_ms=plain_ms, **bound(nbytes, ops))


def phase_main_path():
    """The main path: TM4 transmitter (plain PyTorch) -> receiver."""
    import torch

    from empower_srslte_tpu_torch.models.enb_dl import tm4_stimulus
    from empower_srslte_tpu_torch.models.ue_dl import ue_dl_tm4_batch
    from empower_srslte_tpu_torch.ops.fec import turbo_nii, viterbi37

    t0 = time.perf_counter()
    st = tm4_stimulus(BATCH, device="cuda")
    torch.cuda.synchronize()
    tx_s = time.perf_counter() - t0

    run = lambda: ue_dl_tm4_batch(st.samples, st.cfg, st.plan)
    run()                                              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    turbo_nii.LAUNCHES = 0
    viterbi37.LAUNCHES = 0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    res = run()
    e1.record()
    torch.cuda.synchronize()
    launches = {"turbo_nii": turbo_nii.LAUNCHES,
                "viterbi37": viterbi37.LAUNCHES}
    ms_first = e0.elapsed_time(e1)

    b1, b2 = res.tb_bits
    ok1, ok2 = res.crc_ok
    checks = {
        "crc_ok": bool(ok1.all() and ok2.all()),
        "bits_equal": bool(torch.equal(b1, st.tb) and torch.equal(b2, st.tb2)),
        "cfi_found": bool((res.cfi == st.cfg.cfi).all()),
        "dci_found": bool((res.dci_hits >= 1).all()),
        "turbo_launched": launches["turbo_nii"] > 0,
        "viterbi_launched": launches["viterbi37"] > 0,
    }
    reps = 3
    e0.record()
    for _ in range(reps):
        run()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / reps
    tbs = st.plan.tbs
    emit({"phase": "main_path", "batch": BATCH, "nof_prb": 100,
          "mcs": 25, "tbs": tbs, "codewords": 2, "tx_s": round(tx_s, 3),
          "ms_per_batch": ms, "ms_counted_run": ms_first,
          "mbps": BATCH * 2 * tbs / (ms * 1e-3) / 1e6,
          "turbo_iterations": res.iterations, "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    assert not failed, f"main path checks failed: {failed}"
    return launches


def turbo_win_kernel_check():
    """map_decode_win against the plain twin, max abs error exactly 0, at
    the uplink path's geometry (256 x 7 code blocks of K=5824, window 224,
    overlap 40) and at K=1024 with its decoder window; then one full
    windowed decode of 64 code blocks near threshold where hard bits and
    iteration counts must be equal."""
    import numpy as np
    import torch

    from empower_srslte_tpu_torch.models.sch import _pick_window
    from empower_srslte_tpu_torch.ops.fec.turbo_decoder import TurboDecoder
    from empower_srslte_tpu_torch.ops.fec.turbo_encoder import turbo_encode
    from empower_srslte_tpu_torch.ops.fec.turbo_win import (
        DEFAULT_OVERLAP, map_decode_win, map_decode_win_plain, win_plan)
    from empower_srslte_tpu_torch.utils.crc import CRC24B

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    o = DEFAULT_OVERLAP
    errs = {}
    for name, (kk, bb) in {"uplink": (5824, BATCH * 7),
                           "k1024": (1024, BATCH)}.items():
        kw = dict(k=kk, l=_pick_window(kk), o=o)
        lsa = torch.randn(kk + 3, bb, generator=g, device=dev) * 4.0
        lp = torch.randn(kk + 3, bb, generator=g, device=dev) * 4.0
        got = map_decode_win(lsa, lp, **kw)
        ref = map_decode_win_plain(lsa, lp, **kw)
        torch.cuda.synchronize()
        # the same float32 adds in the same order on both sides
        errs[name] = max_abs_err(got, ref)
        if name == "uplink":
            k, b, l, main = kk, bb, kw["l"], (lsa, lp, kw, ref)
    assert not any(errs.values()), f"windowed kernel vs plain twin: {errs}"
    err = max(errs.values())
    w = k // l
    lsa, lp, kw, ref = main
    base = None
    base_fn = getattr(BASELINE, "map_decode_win", None)
    if base_fn is not None:
        base_err = max_abs_err(base_fn(lsa, lp, **kw), ref)
        base = lambda: base_fn(lsa, lp, **kw)
    times = paired_ms(lambda: map_decode_win(lsa, lp, **kw), base, reps=10)
    ms = times["ms"]
    plain_ms = cuda_ms(lambda: map_decode_win_plain(lsa, lp, **kw), reps=1)
    # compulsory traffic: lsa, lp in; llr out
    nbytes = 4 * (2 * (k + 3) + k) * b
    ops = w * b * ((l + o) * 2 * WIN_OPS_STEP + l * WIN_OPS_EMIT
                   + 2 * ((l + o) // 8) * WIN_OPS_RENORM)
    # what this design moves: every window's rows twice and its 2O
    # overlap rows once more (lsa, lp), llr written once, and the
    # 32-byte checkpoints of the segments above the first written and read
    moved = 4 * (2 * (2 * k + 2 * o * w) + k) * b \
        + 2 * 32 * (l // 8 - 1) * w * b

    nb = 64
    rng = np.random.default_rng(5)
    payload = torch.as_tensor(rng.integers(0, 2, (nb, k - 24)), device=dev)
    u = torch.cat([payload, CRC24B.compute(payload)], -1).to(torch.int8)
    d = turbo_encode(u).to(torch.float32)
    n0 = 3.0 / 10 ** (0.9 / 10)
    y = 1.0 - 2.0 * d + (n0 / 2) ** 0.5 * torch.randn(d.shape, generator=g,
                                                       device=dev)
    llr = 4.0 / n0 * y
    dec = TurboDecoder(k=k, iterations=8, window=l, impl="windowed")
    it_k, it_p = [], []
    bits_k, _ = dec.decode(llr, crc=CRC24B, iters_out=it_k)
    bits_p, _ = dec.decode(llr, crc=CRC24B, iters_out=it_p,
                           map_decode=map_decode_win_plain)
    assert torch.equal(bits_k, bits_p), "windowed hard bits differ from twin"
    assert it_k == it_p, (it_k, it_p)
    line = {"phase": "kernel_turbo_win", "cbs": b, "k": k, "window": l,
            "overlap": o, "max_abs_err": err,
            "max_abs_err_by_geometry": errs, **times, "plain_ms": plain_ms,
            "smem_dynamic": win_plan(l, o).smem,
            "ptxas": PTXAS.get("turbo_win"), "moved_gb": moved / 1e9,
            "moved_tb_s": moved / (ms * 1e-3) / 1e12,
            "decode_cbs": nb, "decode_iterations": it_k,
            "decode_bit_errors": int((bits_k != u).sum()),
            "hard_bits_equal": True}
    if base_fn is not None:
        line.update(baseline_max_abs_err=base_err,
                    baseline_ptxas=ptxas_summary(
                        BASELINE.PTXAS.get("turbo_win", "")))
    emit(line)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                **bound(nbytes, ops))


def recursion_kernel_check():
    """The probe kernel against its twin, bit for bit after 64 steps for
    each type; then the tool's own entry point at 4096 steps, which is
    the path its launch count is read from."""
    import torch

    from empower_srslte_tpu_torch.tools import microbench_recursion as mr

    mism = {}
    err = 0.0
    for name, *_ in mr.TYPES:
        x = mr.probe_input(name, mr.DEFAULT_LANES, "cuda", seed=3)
        got = mr.recursion_probe(x, 64)
        ref = mr.recursion_plain(x, 64)
        torch.cuda.synchronize()
        mism[name] = int((got != ref).sum())
        err = max(err, float((got.float() - ref.float()).abs().max()))
    assert not any(mism.values()), f"recursion probe differs: {mism}"
    x = mr.probe_input("f32", mr.DEFAULT_LANES, "cuda")
    steps = mr.DEFAULT_STEPS
    plain_ms = cuda_ms(lambda: mr.recursion_plain(x, steps), reps=1)
    mr.LAUNCHES = 0
    rates = mr.run(steps)
    launches = mr.LAUNCHES
    f32 = rates[0]
    emit({"phase": "kernel_recursion", "mismatched": mism,
          "rates": rates, "launches": launches, "plain_ms": plain_ms})
    assert launches > 0
    return launches, dict(max_abs_err=err, ms=f32["ms"], plain_ms=plain_ms,
                          **bound(2 * x.numel() * 4, f32["ops"]))


def run_uplink(st, n0: float):
    """One receiver call on the stimulus: grid, then PUSCH + UCI decode."""
    from empower_srslte_tpu_torch.models.pusch import pusch_decode_uci
    from empower_srslte_tpu_torch.models.ue_ul import enb_ul_receive_grid

    its: list = []
    out = pusch_decode_uci(enb_ul_receive_grid(st.samples, st.cfg.cell),
                           st.cfg, st.plan, noise_est=n0, iters_out=its)
    return out, its


def uci_errors(out, plan) -> dict:
    import torch

    uci = plan.uci
    sent = torch.as_tensor(uci.cqi_bits, device=out["cqi_bits"].device)
    return {"ack": sum(int((a != v).sum()) for a, v in zip(out["ack"],
                                                           uci.ack)),
            "ri": int((out["ri"] != uci.ri).sum()),
            "cqi": int((out["cqi_bits"] != sent).any(-1).sum()),
            "cqi_crc_fail": int((~out["cqi_ok"]).sum())}


def phase_uplink():
    """The uplink path: UE PUSCH+UCI transmitter (plain PyTorch) ->
    channel + AWGN -> eNB receiver, 256 subframes at n0 = UL_N0."""
    import torch

    from empower_srslte_tpu_torch.models.ue_ul import ul_uci_stimulus
    from empower_srslte_tpu_torch.ops.fec import turbo_nii, turbo_win, \
        viterbi37

    t0 = time.perf_counter()
    st = ul_uci_stimulus(BATCH, UL_N0, device="cuda")
    torch.cuda.synchronize()
    tx_s = time.perf_counter() - t0
    # the CQI decode's Viterbi shape: one word of O + 8 bits per subframe.
    # Checked before the warm-up: its graph captures empty PyTorch's
    # allocator cache, which the timed runs would pay to refill
    vit = viterbi_kernel_check(
        "kernel_viterbi_uplink", [(len(st.plan.uci.cqi_bits) + 8, BATCH)],
        seed=7)
    run_uplink(st, UL_N0)                                  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    turbo_nii.LAUNCHES = turbo_win.LAUNCHES = viterbi37.LAUNCHES = 0
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out, its = run_uplink(st, UL_N0)
    e1.record()
    torch.cuda.synchronize()
    launches = {"turbo_win": turbo_win.LAUNCHES,
                "viterbi37": viterbi37.LAUNCHES,
                "turbo_nii": turbo_nii.LAUNCHES}
    ms_first = e0.elapsed_time(e1)
    errs = uci_errors(out, st.plan)
    checks = {
        "crc_ok": bool(out["crc_ok"].all()),
        "bits_equal": bool(torch.equal(out["tb"], st.tb)),
        "ack_equal": errs["ack"] == 0, "ri_equal": errs["ri"] == 0,
        "cqi_equal": errs["cqi"] == 0, "cqi_crc_ok": errs["cqi_crc_fail"] == 0,
        "turbo_win_2_per_iteration": launches["turbo_win"] == 2 * sum(its),
        "viterbi_launched": launches["viterbi37"] > 0,
        "no_nii_launch": launches["turbo_nii"] == 0,
    }
    reps = 3
    e0.record()
    for _ in range(reps):
        run_uplink(st, UL_N0)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1) / reps
    tbs = st.plan.tbs
    emit({"phase": "uplink_path", "batch": BATCH, "nof_prb": 100,
          "n_prb": st.cfg.n_prb, "mcs": 20, "tbs": tbs, "n0": UL_N0,
          "q_cqi": st.plan.q_cqi, "q_ri": st.plan.q_ri,
          "q_ack": st.plan.q_ack, "tx_s": round(tx_s, 3),
          "ms_per_batch": ms, "ms_counted_run": ms_first,
          "mbps": BATCH * tbs / (ms * 1e-3) / 1e6,
          "turbo_iterations": its, "launches": launches,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
          "checks": checks})
    failed = [k for k, v in checks.items() if not v]
    assert not failed, f"uplink path checks failed: {failed}"
    return launches, vit


def phase_uplink_midsnr():
    """The uplink path at a mid SNR, where the early stop iterates.
    UCI errors are reported, not gated (its codes may fail here)."""
    import torch

    from empower_srslte_tpu_torch.models.ue_ul import ul_uci_stimulus

    st = ul_uci_stimulus(BATCH, UL_N0_MID, device="cuda")
    run_uplink(st, UL_N0_MID)                              # warm-up
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out, its = run_uplink(st, UL_N0_MID)
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1)
    bler = 1.0 - float(out["crc_ok"].float().mean())
    good = int(out["crc_ok"].sum())
    emit({"phase": "uplink_midsnr", "batch": BATCH, "n0": UL_N0_MID,
          "ms_per_batch": ms, "bler": bler,
          "mbps_decoded": good * st.plan.tbs / (ms * 1e-3) / 1e6,
          "turbo_iterations": its, "uci_errors": uci_errors(out, st.plan)})
    assert its[0] > 1, f"mid-SNR run did not iterate: {its}"
    assert bler <= 0.5, f"mid-SNR BLER {bler}"


def n_candidates() -> int:
    """Blind-search candidates of the main path (20 MHz, cfi 1, sf 1,
    RNTI 0x1234): the Viterbi batch is BATCH x this many words."""
    from empower_srslte_tpu_torch.models.pdcch import ue_search_candidates
    from empower_srslte_tpu_torch.models.regs import pdcch_nof_cces
    from empower_srslte_tpu_torch.utils.cell import Cell

    cell = Cell(nof_prb=100, nof_ports=2, id=1)
    return len(ue_search_candidates(0x1234, 1, pdcch_nof_cces(cell, 1)))


def main() -> int:
    import torch

    import empower_srslte_tpu_torch  # noqa: F401  (fails outside the repo)
    from empower_srslte_tpu_torch.ops.fec.convcoder import TRAIN_LEN

    global BASELINE
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if "--baseline" in sys.argv:
        import importlib.util

        path = sys.argv[sys.argv.index("--baseline") + 1]
        spec = importlib.util.spec_from_file_location("baseline", path)
        BASELINE = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(BASELINE)
    phase_device()
    phase_build()
    turbo = turbo_kernel_check()
    words = BATCH * n_candidates()
    vit = viterbi_kernel_check(
        "kernel_viterbi", [(55, words), (44, words)], seed=3,
        extra=[(20, 512, TRAIN_LEN, "noisy"), (64, 512, TRAIN_LEN, "noisy"),
               (256, 512, TRAIN_LEN, "noisy"), (55, 512, None, "noisy"),
               (256, 256, None, "noisy"), (55, 512, TRAIN_LEN, "ints"),
               (20, 512, None, "ints")])
    win = turbo_win_kernel_check()
    rec_launches, rec = recursion_kernel_check()
    launches = phase_main_path()
    ul_launches, vit_ul = phase_uplink()
    phase_uplink_midsnr()
    emit({"kernels": [
        {"name": "turbo_nii", "route": "cuda",
         "source": "empower_srslte_tpu_torch/csrc/turbo_nii.cu",
         "replaces": "empower_srslte_tpu/ops/fec/turbo_decoder_pallas2.py:220",
         "launches": launches["turbo_nii"], **turbo, "library_ms": None},
        {"name": "viterbi37", "route": "cuda",
         "source": "empower_srslte_tpu_torch/csrc/viterbi37.cu",
         "replaces": "empower_srslte_tpu/ops/fec/viterbi_pallas.py:146",
         "launches": launches["viterbi37"], **vit, "library_ms": None,
         "uplink": {"launches": ul_launches["viterbi37"], **vit_ul}},
        {"name": "turbo_win", "route": "cuda",
         "source": "empower_srslte_tpu_torch/csrc/turbo_win.cu",
         "replaces": "empower_srslte_tpu/ops/fec/turbo_decoder_pallas.py:196",
         "launches": ul_launches["turbo_win"], **win, "library_ms": None},
        {"name": "recursion_probe", "route": "cuda",
         "source": "empower_srslte_tpu_torch/csrc/recursion_probe.cu",
         "replaces": "tools/microbench_vpu.py:55",
         "launches": rec_launches, **rec, "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
