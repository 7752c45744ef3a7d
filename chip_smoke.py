#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch twin on the card, then drives the main path —
the no-genie 20 MHz 2x2 TM4 two-codeword UE downlink receiver — on a
batch of 256 subframes and checks what it decodes.

    python3 chip_smoke.py

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
#: float32 adds/subs/maxes per trellis step and window in the NII kernel,
#: counted from csrc/turbo_nii.cu: backward step 2 gamma + 2 scale
#: + 1 apr add + 16 adds + 8 maxes + 1 (renorm share) = 30; forward step
#: 2 + 2 + 1 + 16 (branch) + 16 (totals) + 14 maxes + 2 (ext) + 8 maxes
#: + 1 (renorm share) = 62
NII_OPS_PER_STEP = 92


def emit(obj):
    print(json.dumps(obj), flush=True)


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
    took = cuda_build.build(["turbo_nii", "viterbi37"])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    ptxas = {}
    for name, log in cuda_build.BUILD_LOGS.items():
        (OUT_DIR / f"build_{name}.log").write_text(log)
        ptxas[name] = [ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_source_s": {k: round(v, 3) for k, v in took.items()},
          "ptxas": ptxas})


def turbo_kernel_check():
    """One map_decode_nii call at the main path's geometry (5120 code
    blocks of K=5760, l=240) against the plain twin, then one full
    decode of 64 code blocks where the hard bits must be equal."""
    import numpy as np
    import torch

    from empower_srslte_tpu_torch.ops.fec.turbo_decoder import TurboDecoder
    from empower_srslte_tpu_torch.ops.fec.turbo_encoder import turbo_encode
    from empower_srslte_tpu_torch.ops.fec.turbo_nii import (
        map_decode_nii, map_decode_nii_plain)
    from empower_srslte_tpu_torch.utils.crc import CRC24B

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)
    k, l, b = 5760, 240, 2 * BATCH * 10
    w = k // l
    rn = lambda *s, sc=4.0: torch.randn(*s, generator=g, device=dev) * sc
    args = (rn(k, b), rn(k, b), rn(3, b), rn(3, b), rn(w + 1, 8, b, sc=2.0),
            rn(w + 1, 8, b, sc=2.0))
    apr = rn(k, b)
    got = map_decode_nii(*args, l=l, apr=apr)
    ref = map_decode_nii_plain(*args, l=l, apr=apr)
    torch.cuda.synchronize()
    err = max(float((x - y).abs().max()) for x, y in zip(got, ref))
    rel = max(float(((x - y).abs() / (1.0 + y.abs())).max())
              for x, y in zip(got, ref))
    # same float32 operations in the same order on both sides: agreement
    # to float32 rounding (rtol 1e-5 relative to 1 + |value|)
    assert rel <= 1e-5, f"NII kernel vs plain twin: rel err {rel}"

    ms = cuda_ms(lambda: map_decode_nii(*args, l=l, apr=apr), reps=10)
    plain_ms = cuda_ms(lambda: map_decode_nii_plain(*args, l=l, apr=apr),
                       reps=1)
    # compulsory traffic: u, p, apr, tails, a_st, b_st in; ext, a/b out
    nbytes = 4 * (4 * k * b + 2 * 3 * b + 4 * (w + 1) * 8 * b)
    ops = NII_OPS_PER_STEP * k * b
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3

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
    emit({"phase": "kernel_turbo", "cbs": b, "k": k, "window": l,
          "max_abs_err": err, "max_rel_err": rel, "ms": ms,
          "plain_ms": plain_ms, "decode_cbs": nb, "decode_iterations": it_k,
          "decode_bit_errors": n_err, "hard_bits_equal": True})
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def viterbi_kernel_check(n_cand: int):
    """Both DCI sizes of the main path's blind search (K=55 and K=44,
    ``BATCH * n_cand`` words each) against the plain twin."""
    import torch

    from empower_srslte_tpu_torch.ops.fec.convcoder import (
        TRAIN_LEN, conv_encode, viterbi_decode_plain)
    from empower_srslte_tpu_torch.ops.fec.viterbi37 import (
        viterbi_decode_cuda, viterbi_regs_cuda)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    words = BATCH * n_cand
    ms = plain_ms = err = 0.0
    nbytes = ops = 0
    mism = 0
    for k in (55, 44):
        u = torch.randint(0, 2, (words, k), generator=g, device=dev)
        d = conv_encode(u).to(torch.float32)
        llr = (1.0 - 2.0 * d
               + 0.8 * torch.randn(d.shape, generator=g, device=dev))
        got = viterbi_decode_cuda(llr)
        ref = viterbi_decode_plain(llr)
        torch.cuda.synchronize()
        mism += int((got != ref).sum())
        err = max(err, float((got.int() - ref.int()).abs().max()))
        halo = min(TRAIN_LEN, k)
        ms += cuda_ms(lambda: viterbi_regs_cuda(llr, halo), reps=20)
        plain_ms += cuda_ms(lambda: viterbi_decode_plain(llr), reps=1)
        n_regs = (k - 1) // 32 + 1
        steps = 2 * halo + k
        nbytes += 4 * words * (3 * k + n_regs)
        # per step and word: 64 states x (2 adds, compare, select, sub)
        # + 8 branch metrics; register exchange: 4 ops per word and state
        # on the K middle steps, 1 (select) on the flush halo
        ops += words * (steps * (64 * 5 + 8) + 64 * n_regs * (4 * k + halo))
    assert mism == 0, f"Viterbi kernel decisions differ in {mism} bits"
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    emit({"phase": "kernel_viterbi", "words_per_size": words,
          "ks": [55, 44], "mismatched_bits": mism, "ms": ms,
          "plain_ms": plain_ms})
    return dict(max_abs_err=err, mismatched_bits=mism, ms=ms,
                plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


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

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    phase_device()
    phase_build()
    turbo = turbo_kernel_check()
    vit = viterbi_kernel_check(n_candidates())
    launches = phase_main_path()
    emit({"kernels": [
        {"name": "turbo_nii", "route": "cuda",
         "source": "empower_srslte_tpu_torch/csrc/turbo_nii.cu",
         "replaces": "empower_srslte_tpu/ops/fec/turbo_decoder_pallas2.py:220",
         "launches": launches["turbo_nii"], **turbo, "library_ms": None},
        {"name": "viterbi37", "route": "cuda",
         "source": "empower_srslte_tpu_torch/csrc/viterbi37.cu",
         "replaces": "empower_srslte_tpu/ops/fec/viterbi_pallas.py:146",
         "launches": launches["viterbi37"], **vit, "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
