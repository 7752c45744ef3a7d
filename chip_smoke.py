#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port: builds the CUDA kernels, holds each
against its plain PyTorch twin on the card (both turbo kernels in float32
and in bfloat16, timed in turns), then drives the port's paths on a batch
of 256 subframes each and checks what they decode. Every decode with a
turbo window runs the bfloat16 kernels (``TurboDecoder(dtype="auto")``,
as the JAX package on its accelerator); each path phase holds every turbo
shape it launched against the twin of that shape's dtype:

* the no-genie 20 MHz 2x2 TM4 two-codeword UE downlink receiver
  (control kernels, NII turbo kernel);
* the 20 MHz eNB PUSCH receiver with UCI (windowed turbo kernel, Viterbi
  kernel for the CQI), at a high and at a mid SNR;
* the recursion-rate probe tool (its own kernel);
* the CRS channel and noise estimate kernel against its twin at every
  shape the receive paths give it, and its launches a path call
  (``chest_dl``);
* the de-rate-matching kernel (the DL-SCH / UL-SCH code blocks straight
  into the turbo decoder's time-major inputs) against its twin at the
  receive paths' shapes and at generated ones (K 40-6144, filler bits,
  repetitions, softbuffers on both LLR lanes, rv 0-3), timed beside its
  bound and the chain it replaced, and its launches a path call
  (``sch_derm``); every path phase holds it at the shapes it launched;
* the control kernels (the PCFICH and the PDCCH LLRs, the blind search)
  against their twins on the main path's control region at 256 and 1
  subframes and on generated regions of 6-100 PRB, 1-4 ports, CFI 1-3,
  the extended CP and an SNR where most candidates are noise, timed
  beside their bounds, and their launches a path call (``pdcch_rx``);
* the turbo encoder kernel against its twin, bit for bit, at all 188 K
  of 36.212 Table 5.1.3-3, on int64 and bool inputs with leading dims,
  and at the transmitter cell's shape (2 codewords x 256 subframes x 13
  code blocks of K 5824), timed beside its bound and the byte walk it
  replaced, and its launches an ``enb_dl_tx_batch`` call (``turbo_enc``);
* the PDCCH transmit kernel against its twin, the grid bit for bit, at
  6-100 PRB, 1, 2 and 4 ports, CFI 1-3, L 1-8, 1-11 DCIs, random,
  all-zero and all-one payloads and leading dims; its launches an
  ``enb_dl_tx_batch`` call, the control range under
  ``torch.cuda.set_sync_debug_mode("error")``, a changed DCI changing
  the samples, the control range's chain of CUDA graphs equal to the
  eager composer (with control values that change every call, one chain
  for all of them, and with no DCI or HI), and the kernel alone at the
  transmitter cell's shape (``pdcch_tx``);
* the eNB's downlink transmitter ``enb_dl_tx_batch`` at the benchmark
  cell's shape (256 subframes of the 20 MHz 2x2 TM4 grant at MCS 28 with
  both grants' DCIs and a HARQ indicator), held to the plain reference
  ``phybench/references/dl_tx.py`` on 4 subframes, with its launches
  (``enb_dl_tx``; the turbo encoder and PDCCH kernels, once a call each,
  the PDCCH kernel held to its twin at the shapes it launched);
* the PDSCH in TM2 on 4 ports (SFBC-FSTD) on the float32 and the int8
  LLR lanes and in TM3 (CDD, 2 codewords), genie channel (NII kernel);
* the per-subframe no-genie receiver ``ue_dl_decode`` over a radio frame
  of a 4-port TM2 cell with PHICH, an SI-RNTI format 1C grant and an
  int8-lane HARQ retransmission (both kernels);
* ``pusch_decode`` on the int8 lane (windowed turbo kernel), and on the
  stack's Msg3 grant, whose code block size has no turbo window (NII
  kernel, one window per code block);
* a UE's cold start on a 26-subframe 20 MHz capture: cell search,
  PSS/SSS sync and CFO, the MIB on the PBCH and the first data grant
  (Viterbi kernel at K 40, both kernels for the grant), plus the
  one-rx-antenna format-2 subframe;
* the 2-port PBCH blind decode of 256 subframe-0 grids (one Viterbi
  launch of 1024 words at K 40);
* the eNB's uplink control on a busy 20 MHz TTI: SR, ACKs on PUCCH
  formats 1a/1b, CQI and RI on format 2, CQI + ACKs on 2b and a wideband
  SRS from the summed signals of eight UEs, one with timing advance and
  CFO pre-compensation, the SR user silent in half the subframes (no
  kernel);
* PRACH detection on 256 format-0 windows with the stack's settings, a
  restricted-set batch, one window of each of formats 1-4 and a
  noise-only batch (no kernel);
* 256 MBSFN subframes (PMCH at MCS 16, 100 PRB) from the transmitter to
  decoded bits, and one MCCH subframe at MCS 2 (NII kernel);
* the plain PyTorch XLA-scan turbo decoders (full and windowed sweep) on
  64 code blocks of K 1024 (no kernel);
* the eNB/UE/EPC stack on a 25-PRB cell, TTI by TTI over the IQ air:
  attach with S1AP over a local socket on a 15 dB air, then a ping and a
  pong on the user plane (``stack_attach``); TM4's two codewords on a
  2-port cell (``stack_tm4``); a UE's cold boot from cell search to
  attach (``stack_cold_boot``); then the JAX stack tests' remaining
  scenarios with their asserts as checks: two UEs on a 20 MHz cell, their
  uplink summed (``stack_multi_ue``); SR/BSR, periodic CQI, DL and UL
  HARQ, SRB1 over RLC AM and radio-link failure (``stack_mac_harq``);
  paging, periodic TAU and the TAU on a TAC change (``stack_idle``); the
  S1 handover and idle reselection between two eNBs on one channel, and
  the cell-selection rejections (``stack_mobility``); subband CQI and
  periodic RI (``stack_csi``); these run the scenarios of
  ``tools/stack_scenarios.py``, which the CPU tests run too. Each phase
  times every ``enb.tti`` and ``ue.tti`` and holds both kernels to their
  twins at every shape it launched;
* the README's example chain at 20 MHz through the example programs'
  own entry points (``empower_srslte_tpu_torch.apps``): ``pdsch_enodeb``
  writes 10 frames (MCS 16 on 98 PRB) and ``pdsch_ue`` syncs and decodes
  every subframe on the card (``app_pdsch``); ``iq_capture`` copies the
  capture through the native ring buffer (``csrc/ring_buffer.cpp``, built
  by ``g++``), ``cell_measurement`` measures it and ``pdsch_ue`` decodes
  it again (``app_stream``); ``cell_search`` finds the cell and reads the
  MIB of a 6-PRB capture (Viterbi kernel at K 40) and finds the cell of
  the 20 MHz one (``app_cell_search``). Each phase holds both kernels to
  their twins at every shape it launched;
* the multi-device layer (``empower_srslte_tpu_torch/parallel/``): the
  trellis-sharded NII decode on in-process meshes of 2 and 4 shards on
  one card, each shard its own ``turbo_nii`` float32 launch with its own
  bounds, bit-identical to the one-device decode at K 6144 and on a TTI
  of the main path, and the halo-exchange sweeps (``parallel_sp``); the
  main path's batch split over a 4-shard mesh, equal to the unsharded
  call, and the 6-PRB validation chain over a (2, 2) mesh
  (``parallel_batch``); the multi-process dry run, 2 processes over gloo
  on the one card (again over NCCL, one card per process, where two or
  more are visible) (``multihost``);
* the main path's and the uplink path's stimulus with the turbo decoders
  pinned to float32 and at "auto" (bfloat16), in turns
  (``precision_pair``);
* the port's BLER sweep tool on the card, float32 against bfloat16 for
  both turbo decoders and both LLR lanes, which must keep each bfloat16
  curve within 0.1 dB of its float32 curve and every curve below srsLTE's
  (``bler_gate``);
* the port's end-to-end receiver BLER sweep (``tools/rx_bler_sweep.py``)
  at 50 PRB for MCS 4, 12 and 22, float32 against "auto" (bfloat16) on
  the same noise: the float32 curves must match the JAX package's on the
  JAX tool's own inputs, and each "auto" curve lie within 0.1 dB of its
  float32 curve across the waterfall (``rx_bler_gate``; NII kernel);
* the port's weak-scaling sweep (``tools/scaling_sweep.py``): the sharded
  20 MHz TM4 step at 1, 2 and 4 shards of one card, every CRC passing
  (``scaling_sweep``; the plain XLA sweeps, no kernel).

    python3 chip_smoke.py [--baseline FILE] [--phases NAME,...]

``--baseline PATH[,PATH...]`` names earlier designs to time beside the
port's kernels. A PATH is a Python file that defines ``PTXAS`` (its
ptxas log per kernel name) and any of ``map_decode_nii``,
``map_decode_win`` and ``viterbi_regs``, with the signatures of the
port's ``map_decode_nii``, ``map_decode_win`` and ``viterbi_regs_cuda``;
a directory holding an earlier ``turbo_nii.cu`` and/or ``turbo_win.cu``
with the one-warp designs' C interface (``source_baseline``), which the
build compiles under names of their own; or ``split_aligned`` /
``split_shifted``, the port's own bfloat16 split kernels forced at every
shape (``forced_split_baseline``: where the plans' rule would take the
one-thread kernel, and the two column stagings against each other).
Each kernel check with a baseline then times it and the port's kernel in
turns (baseline, port, port, baseline), the turbo kernels in both dtypes
at the main or uplink shape, at one code block and over a sweep of
batches (``BASELINE_SWEEP``), and puts both on its phase line.

``--phases`` runs the build and the named phases alone (any of the
chest kernel's ``chest_dl``, the control kernels' ``pdcch_rx``, the
de-rate-matching kernel's ``sch_derm``, the turbo encoder kernel's
``turbo_enc``, the PDCCH transmit kernel's ``pdcch_tx``, the
transmitter's ``enb_dl_tx``, the downlink paths
``main_path``, ``tm2``, ``tm3``, ``pmch``, ``ue_dl_frame`` and
``cold_boot``, the BLER gate ``bler_gate``, the
turbo kernel checks ``kernel_turbo``
and ``kernel_turbo_win``, of
``parallel_sp``, ``parallel_batch`` and ``multihost``, the phases that
use a second card where one is visible, and the stack scenario phases
``stack_multi_ue``, ``stack_mac_harq``, ``stack_idle``,
``stack_mobility`` and ``stack_csi``, the two tools' phases
``rx_bler_gate`` and ``scaling_sweep``, the uplink's ``uplink_path``,
``uplink_midsnr``, ``uplink_int8``, ``uplink_msg3``, ``ul_control`` and
``precision_pair``, and the stack's ``stack_attach``, ``stack_tm4`` and
``stack_cold_boot``), then the last line with
``"phases"`` naming them, and no kernels line.

Needs one CUDA card (H100, sm_90a) and the CUDA toolkit's nvcc. Prints
one JSON line per phase (also written to chiprun_out/chip_smoke/
phases.jsonl), the card's name and power limit as nvidia-smi
reports them, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}`` — only when every phase passed. Any
failure exits nonzero. Build logs go to chiprun_out/chip_smoke/, the
apps' captures to chiprun_out/chip_smoke/apps/ (the 20 MHz ones are
deleted when the app phases end).
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
#: the bfloat16 rate outside the tensor cores: 133.8 TFLOP/s "peak BF16
#: (non-Tensor)" for the H100 SXM5 (NVIDIA H100 Tensor Core GPU
#: Architecture white paper, the data-center GPU comparison table), which
#: counts a bf16x2 FMA as 4 flops; adds, subtractions and maxes on bf16x2
#: are 2 element operations per instruction, so 66.9e12 element operations
#: per second that are not FMAs. The recursion probe's bf16 lane measures
#: the add/max rate this code reaches (``kernel_recursion``), printed beside
#: every bfloat16 bound
PEAK_BF16_OPS_PER_S = 66.9e12

BATCH = 256
#: the uplink path's noise per grid RE: high SNR, and a mid SNR at which
#: the early stop iterates (bench.py MIDSNR_N0["20ul"])
UL_N0, UL_N0_MID = 1e-3, 0.045
#: the genie-channel downlink phases: noise per RE (bench.py:149), the
#: TM2 grant's MCS and the TM3 grant's (the "20mimo" MCS, bench.py:153)
DL_N0, TM2_MCS, TM3_MCS = 1e-3, 20, 27
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
#: the Pallas site each turbo kernel source replaces
REPLACES = {
    "turbo_nii": "empower_srslte_tpu/ops/fec/turbo_decoder_pallas2.py:220",
    "turbo_win": "empower_srslte_tpu/ops/fec/turbo_decoder_pallas.py:196"}
#: code blocks per Eb/N0 point of the BLER gate (``phase_bler_gate``)
BLER_CBS = 32768
#: ptxas report of each built kernel (phase_build), for the phase lines
PTXAS: dict = {}
#: the --baseline designs: (name, module or namespace) per PATH
BASELINES: list = []
#: the bfloat16 launches a baseline is timed at besides the main and
#: uplink shapes: NII (K, l, code blocks), windowed (K, code blocks)
BASELINE_SWEEP = {
    "turbo_nii": [(144, 144, 2), (144, 144, 5), (144, 144, 64),
                  *((5760, 240, b) for b in (2, 16, 64, 256, 640, 1280, 1536,
                                             1792, 2048, 2560, 3584, 5119))],
    "turbo_win": [(1024, 2), (1024, 5), (1024, 64),
                  *((5824, b) for b in (2, 16, 64, 256, 512, 896, 1791, 2304,
                                        2560, 2816, 3072))]}
#: per kernel, the error against the twin at each geometry that a path
#: phase gives the kernel (``hold_shapes``, ``vit_path_check``); the turbo
#: kernels per metric dtype
PATH_TWIN: dict = {"turbo_nii": {}, "turbo_nii_bf16": {}, "turbo_win": {},
                   "turbo_win_bf16": {}, "viterbi37": {}, "pdcch_rx": {},
                   "sch_derm": {}, "chest_dl": {}, "pdcch_tx": {}}


def emit(obj):
    """One JSON line on stdout, and the same line appended to
    ``chiprun_out/chip_smoke/phases.jsonl``, which keeps every phase line
    where a log of stdout keeps only its end."""
    line = json.dumps(obj)
    print(line, flush=True)
    with open(OUT_DIR / "phases.jsonl", "a") as f:
        f.write(line + "\n")


def bound(nbytes: float, ops: float, dtype: str = "float32") -> dict:
    """Least time for the work: bytes over the HBM rate or operations over
    the non-FMA rate of their type ("float32" or "bfloat16"), whichever
    is larger."""
    rate = PEAK_BF16_OPS_PER_S if dtype == "bfloat16" else PEAK_F32_OPS_PER_S
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def dt_name(dtype) -> str:
    """A torch dtype's name, "float32" or "bfloat16": the turbo wrappers'
    key in their per-shape launch counts, and this script's dtype
    argument."""
    return str(dtype).removeprefix("torch.")


def card_sms() -> int:
    """SMs of the card the kernels run on (the bfloat16 plans' rule reads
    them)."""
    import torch

    from empower_srslte_tpu_torch.utils.device import sm_count

    return sm_count(torch.device("cuda", torch.cuda.current_device()))


def itemsize(dtype: str) -> int:
    return 2 if dtype == "bfloat16" else 4


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


def dtype_turns(f32_fn, bf16_fn, reps: int) -> dict:
    """A kernel's float32 and bfloat16 launches timed in turns (float32,
    bfloat16, bfloat16, float32): -> the mean ms of each and the turns."""
    a1 = cuda_ms(f32_fn, reps)
    b1 = cuda_ms(bf16_fn, reps)
    b2 = cuda_ms(bf16_fn, reps)
    a2 = cuda_ms(f32_fn, reps)
    return {"float32": (a1 + a2) / 2, "bfloat16": (b1 + b2) / 2,
            "turns_ms": [a1, b1, b2, a2]}


def ptxas_of(source: str, tag: str) -> dict:
    """The ptxas report of the entry functions of ``source`` whose name
    holds ``tag`` (the float32 and bfloat16 instances of a template)."""
    return {k: v for k, v in PTXAS.get(source, {}).items() if tag in k}


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


def baseline_pairs(attr: str, port, cases: dict) -> dict:
    """Every baseline defining ``attr`` timed in turns with the port's
    kernel ``port`` (baseline, port, port, baseline) on each case of
    ``cases``: {name: (args, kwargs, the twin's output, timer)} -> {baseline:
    {"ptxas": ..., case: {ms, baseline_ms, turns_ms,
    baseline_max_abs_err}}}."""
    kernel = {"map_decode_nii": "turbo_nii",
              "map_decode_win": "turbo_win"}[attr]
    out = {}
    for name, fn, ptxas in baseline_fns(attr):
        out[name] = {"ptxas": ptxas_summary(ptxas.get(kernel, ""))}
        for case, (args, kw, ref, timer) in cases.items():
            out[name][case] = {
                **paired_ms(lambda: port(*args, **kw),
                            lambda: fn(*args, **kw), reps=10, timer=timer),
                "baseline_max_abs_err": max_abs_err(fn(*args, **kw), ref)}
    return out


def ptxas_registers(report: dict) -> int:
    """The most registers an entry function of a ptxas report uses."""
    return max((v["registers"] for v in report.values()), default=0)


def kernel_design(module: str, dtype: str, plan) -> dict:
    """The design a turbo launch ran ("one_thread": a thread per code
    block, or code block pair in bf16x2; "split": a window of a code block
    pair shared by an alpha-side and a beta-side thread, staging a lane's
    pair from one aligned word or, "shifted", from two) with its threads
    per code block and registers (the most over its instances), and in
    bfloat16 both designs' (the NII split kernel's 8-row instances; its
    16-row ones, for windows too long for 8-row checkpoints, apart)."""
    stem = module.removeprefix("turbo_")
    ops = "9OpsBf16x2" if dtype == "bfloat16" else "6OpsF32"
    designs = {"one_thread": {
        "threads_per_cb": 0.5 if dtype == "bfloat16" else 1.0,
        "registers": ptxas_registers(
            ptxas_of(module, f"{stem}_kernelI{ops}"))}}
    if dtype == "bfloat16":
        split = ptxas_of(module, f"{stem}_split_kernelI{ops}")
        rows16 = {k: v for k, v in split.items() if "Li16E" in k}
        designs["split"] = {"threads_per_cb": 1.0, "registers":
                            ptxas_registers({k: v for k, v in split.items()
                                             if k not in rows16})}
        if rows16:
            designs["split_16_row_segments"] = {
                "threads_per_cb": 1.0, "registers": ptxas_registers(rows16)}
    kind = "split" if plan.sides == 2 else "one_thread"
    cols = ({"columns": "shifted" if plan.shifted else "aligned"}
            if plan.sides == 2 else {})
    return {"design": kind, **cols, **designs[kind],
            **({"designs": designs} if dtype == "bfloat16" else {})}


def max_abs_err(got, ref) -> float:
    if isinstance(got, tuple):
        return max(max_abs_err(x, y) for x, y in zip(got, ref))
    return float((got.float() - ref.float()).abs().max())


def counted_run(run, reps: int = 3):
    """``run()`` once to warm up, once with every kernel's launch count at
    0 (CUDA events around it), then ``reps`` times for the time per call.
    -> (its result, launches, ms of the counted run, ms per call, peak
    device memory GB over the counted run and the timed repeats, launches
    per shape of the counted run)."""
    import torch

    run()                                              # warm-up
    open_counts()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    out = run()
    e1.record()
    torch.cuda.synchronize()
    launches, shapes = read_counts()
    ms_first = e0.elapsed_time(e1)
    e0.record()
    for _ in range(reps):
        run()
    e1.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    return out, launches, ms_first, e0.elapsed_time(e1) / reps, peak, shapes


def counted(fn):
    """``fn()`` with every launch count at 0: -> (its result, launches,
    launches per shape)."""
    import torch

    open_counts()
    out = fn()
    torch.cuda.synchronize()
    return (out, *read_counts())


def merge_shapes(*shapes) -> dict:
    """Per-shape launch counts of several counted runs, summed."""
    import collections

    out = collections.defaultdict(collections.Counter)
    for sh in shapes:
        for name, by in sh.items():
            out[name].update(by)
    return {name: dict(by) for name, by in out.items()}


def turbo_shapes(shapes: dict) -> dict:
    """The turbo decode's kernels' part of a run's launches per shape:
    the de-rate-matching kernel and the two turbo kernels."""
    return {k: shapes[k] for k in ("sch_derm", "turbo_nii", "turbo_win")
            if k in shapes}


def check(phase: str, checks: dict):
    failed = [k for k, v in checks.items() if not v]
    assert not failed, f"{phase} checks failed: {failed}"


def soft_bytes_per_tb(soft) -> int:
    """HARQ softbuffer bytes one TB keeps: every code block's buffer."""
    return sum(s.shape[-1] * s.element_size() for s in soft)


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


def source_baseline(path: pathlib.Path, tag: str):
    """An earlier design of the turbo kernels from its sources: ``path``
    holds ``turbo_nii.cu`` and/or ``turbo_win.cu`` whose launchers take
    one-warp blocks (32 threads, the shared bytes below) and, in bfloat16,
    an even batch (two code blocks per thread; an odd one is padded by a
    column and sliced back, as that design's wrappers did). They build
    with the port's sources (``phase_build``) as ``turbo_nii_<tag>`` and
    ``turbo_win_<tag>``. -> a namespace with ``SOURCES`` ({kernel: (library
    name, source)}), ``PTXAS`` and ``map_decode_nii`` / ``map_decode_win``
    for the sources present."""
    import ctypes
    import types

    import torch

    from empower_srslte_tpu_torch.utils import cuda_build

    ns = types.SimpleNamespace(SOURCES={}, PTXAS={})
    for kernel in ("turbo_nii", "turbo_win"):
        if (path / f"{kernel}.cu").exists():
            ns.SOURCES[kernel] = (f"{kernel}_{tag}",
                                  (path / f"{kernel}.cu").resolve())

    def launcher(kernel, dtype, nargs):
        lib = cuda_build.load(*ns.SOURCES[kernel])
        fn = getattr(lib, f"{kernel}_launch"
                     + ("_bf16" if dtype == torch.bfloat16 else ""))
        fn.argtypes = [ctypes.c_void_p] * nargs + [ctypes.c_int] * (
            17 - nargs if kernel == "turbo_nii" else 10 - nargs) \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        return fn

    def even(x):
        return torch.nn.functional.pad(x, (0, 1)) if x.shape[-1] % 2 else x

    def stream(x):
        return torch.cuda.current_stream(x.device).cuda_stream

    def map_decode_nii(u, p, tail_u, tail_p, a_st, b_st, *, l, apr=None,
                       bounds=None):
        k, b = u.shape
        w = k // l
        first, last = (0, w - 1) if bounds is None else bounds
        if u.dtype == torch.bfloat16 and b % 2:
            u, p, tail_u, tail_p, a_st, b_st = map(
                even, (u, p, tail_u, tail_p, a_st, b_st))
            apr = None if apr is None else even(apr)
        nseg = -(-l // 16)
        smem = 32 * (32 * (nseg - 1) + 4 * 2 * 16 * (2 if apr is None
                                                      else 3))
        ext, a_next, b_next = map(torch.empty_like, (u, a_st, b_st))
        rc = launcher("turbo_nii", u.dtype, 10)(
            u.data_ptr(), p.data_ptr(), None if apr is None else
            apr.data_ptr(), tail_u.data_ptr(), tail_p.data_ptr(),
            a_st.data_ptr(), b_st.data_ptr(), ext.data_ptr(),
            a_next.data_ptr(), b_next.data_ptr(), u.shape[1], l, w, first,
            last, 32, smem, stream(u))
        assert rc == 0, f"baseline turbo_nii: CUDA error {rc}"
        return tuple(x[..., :b] for x in (ext, a_next, b_next))

    def map_decode_win(lsa, lp, *, k, l, o):
        b = lsa.shape[1]
        if lsa.dtype == torch.bfloat16 and b % 2:
            lsa, lp = even(lsa), even(lp)
        bp = lsa.shape[1]
        llr = torch.empty((k, bp), dtype=lsa.dtype, device=lsa.device)
        ckpt = torch.empty((l // 8 - 1, 8, k // l * bp), dtype=lsa.dtype,
                           device=lsa.device)
        rc = launcher("turbo_win", lsa.dtype, 4)(
            lsa.data_ptr(), lp.data_ptr(), llr.data_ptr(), ckpt.data_ptr(),
            bp, k, l, o, 32, 32 * 4 * 2 * 8 * 4, stream(lsa))
        assert rc == 0, f"baseline turbo_win: CUDA error {rc}"
        return llr[:, :b]

    if "turbo_nii" in ns.SOURCES:
        ns.map_decode_nii = map_decode_nii
    if "turbo_win" in ns.SOURCES:
        ns.map_decode_win = map_decode_win
    return ns


def forced_split_baseline(shifted: bool):
    """The port's bfloat16 split kernels launched at every shape, from the
    port's libraries: on ShiftedCols at every batch when ``shifted``, else
    on AlignedCols where the batch is even (float32 runs the port's
    wrappers). -> a namespace with ``PTXAS``, ``map_decode_nii`` and
    ``map_decode_win``."""
    import types

    import torch

    from empower_srslte_tpu_torch.ops.fec import turbo_nii, turbo_win

    bf16 = torch.bfloat16

    def map_decode_nii(u, p, tail_u, tail_p, a_st, b_st, *, l, apr=None,
                       bounds=None):
        if u.dtype != bf16:
            return turbo_nii.map_decode_nii(u, p, tail_u, tail_p, a_st, b_st,
                                            l=l, apr=apr, bounds=bounds)
        k, b = u.shape
        w = k // l
        first, last = (0, w - 1) if bounds is None else bounds
        # an odd cbs gives the shifted split plan, None the aligned one
        plan = turbo_nii.nii_plan(l, apr is not None, bf16,
                                  1 if shifted or b % 2 else None, w)
        ext, a_next, b_next = map(torch.empty_like, (u, a_st, b_st))
        rc = turbo_nii.NII_KERNELS[bf16].fn(
            u.data_ptr(), p.data_ptr(), None if apr is None else
            apr.data_ptr(), tail_u.data_ptr(), tail_p.data_ptr(),
            a_st.data_ptr(), b_st.data_ptr(), ext.data_ptr(),
            a_next.data_ptr(), b_next.data_ptr(), b, l, w, first, last,
            plan.threads, plan.segments[0][1], plan.shifted, plan.smem,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"forced split turbo_nii: CUDA error {rc}"
        return ext, a_next, b_next

    def map_decode_win(lsa, lp, *, k, l, o):
        if lsa.dtype != bf16:
            return turbo_win.map_decode_win(lsa, lp, k=k, l=l, o=o)
        b = lsa.shape[1]
        plan = turbo_win.win_plan(l, o, bf16, 1 if shifted or b % 2 else None,
                                  k // l)
        llr = torch.empty((k, b), dtype=bf16, device=lsa.device)
        rc = turbo_win.WIN_KERNELS[bf16].fn(
            lsa.data_ptr(), lp.data_ptr(), llr.data_ptr(), None, b, k, l, o,
            plan.threads, plan.shifted, plan.smem,
            torch.cuda.current_stream().cuda_stream)
        assert rc == 0, f"forced split turbo_win: CUDA error {rc}"
        return llr

    return types.SimpleNamespace(PTXAS={}, map_decode_nii=map_decode_nii,
                                 map_decode_win=map_decode_win)


def load_baselines(arg: str) -> list:
    """The ``--baseline`` designs: (name, module) per comma-separated
    PATH, a Python file, a directory of sources (``source_baseline``) or
    ``split_aligned`` / ``split_shifted`` (``forced_split_baseline``)."""
    import importlib.util

    out = []
    for i, part in enumerate(arg.split(",")):
        path = pathlib.Path(part)
        name = f"{path.stem}{i}"
        if part in ("split_aligned", "split_shifted"):
            out.append((name, forced_split_baseline(part == "split_shifted")))
            continue
        if path.is_dir():
            out.append((name, source_baseline(path, f"base{i}")))
            continue
        spec = importlib.util.spec_from_file_location(f"baseline{i}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out.append((name, mod))
    return out


def baseline_fns(attr: str) -> list:
    """(name, function, ptxas logs) of every baseline defining ``attr``."""
    return [(name, getattr(mod, attr), mod.PTXAS) for name, mod in BASELINES
            if hasattr(mod, attr)]


def phase_build():
    from empower_srslte_tpu_torch.utils import cuda_build

    t0 = time.perf_counter()
    # the --baseline designs' sources, built beside the port's
    sources = dict(src for _, mod in BASELINES
                   for src in getattr(mod, "SOURCES", {}).values())
    took = cuda_build.build([*cuda_build.KERNELS, "recursion_probe",
                             "ring_buffer", *sources], sources)
    for _, mod in BASELINES:
        for kernel, (name, _) in getattr(mod, "SOURCES", {}).items():
            mod.PTXAS[kernel] = cuda_build.BUILD_LOGS[name]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    for name, log in cuda_build.BUILD_LOGS.items():
        (OUT_DIR / f"build_{name}.log").write_text(log)
        PTXAS[name] = ptxas_summary(log)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "per_source_s": {k: round(v, 3) for k, v in took.items()},
          "ptxas": PTXAS})


def nii_inputs(g, k: int, l: int, b: int, apr: bool = True, bounds=None,
               dtype="float32"):
    """Random inputs of one ``map_decode_nii`` call on ``b`` code blocks
    of K=``k`` in windows of ``l``, in ``dtype``: (args, kwargs)."""
    import torch

    rn = lambda *s, sc=4.0: (torch.randn(*s, generator=g, device=g.device)
                             * sc).to(getattr(torch, dtype))
    w = k // l
    args = (rn(k, b), rn(k, b), rn(3, b), rn(3, b),
            rn(w + 1, 8, b, sc=2.0), rn(w + 1, 8, b, sc=2.0))
    return args, dict(l=l, apr=rn(k, b) if apr else None, bounds=bounds)


def nii_work(k: int, l: int, b: int, dtype="float32"):
    """(compulsory bytes, operations) of one ``map_decode_nii`` launch on
    ``b`` code blocks of K=``k`` in windows of ``l``: u, p, apr, tails,
    a_st, b_st read once; ext, a/b written once, at 4 or 2 bytes a
    value."""
    w = k // l
    return (itemsize(dtype) * (4 * k * b + 2 * 3 * b + 4 * (w + 1) * 8 * b),
            NII_OPS_PER_STEP * k * b)


def nii_shape_time(k: int, l: int, b: int, seed: int,
                   dtype="float32", bounds=None) -> dict:
    """The NII kernel timed at one launch shape and ``bounds``, in
    ``dtype``: ``ms`` over
    10 launches made one by one (at a small shape this reads the
    wrapper's host time, and in bfloat16 at an odd batch its padding),
    ``ms_graphed`` by CUDA-graph replay (the launches back to back on the
    card); its plain twin (one call) and its bound. The launches are not
    counted: no phase's count is open."""
    import torch

    from empower_srslte_tpu_torch.ops.fec.turbo_nii import (
        map_decode_nii, map_decode_nii_plain, nii_plan)

    g = torch.Generator(device="cuda").manual_seed(seed)
    args, kw = nii_inputs(g, k, l, b, bounds=bounds, dtype=dtype)
    plan = nii_plan(l, True, getattr(torch, dtype), b, k // l,
                    sms=card_sms())
    return {"k": k, "window": l, "cbs": b, "dtype": dtype,
            "design": "split" if plan.sides == 2 else "one_thread",
            "ms": cuda_ms(lambda: map_decode_nii(*args, **kw), reps=10),
            "ms_graphed": graph_ms(lambda: map_decode_nii(*args, **kw),
                                   reps=10),
            "plain_ms": cuda_ms(lambda: map_decode_nii_plain(*args, **kw),
                                reps=1),
            **bound(*nii_work(k, l, b, dtype), dtype)}


def nii_twin(args, kw):
    """The NII kernel and its plain twin on the same inputs: -> (max abs
    error, the twin's output). Both do the same adds in the same order and
    the same dtype (float32, or bfloat16 rounded per op), so the error
    must be exactly 0."""
    import torch

    from empower_srslte_tpu_torch.ops.fec.turbo_nii import (
        map_decode_nii, map_decode_nii_plain)

    got = map_decode_nii(*args, **kw)
    ref = map_decode_nii_plain(*args, **kw)
    torch.cuda.synchronize()
    return max_abs_err(got, ref), ref


def awgn_code_blocks(g, k: int, nb: int, ebn0_db: float):
    """``nb`` CRC24B-protected code blocks of K=``k`` through the turbo
    encoder and AWGN at ``ebn0_db``: -> (bits [nb, K], LLRs)."""
    import numpy as np
    import torch

    from empower_srslte_tpu_torch.ops.fec.turbo_encoder import turbo_encode
    from empower_srslte_tpu_torch.utils.crc import CRC24B

    rng = np.random.default_rng(5)
    payload = torch.as_tensor(rng.integers(0, 2, (nb, k - 24)),
                              device=g.device)
    u = torch.cat([payload, CRC24B.compute(payload)], -1).to(torch.int8)
    d = turbo_encode(u).to(torch.float32)
    n0 = 3.0 / 10 ** (ebn0_db / 10)
    y = 1.0 - 2.0 * d + (n0 / 2) ** 0.5 * torch.randn(d.shape, generator=g,
                                                       device=g.device)
    return u, 4.0 / n0 * y


def decode_vs_twin(dec, llr, u, twin) -> dict:
    """One full decode with the CRC early stop through the kernel and
    through its plain twin: hard bits and iteration counts must be
    equal."""
    import torch

    from empower_srslte_tpu_torch.utils.crc import CRC24B

    it_k, it_p = [], []
    bits_k, _ = dec.decode(llr, crc=CRC24B, iters_out=it_k)
    bits_p, _ = dec.decode(llr, crc=CRC24B, iters_out=it_p, map_decode=twin)
    assert torch.equal(bits_k, bits_p), \
        f"{dec.dtype} turbo hard bits differ from twin"
    assert it_k == it_p, (it_k, it_p)
    return {"decode_iterations": it_k,
            "decode_bit_errors": int((bits_k != u).sum()),
            "hard_bits_equal": True}


#: the CRS chest kernel against its plain twin on the CPU, which computes
#: the same float32 operations in the same order but for the sums of the
#: noise: the largest |dh| over max |h|, and the largest relative
#: difference of the noise. A few units in the last place of float32
#: (1.2e-7), where a wrong pilot, row or weight is off by order 1
CHEST_TOL = 2e-6
#: against the same twin run on the card. PyTorch's CUDA kernel for a
#: tensor divided by a Python scalar multiplies by the scalar's
#: reciprocal, so there the twin's interpolation weights j/6 round
#: differently (``div_mismatch`` counts them); at the upper band edge's
#: extrapolation, w = j/6 - (M - 2) with j up to 6M, the weight then
#: differs by up to ulp(200) = 1.5e-5, times |h[M-1] - h[M-2]| <= 2 max|h|
CHEST_TOL_CARD = 3e-5


def chest_bytes(cell, sf_idx: int, ports, n: int) -> int:
    """Compulsory bytes of one ``chest_dl`` launch over ``n`` grids: each
    port's pilot REs read once, its estimate [S, K] complex64 and its
    noise written once."""
    from empower_srslte_tpu_torch.ops.chest import _interp_plan

    pilots = sum(_interp_plan(cell, sf_idx, p)["re_idx"].size for p in ports)
    return n * (8 * pilots
                + len(ports) * (8 * cell.nsymb_sf * cell.nof_re + 4))


def chest_shape(g, cell, sf_idx: int, ports, lead, **taps) -> dict:
    """The kernel against its twin on random grids [*lead, S, K], timed
    (CUDA graph: the device time of a launch) beside its bound and the
    twin (one stacked plain estimate per port and the noise, CUDA
    events: the launches' host cost included)."""
    import torch

    from empower_srslte_tpu_torch.ops import chest

    shape = (*lead, cell.nsymb_sf, cell.nof_re)
    grid = torch.complex(torch.randn(shape, generator=g, device="cuda"),
                         torch.randn(shape, generator=g, device="cuda"))

    def twin():
        return (torch.stack([chest._chest_dl_plain(
                    grid, cell, sf_idx, p, taps.get("smooth", True),
                    taps.get("gauss_std")) for p in ports], dim=-3),
                torch.stack([chest._noise_est_plain(grid, cell, sf_idx, p)
                             for p in ports], dim=-1))

    def kernel():
        return chest.chest_dl_ports(grid, cell, sf_idx, ports, **taps)

    def errs(h, noise, h_ref, n_ref):
        return (float((h - h_ref).abs().max() / h_ref.abs().max()),
                float(((noise - n_ref).abs() / n_ref).max()))

    h, noise = kernel()
    h_ref, n_ref = twin()
    n_only = chest.noise_est_pilots(grid, cell, sf_idx, port=ports[0])
    h_err, n_err = errs(h, noise, h_ref, n_ref)
    ms, twin_ms = graph_ms(kernel, reps=20), cuda_ms(twin, reps=3)
    grid = grid.cpu()
    h_cpu, n_cpu = errs(h.cpu(), noise.cpu(), *twin())
    n = grid.numel() // (cell.nsymb_sf * cell.nof_re)
    return {"grids": n, "ports": list(ports), "nof_prb": cell.nof_prb,
            "cp": cell.cp.value, "sf_idx": sf_idx,
            "taps": len(chest.fir_taps(taps.get("smooth", True),
                                       taps.get("gauss_std"))),
            "h_err_cpu_twin": h_cpu, "noise_rel_err_cpu_twin": n_cpu,
            "h_err": h_err, "noise_rel_err": n_err,
            "noise_only_rel_err": float(
                ((n_only - n_ref[..., 0]).abs() / n_ref[..., 0]).max()),
            "ms": ms,
            **bound(chest_bytes(cell, sf_idx, ports, n), 0),
            "twin_ms": twin_ms}


def phase_chest_dl():
    """The CRS channel and noise estimate kernel (``csrc/chest_dl.cu``)
    against its plain twin at every shape the receive paths give it:
    ``ue_dl_tm4_batch`` at 256 and 1 subframes (2 rx, 2 ports, 100 PRB),
    ``ue_dl_decode``'s one rx (the 4-port TM2 frame's cell), the MIB's 6
    PRB, and each FIR, the extended CP and ports 2-3 besides; then the
    kernel launches a path call makes on those paths' own stimuli."""
    import torch

    from empower_srslte_tpu_torch.models import enb_dl
    from empower_srslte_tpu_torch.models.ue_dl import (ue_dl_decode,
                                                       ue_dl_tm4_batch,
                                                       ue_mib_acquire)
    from empower_srslte_tpu_torch.ops.equalizer import MimoType
    from empower_srslte_tpu_torch.utils.cell import CP, Cell

    st256 = enb_dl.tm4_stimulus(BATCH, device="cuda")
    st1 = enb_dl.tm4_stimulus(1, device="cuda")
    fr = enb_dl.tm2_frame_stimulus(device="cuda")
    tm4, sf = st1.cfg.cell, st1.cfg.sf_idx
    g = torch.Generator(device="cuda").manual_seed(61)
    shapes = {
        "tm4_b256": chest_shape(g, tm4, sf, (0, 1), (BATCH, 2)),
        "tm4_b1": chest_shape(g, tm4, sf, (0, 1), (1, 2)),
        "ue_dl_decode_1rx": chest_shape(g, fr.cell, 1,
                                        range(fr.cell.nof_ports), (1,)),
        "mib_6prb": chest_shape(g, Cell(nof_prb=6, id=1, nof_ports=1), 0,
                                (0,), (1,)),
        "tm4_b256_gauss": chest_shape(g, tm4, sf, (0, 1), (BATCH, 2),
                                      gauss_std=0.5),
        "tm4_b1_unsmoothed": chest_shape(g, tm4, sf, (0, 1), (1, 2),
                                         smooth=False),
        "ext_cp_25prb_4port": chest_shape(
            g, Cell(nof_prb=25, id=3, nof_ports=4, cp=CP.EXT), 5,
            (0, 1, 2, 3), (4, 2)),
    }

    def per_call(run):
        return launches_per_call(run, ["chest_dl"])["chest_dl"]

    paths = {
        "tm4_b256": lambda: ue_dl_tm4_batch(st256.samples, st256.cfg,
                                            st256.plan),
        "tm4_b1": lambda: ue_dl_tm4_batch(st1.samples, st1.cfg, st1.plan),
        "ue_dl_decode": lambda: ue_dl_decode(
            fr.samples[1], fr.cell, 1, fr.rnti, mimo=MimoType.DIVERSITY),
        "mib": lambda: ue_mib_acquire(st1.samples[0, 0], tm4, tm4.id),
    }
    launches = {name: per_call(run) for name, run in paths.items()}
    path_ms = {name: cuda_ms(paths[name], reps=3)
               for name in ("tm4_b256", "tm4_b1")}
    j = torch.arange(6 * 200, dtype=torch.float32)
    div_mismatch = int(((j.cuda() / 6.0).cpu() != j / 6.0).sum())
    checks = {
        "h_within_tol": all(v["h_err_cpu_twin"] <= CHEST_TOL
                            and v["h_err"] <= CHEST_TOL_CARD
                            for v in shapes.values()),
        "noise_within_tol": all(
            max(v["noise_rel_err_cpu_twin"], v["noise_rel_err"],
                v["noise_only_rel_err"]) <= CHEST_TOL
            for v in shapes.values()),
        "one_launch_a_path_call": all(v == 1 for v in launches.values()),
    }
    out = {"phase": "chest_dl", "tol": CHEST_TOL,
           "tol_card_twin": CHEST_TOL_CARD, "div_mismatch": div_mismatch,
           "shapes": shapes,
           "launches_per_call": launches, "path_ms": path_ms,
           "ptxas": PTXAS.get("chest_dl"), "checks": checks}
    emit(out)
    check("chest_dl", checks)
    return out


#: the control kernel's LLRs against the plain twin run on the CPU, as a
#: share of the twin's largest magnitude: float32 rounding, since
#: PyTorch's CPU complex division (Smith's algorithm, or its vector
#: form) and |h|^2 through the complex abs round otherwise than the
#: kernel's x / |h|^2 and re^2 + im^2; the twin run on the card differs
#: besides by CUDA's reciprocal division (``chest_dl``'s finding), as
#: ``llr_err_card_twin`` shows
PDCCH_LLR_TOL = 1e-5
#: the control phase's SNRs: the receivers' operating point, and one at
#: which most candidates are noise
PDCCH_SNR_DB, PDCCH_NOISE_SNR_DB = 20.0, -6.0


def ctrl_stimulus(g, prb: int, ports: int, cfi: int, cp, batch: int,
                  snr_db: float, sf_idx: int = 3, rnti: int = 0x1234):
    """``batch`` control regions on the card: the PCFICH and one format-1A
    PDCCH (the search space's first candidate of L 4 or less) over a flat
    channel per port and subframe (a random phase, the ports' powers
    summing to 1), with noise at ``snr_db``. -> (cell,
    grid [B, S, K], h [B, P, S, K], noise [B], sizes, candidates)."""
    import torch

    from empower_srslte_tpu_torch.models import dci as dci_mod
    from empower_srslte_tpu_torch.models import pcfich, pdcch, regs
    from empower_srslte_tpu_torch.utils.cell import Cell

    cell = Cell(nof_prb=prb, nof_ports=ports, id=prb + 3 * ports + cfi,
                cp=cp)
    dev = g.device
    size = dci_mod.format0_1a_size(prb)
    cands = pdcch.ue_search_candidates(rnti, sf_idx,
                                       regs.pdcch_nof_cces(cell, cfi))
    l, cce = next(c for c in cands if c[0] <= 4)
    bits = torch.randint(0, 2, (batch, size), generator=g, device=dev,
                         dtype=torch.int8)
    tx = torch.zeros((batch, ports, cell.nsymb_sf, cell.nof_re),
                     dtype=torch.complex64, device=dev)
    tx = pcfich.pcfich_put(tx, cfi, cell, sf_idx)
    tx = tx + pdcch.pdcch_encode(bits, rnti, cce, l, cell, cfi, sf_idx)
    phase = 2 * torch.pi * torch.rand((batch, ports), generator=g, device=dev)
    h = (torch.polar(torch.ones_like(phase), phase) / ports ** 0.5)[
        ..., None, None].expand(-1, -1, cell.nsymb_sf, cell.nof_re).contiguous()
    n0 = 10 ** (-snr_db / 10)
    shape = (batch, cell.nsymb_sf, cell.nof_re)
    nz = torch.complex(torch.randn(shape, generator=g, device=dev),
                       torch.randn(shape, generator=g, device=dev))
    grid = (tx * h).sum(1) + nz * (n0 / 2) ** 0.5
    noise = torch.full((batch,), n0, dtype=torch.float32, device=dev)
    sizes = (size, dci_mod.format1_size(prb))
    return cell, grid, h, noise, sizes, cands


def derm_ascending(llr, cands, k: int):
    """The blind kernel's de-rate-matching in PyTorch: each trellis
    position's repetitions below E added in ascending order from 0 (the
    kernel's order; ``rm_conv_rx``'s ``torch.sum`` takes it up to 4
    repetitions). llr [N, n_llr] -> [N, n_cand, 3, K]."""
    import torch

    from empower_srslte_tpu_torch.models.pdcch import derm_inverse

    inv = torch.as_tensor(derm_inverse(k), dtype=torch.int64,
                          device=llr.device)
    out = []
    for l, cce in cands:
        e = 72 * l
        seg = llr[:, 72 * cce:72 * cce + e]
        acc = torch.zeros((llr.shape[0], 3 * k), dtype=torch.float32,
                          device=llr.device)
        for r in range(-(-e // (3 * k))):
            pos = inv + r * 3 * k
            acc = acc + torch.where(pos < e, seg[:, pos.clamp(max=e - 1)],
                                    0.0)
        out.append(acc.reshape(-1, 3, k))
    return torch.stack(out, 1)


def blind_twin_check(llr, cands, sizes, rnti: int) -> dict:
    """The blind kernel on llr [N, n_llr] (card) against (a) the plain
    twin run on the CPU (``_pdcch_blind_bits_plain``, ``dci_crc_ok``) and
    (b) the plain Viterbi and CRC on the kernel's own ascending-order
    de-rate-matching, both on the CPU. The bits and CRC flags must equal
    (b) everywhere, and (a) in every word whose de-rate-matched input
    equals the twin's (every word of 4 repetitions or fewer); the
    subframes' pass counts must equal the twin's."""
    import torch

    from empower_srslte_tpu_torch.models import pdcch
    from empower_srslte_tpu_torch.ops.fec.convcoder import (
        viterbi_decode_plain)
    from empower_srslte_tpu_torch.ops.fec.rm_conv import rm_conv_rx

    bits, ok, hits = pdcch.pdcch_blind_cuda(llr, cands, sizes, rnti)
    torch.cuda.synchronize()
    x = llr.cpu()
    n_det = torch.zeros(x.shape[0], dtype=torch.int64)
    out = {"words": 0, "mismatched_bits_asc": 0, "mismatched_ok_asc": 0,
           "words_derm_differs": 0, "mismatched_words_same_derm": 0,
           "mismatched_ok_same_derm": 0, "words_differ_derm_differs": 0,
           "passes": 0}
    for i, size in enumerate(sizes):
        k = size + 16
        got, got_ok = bits[i].cpu(), ok[i].cpu()
        twin = pdcch._pdcch_blind_bits_plain(x, cands, size)
        twin_ok = pdcch.dci_crc_ok(twin, size, rnti)
        n_det = n_det + twin_ok.sum(-1)
        d_asc = derm_ascending(x, cands, k)
        asc = viterbi_decode_plain(d_asc)
        asc_ok = pdcch.dci_crc_ok(asc, size, rnti)
        d_twin = torch.stack([rm_conv_rx(x[:, 72 * c:72 * (c + l)], k)
                              for l, c in cands], 1)
        same = (d_asc == d_twin).all(-1).all(-1)
        word_diff = (got != twin).any(-1)
        out["words"] += got_ok.numel()
        out["mismatched_bits_asc"] += int((got != asc).sum())
        out["mismatched_ok_asc"] += int((got_ok != asc_ok).sum())
        out["words_derm_differs"] += int((~same).sum())
        out["mismatched_words_same_derm"] += int((word_diff & same).sum())
        out["mismatched_ok_same_derm"] += int(
            ((got_ok != twin_ok) & same).sum())
        out["words_differ_derm_differs"] += int((word_diff & ~same).sum())
        out["passes"] += int(got_ok.sum())
    out["hits_equal_twin"] = bool(torch.equal(hits.cpu(), n_det))
    out["exact"] = (out["mismatched_bits_asc"] == 0
                    and out["mismatched_ok_asc"] == 0
                    and out["mismatched_words_same_derm"] == 0
                    and out["mismatched_ok_same_derm"] == 0
                    and out["hits_equal_twin"])
    return out


def blind_work(sizes, n_cand: int, n: int, n_llr: int) -> tuple:
    """(compulsory bytes, operations) of one blind launch: the LLRs read
    once and every word's bits written once; the Viterbi operations of
    each word (as the Viterbi kernel's bound counts them)."""
    from empower_srslte_tpu_torch.ops.fec.convcoder import TRAIN_LEN

    nbytes = n * (4 * n_llr + n_cand * sum(s + 16 for s in sizes))
    ops = 0
    for s in sizes:
        k = s + 16
        halo = min(TRAIN_LEN, k)
        ops += n * n_cand * ((2 * halo + k) * VIT_OPS_STEP
                             + (k + halo) * VIT_OPS_TRACE)
    return nbytes, ops


def ctrl_shape(tag: str, cell, grid, h, noise, cfi: int, sizes, cands,
               sf_idx: int = 3, rnti: int = 0x1234, want_cfi=None) -> dict:
    """Both control kernels at one shape against their twins: kernel A's
    CFI and LLRs against the plain twin on the CPU (and, for the record,
    on the card), kernel B fed kernel A's LLRs (``blind_twin_check``);
    each timed by CUDA-graph replay beside its bound, and the twins'
    three stages on the card (CUDA events: their launches' host cost
    included)."""
    import torch

    from empower_srslte_tpu_torch.models import pcfich, pdcch

    cfi_hat, corr, llr = pdcch.ctrl_llr_cuda(grid, h, cell, sf_idx, noise,
                                             region=(cfi, 1.0))
    torch.cuda.synchronize()
    gc, hc, nc = grid.cpu(), h.cpu(), noise.cpu()[:, None]
    t_cfi, t_corr = pcfich._pcfich_decode_plain(gc, hc, cell, sf_idx, nc)
    t_llr = pdcch._pdcch_extract_llr_plain(gc, hc, cell, cfi, sf_idx, nc)
    c_llr = pdcch._pdcch_extract_llr_plain(grid, h, cell, cfi, sf_idx,
                                           noise[:, None])
    scale = float(t_llr.abs().max())
    blind = blind_twin_check(llr, cands, sizes, rnti)

    def twin():
        cf, _ = pcfich._pcfich_decode_plain(grid, h, cell, sf_idx,
                                            noise[:, None])
        x = pdcch._pdcch_extract_llr_plain(grid, h, cell, cfi, sf_idx,
                                           noise[:, None])
        return cf, [pdcch.dci_crc_ok(pdcch._pdcch_blind_bits_plain(
            x, cands, s), s, rnti).sum(-1) for s in sizes]

    n = grid.shape[0]
    n_re = llr.shape[-1] // 2
    ports = h.shape[1]
    a_ms = graph_ms(lambda: pdcch.ctrl_llr_cuda(
        grid, h, cell, sf_idx, noise, region=(cfi, 1.0)),
        reps=20)
    b_ms = graph_ms(lambda: pdcch.pdcch_blind_cuda(
        llr, cands, sizes, rnti), reps=20)
    a_bytes = n * ((16 + n_re) * 8 * (1 + min(ports, 2)) + 8 * n_re + 12)
    return {"tag": tag, "subframes": n, "nof_prb": cell.nof_prb,
            "ports": ports, "cfi": cfi, "cp": cell.cp.value,
            "candidates": len(cands), "sizes": list(sizes),
            "cfi_equal_twin": bool(torch.equal(cfi_hat.cpu(), t_cfi)),
            "cfi_right": (None if want_cfi is None
                          else bool((cfi_hat == want_cfi).all())),
            "corr_abs_err": float((corr.cpu() - t_corr).abs().max()),
            "llr_err": float((llr.cpu() - t_llr).abs().max()) / scale,
            "llr_err_card_twin": float((llr - c_llr).abs().max()) / scale,
            "blind": blind,
            "kernel_a": {"ms": a_ms, **bound(a_bytes, 0)},
            "kernel_b": {"ms": b_ms, **bound(*blind_work(
                sizes, len(cands), n, llr.shape[-1]))},
            "twin_ms": cuda_ms(twin, reps=3)}


def phase_pdcch_rx():
    """The control kernels (``csrc/pdcch_rx.cu``) against their plain
    twins: the main path's own control region (``ue_dl_tm4_batch``'s
    grid and channel of rx 0 at 256 and 1 subframes, 100 PRB, 2 ports,
    CFI 1), the TM2 path's (``ue_dl_tm2_batch``'s at 256 subframes, 100
    PRB, 4 ports on SFBC-FSTD, CFI 1), then on generated regions at 6 and
    25 PRB, 1, 2 and 4 ports, CFI 1-3, the extended CP, and at an SNR
    where most candidates are noise; then the launches each receiver path
    makes a call."""
    import torch

    from empower_srslte_tpu_torch.models import dci as dci_mod
    from empower_srslte_tpu_torch.models import enb_dl, pdcch, regs
    from empower_srslte_tpu_torch.models.ue_dl import (ue_dl_decode,
                                                       ue_dl_tm2_batch,
                                                       ue_dl_tm4_batch)
    from empower_srslte_tpu_torch.ops.chest import chest_dl_ports
    from empower_srslte_tpu_torch.ops.equalizer import MimoType
    from empower_srslte_tpu_torch.ops.ofdm import ofdm_rx_sf
    from empower_srslte_tpu_torch.utils.cell import CP

    g = torch.Generator(device="cuda").manual_seed(81)
    shapes = []
    st256 = enb_dl.tm4_stimulus(BATCH, device="cuda")
    st1 = enb_dl.tm4_stimulus(1, device="cuda")
    for tag, st in (("tm4_b256", st256), ("tm4_b1", st1)):
        cfg = st.cfg
        grid = ofdm_rx_sf(st.samples, cfg.cell)
        h, noise = chest_dl_ports(grid, cfg.cell, cfg.sf_idx, (0, 1))
        n0 = torch.clamp(noise[:, 0, 0], min=1e-7)
        cands = pdcch.ue_search_candidates(
            cfg.rnti, cfg.sf_idx, regs.pdcch_nof_cces(cfg.cell, cfg.cfi))
        sizes = tuple(sorted({dci_mod.format1_size(cfg.cell.nof_prb),
                              dci_mod.format0_1a_size(cfg.cell.nof_prb)}))
        shapes.append(ctrl_shape(tag, cfg.cell, grid[:, 0], h[:, 0], n0,
                                 cfg.cfi, sizes, cands, cfg.sf_idx,
                                 cfg.rnti, want_cfi=cfg.cfi))
    gen = [(100, 2, 1, CP.NORM, BATCH, PDCCH_NOISE_SNR_DB),
           (100, 4, 3, CP.NORM, 16, PDCCH_SNR_DB),
           (25, 1, 2, CP.NORM, 16, PDCCH_SNR_DB),
           (25, 2, 3, CP.EXT, 16, PDCCH_SNR_DB),
           (6, 1, 1, CP.NORM, 16, PDCCH_SNR_DB),
           (6, 2, 3, CP.NORM, 16, PDCCH_NOISE_SNR_DB),
           (6, 4, 2, CP.EXT, 16, PDCCH_SNR_DB)]
    for prb, ports, cfi, cp, b, snr in gen:
        cell, grid, h, noise, sizes, cands = ctrl_stimulus(
            g, prb, ports, cfi, cp, b, snr)
        tag = f"{prb}prb_{ports}p_cfi{cfi}_{cp.value}_b{b}_{snr:g}db"
        shapes.append(ctrl_shape(tag, cell, grid, h, noise, cfi, sizes,
                                 cands, want_cfi=cfi if snr > 0 else None))

    # the 4-port TM2 path's own region: SFBC-FSTD (36.211 6.8.4)
    _conf, sent, cfg, plan = tm2_batch_stimulus(BATCH)
    grid = ofdm_rx_sf(sent["samples"], cfg.cell)
    h, noise = chest_dl_ports(grid, cfg.cell, cfg.sf_idx, (0, 1, 2, 3))
    n0 = torch.clamp(noise[:, 0, 0], min=1e-7)
    cands = pdcch.ue_search_candidates(
        cfg.rnti, cfg.sf_idx, regs.pdcch_nof_cces(cfg.cell, cfg.cfi))
    sizes = tuple(sorted({dci_mod.format1_size(cfg.cell.nof_prb),
                          dci_mod.format0_1a_size(cfg.cell.nof_prb)}))
    shapes.append(ctrl_shape("tm2_4p_b256", cfg.cell, grid[:, 0], h[:, 0],
                             n0, cfg.cfi, sizes, cands, cfg.sf_idx,
                             cfg.rnti, want_cfi=cfg.cfi))
    del grid, h

    fr = enb_dl.tm2_frame_stimulus(device="cuda")
    paths = {
        "tm4_b256": lambda: ue_dl_tm4_batch(st256.samples, st256.cfg,
                                            st256.plan),
        "tm4_b1": lambda: ue_dl_tm4_batch(st1.samples, st1.cfg, st1.plan),
        "tm2_b256": lambda: ue_dl_tm2_batch(sent["samples"], cfg, plan),
        "ue_dl_decode": lambda: ue_dl_decode(
            fr.samples[1], fr.cell, 1, fr.rnti, mimo=MimoType.DIVERSITY),
    }

    launches = {name: launches_per_call(run, ["ctrl_llr", "pdcch_blind"])
                for name, run in paths.items()}
    path_ms = {name: cuda_ms(paths[name], reps=3)
               for name in ("tm4_b256", "tm4_b1")}
    res = paths["tm4_b256"]()
    checks = {
        "cfi_equal_twin": all(v["cfi_equal_twin"] for v in shapes),
        "cfi_right": all(v["cfi_right"] in (None, True) for v in shapes),
        "llr_within_tol": all(v["llr_err"] <= PDCCH_LLR_TOL for v in shapes),
        "blind_exact": all(v["blind"]["exact"] for v in shapes),
        "blind_noise_checked": any(v["blind"]["passes"]
                                   < v["blind"]["words"] / 2
                                   for v in shapes),
        "dci_found_every_subframe": bool((res.dci_hits >= 1).all()),
        "one_launch_each_a_batch_call": all(
            launches[p] == {"ctrl_llr": 1, "pdcch_blind": 1}
            for p in ("tm4_b256", "tm4_b1", "tm2_b256")),
        "ue_dl_decode_launches": launches["ue_dl_decode"]
        == {"ctrl_llr": 2, "pdcch_blind": 1},
    }
    out = {"phase": "pdcch_rx", "llr_tol": PDCCH_LLR_TOL,
           "shapes": shapes, "launches_per_call": launches,
           "path_ms": path_ms, "ptxas": PTXAS.get("pdcch_rx"),
           "ptxas_viterbi37": PTXAS.get("viterbi37"), "checks": checks}
    emit(out)
    check("pdcch_rx", checks)
    return out


def turbo_kernel_check():
    """map_decode_nii against the plain twin, max abs error exactly 0, in
    float32 and in bfloat16, at the geometries the kernel's code paths
    take: the main path's (5120 code blocks of K=5760, l=240, with apr), a
    ragged single window (K=56, l=K, no apr: the top segment is 8 rows), a
    trellis slice with no edge (bounds (-1, -1)) and, in bfloat16, an odd
    batch (5119 code blocks, launched as they are); then one full decode
    of 64 code blocks per dtype where the hard bits and iteration counts
    must be equal. The main shape is timed in turns (float32, bfloat16,
    bfloat16, float32); with ``--baseline``, each baseline in turns with
    the port at the main shape in both dtypes and at the stack's smallest
    bfloat16 launch (one code block of K 144, one window), graphed and
    launch by launch. The other paths' geometries are checked in their
    phases (``hold_shapes``). -> (float32 entry, bfloat16 entry) of the
    kernels line."""
    import torch

    from empower_srslte_tpu_torch.ops.fec.turbo_decoder import TurboDecoder
    from empower_srslte_tpu_torch.ops.fec.turbo_nii import (
        map_decode_nii, map_decode_nii_plain, nii_plan)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(11)

    k, l, b = 5760, 240, 2 * BATCH * 10
    w = k // l
    geos = {"main": (k, l, b, True, None),
            "ragged_single_window": (56, 56, b, False, None),
            "no_edge": (k, l, 512, True, (-1, -1))}
    errs, main = {}, {}
    for dt in ("float32", "bfloat16"):
        extra = {"odd_batch": (k, l, b - 1, True, None)} \
            if dt == "bfloat16" else {}
        errs[dt] = {}
        for name, geo in {**geos, **extra}.items():
            args, kw = nii_inputs(g, *geo, dtype=dt)
            errs[dt][name], ref = nii_twin(args, kw)
            if name == "main":
                main[dt] = (args, kw, ref)
    assert not any(v for e in errs.values() for v in e.values()), \
        f"NII kernel vs plain twin: {errs}"
    run = {dt: (lambda a=main[dt][0], kw=main[dt][1]:
                map_decode_nii(*a, **kw)) for dt in main}
    times = dtype_turns(run["float32"], run["bfloat16"], reps=10)

    cases = {dt: (*main[dt], cuda_ms) for dt in main}
    if BASELINES:
        # half and twice the main batch (copies): throughput or latency
        args, kw, ref = main["bfloat16"]
        for name, f in (("half", lambda x: x[..., :b // 2].contiguous()),
                        ("x2", lambda x: x.repeat(*[1] * (x.dim() - 1), 2))):
            cases[f"bfloat16_{name}"] = (
                tuple(map(f, args)), {**kw, "apr": f(kw["apr"])},
                tuple(map(f, ref)), cuda_ms)
        args, kw = nii_inputs(g, 144, 144, 1, dtype="bfloat16")
        ref = nii_twin(args, kw)[1]
        cases.update(bfloat16_k144_cbs1=(args, kw, ref, graph_ms),
                     bfloat16_k144_cbs1_ungraphed=(args, kw, ref, cuda_ms))
        # where each design wins: the batch from one code block up, by
        # CUDA-graph replay
        for kk, ll, bb in BASELINE_SWEEP["turbo_nii"]:
            args, kw = nii_inputs(g, kk, ll, bb, dtype="bfloat16")
            cases[f"bfloat16_k{kk}_cbs{bb}"] = (
                args, kw, nii_twin(args, kw)[1], graph_ms)
    base_line = {"baselines": baseline_pairs("map_decode_nii",
                                             map_decode_nii, cases)}

    u, llr = awgn_code_blocks(g, k, 64, 0.9)
    out, line = {}, {"phase": "kernel_turbo", "cbs": b, "k": k, "window": l,
                     "turns_ms": times["turns_ms"]}
    for dt, tag in (("float32", "OpsF32"), ("bfloat16", "OpsBf16x2")):
        args, kw, _ = main[dt]
        ms = times[dt]
        plain_ms = cuda_ms(lambda: map_decode_nii_plain(*args, **kw),
                           reps=1)
        # what both designs move: u, p, apr read by both sweeps (or
        # sides), ext written
        moved = itemsize(dt) * (7 * k * b + 2 * 3 * b
                                + 4 * (w + 1) * 8 * b)
        dec = TurboDecoder(k=k, iterations=8, window=l, dtype=dt)
        plan = nii_plan(l, True, getattr(torch, dt), b, w, sms=card_sms())
        ptxas = ptxas_of("turbo_nii", tag)
        entry = {"max_abs_err": max(errs[dt].values()), "ms": ms,
                 "plain_ms": plain_ms,
                 **bound(*nii_work(k, l, b, dt), dt),
                 **kernel_design("turbo_nii", dt, plan)}
        line[dt] = {**entry, "max_abs_err_by_geometry": errs[dt],
                    "smem_dynamic": plan.smem,
                    "cbs_per_thread": plan.cbs_per_thread,
                    "ptxas": ptxas,
                    "moved_gb": moved / 1e9,
                    "moved_tb_s": moved / (ms * 1e-3) / 1e12,
                    "decode_cbs": 64,
                    **decode_vs_twin(dec, llr, u, map_decode_nii_plain)}
        out[dt] = entry
    emit({**line, **base_line})
    return out["float32"], out["bfloat16"]


def vit_inputs(g, k: int, words: int, kind: str = "noisy"):
    """LLRs [words, 3, K] for the Viterbi kernel: noisy codewords, or
    (kind "ints") values in {-1, 0, 1}, which tie often."""
    import torch

    from empower_srslte_tpu_torch.ops.fec.convcoder import conv_encode

    if kind == "ints":
        return torch.randint(-1, 2, (words, 3, k), generator=g,
                             device=g.device).to(torch.float32)
    u = torch.randint(0, 2, (words, k), generator=g, device=g.device)
    d = conv_encode(u).to(torch.float32)
    return (1.0 - 2.0 * d
            + 0.8 * torch.randn(d.shape, generator=g, device=g.device))


def vit_twin_mismatch(llr, train) -> int:
    """Bits where the Viterbi kernel and its plain twin disagree."""
    import torch

    from empower_srslte_tpu_torch.ops.fec.convcoder import (
        viterbi_decode_plain)
    from empower_srslte_tpu_torch.ops.fec.viterbi37 import (
        viterbi_decode_cuda)

    got = viterbi_decode_cuda(llr, train=train)
    ref = viterbi_decode_plain(llr, train=train)
    torch.cuda.synchronize()
    return int((got != ref).sum())


def vit_path_check(phase: str, geos, seed: int) -> dict:
    """The Viterbi kernel against its twin at each (K, words) a path's
    blind search gives it (training length as the blind search decodes),
    0 mismatched bits. Launches made here are not counted: no phase's
    launch count is open while they run."""
    import torch

    from empower_srslte_tpu_torch.ops.fec.convcoder import TRAIN_LEN

    g = torch.Generator(device="cuda").manual_seed(seed)
    mism = {f"{phase}_k{k}_words{words}": vit_twin_mismatch(
        vit_inputs(g, k, words), TRAIN_LEN) for k, words in sorted(geos)}
    PATH_TWIN["viterbi37"].update(mism)
    assert not any(mism.values()), f"Viterbi kernel vs plain twin: {mism}"
    return mism


def viterbi_kernel_check(phase: str, sizes, seed: int, extra=()):
    """The Viterbi kernel against its plain twin on noisy codewords, for
    each (K, words) in ``sizes``, timed there by CUDA-graph replay (in
    turns with a baseline's ``viterbi_regs`` when one is given;
    ``ms_ungraphed`` times the same call launch by launch, which at the
    CQI's shape reads the wrapper's host cost); then at each (K, words, train,
    kind) of ``extra``, checked only (kind "ints": LLRs in {-1, 0, 1},
    which tie often). Every geometry must read 0 mismatched bits. The
    downlink's blind search decodes K=55 and K=44, the PBCH batch's blind
    decode K=40 (its halo is all of K); the uplink's CQI decode K=38,
    where the training halo is clamped to K. The per-subframe receivers'
    shapes are checked in their phases (``vit_path_check``)."""
    import torch

    from empower_srslte_tpu_torch.ops.fec.convcoder import (
        TRAIN_LEN, unpack_regs, viterbi_decode_plain)
    from empower_srslte_tpu_torch.ops.fec.viterbi37 import (
        viterbi_decode_cuda, viterbi_regs_cuda, vit_plan)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    base_fn, base_ptxas = next(((f, px) for _, f, px in
                                baseline_fns("viterbi_regs")), (None, {}))

    mism, base_mism, per_k = {}, {}, {}
    ms = plain_ms = err = 0.0
    nbytes = ops = 0
    for k, words in sizes:
        llr = vit_inputs(g, k, words)
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
        mism[f"k{k}_{kind}_train_{train}"] = vit_twin_mismatch(
            vit_inputs(g, k, words, kind), train)
    total = sum(mism.values())
    line = {"phase": phase, "sizes": [list(s) for s in sizes],
            "mismatched_bits": total, "mismatched_bits_by_geometry": mism,
            "ms": ms, "plain_ms": plain_ms, "by_k": per_k,
            "ptxas": PTXAS.get("viterbi37"), **bound(nbytes, ops)}
    if base_fn is not None:
        line.update(baseline_mismatched_bits=base_mism,
                    baseline_ptxas=ptxas_summary(
                        base_ptxas.get("viterbi37", "")))
    emit(line)
    assert total == 0, f"Viterbi kernel decisions differ: {mism}"
    return dict(max_abs_err=err, mismatched_bits=total, ms=ms,
                plain_ms=plain_ms, **bound(nbytes, ops))


#: the de-rate-matching kernel against its twin where three repetitions
#: or more add (float32 LLRs): the kernel adds them in ascending order and
#: the twin's ``sum`` in its own, so the largest difference over the
#: twin's largest magnitude may be float32 rounding of a few terms in the
#: softbuffer and float32 inputs, and one bfloat16 step (2^-8 of the top
#: of the range) in bfloat16 inputs; everywhere else the outputs are equal
DERM_TOL, DERM_TOL_BF16 = 1e-6, 2.0 ** -8


def derm_shape(plan, k: int, rows: int, llr: str = "float32",
               softbuffer: bool = False, prior: bool = False) -> tuple:
    """The de-rate-matching kernel's launch shape (its key in the launch
    registry) for the code blocks of size ``k`` of ``plan`` over ``rows``
    LLR rows."""
    cbs = tuple((e, f, off) for _i, e, f, off in plan.k_groups[k])
    return (k, plan.rv, cbs, rows, llr,
            dt_name(plan.decoder(k).metric_dtype), softbuffer, prior)


def derm_name(shape) -> str:
    k, rv, cbs, rows, llr, metric, sb, prior = shape
    es = sorted({e for e, _f, _o in cbs})
    return (f"k{k}_rv{rv}_c{len(cbs)}_e{es[0]}-{es[-1]}_"
            f"f{max(f for _e, f, _o in cbs)}_rows{rows}_{llr}_{metric}"
            + ("_sb" if sb else "") + ("_prior" if prior else ""))


def derm_work(shape) -> int:
    """Compulsory bytes of one de-rate-matching launch: every code block's
    LLRs read once, the softbuffer written once (and read once where one
    is given), the decoder's inputs (3(K+4) values a code block) written
    once."""
    k, _rv, cbs, rows, llr, metric, sb, _prior = shape
    size = 1 if llr == "int8" else 4
    per_cb = 3 * (k + 4) * (size * (2 if sb else 1) + itemsize(metric))
    return rows * (size * sum(e for e, _f, _o in cbs) + len(cbs) * per_cb)


def derm_inputs(g, shape):
    """Random inputs of one launch at ``shape`` on the card: (llrs,
    decoder, softbuffer or None, prior or None)."""
    import torch

    from empower_srslte_tpu_torch.ops.fec.turbo_decoder import TurboDecoder

    k, _rv, cbs, rows, llr, metric, sb, prior = shape
    dev = g.device
    width = max(off + e for e, _f, off in cbs)
    x = torch.randn((rows, width), generator=g, device=dev) * 4
    sbt = (torch.randn((rows, len(cbs), 3 * (k + 4)), generator=g,
                       device=dev) * 4 if sb else None)
    if llr == "int8":
        q = lambda t: t.mul(30).round().clamp(-127, 127).to(torch.int8)
        x = q(x)
        sbt = None if sbt is None else q(sbt)
    pr = (torch.rand((rows,), generator=g, device=dev) * 50 + 1
          if prior else None)
    return x, TurboDecoder(k=k, dtype=metric), sbt, pr


def derm_hold(shape, seed: int, time_twin: bool = False) -> dict:
    """The de-rate-matching kernel at one launch shape against its plain
    twin run on the card: every output (the softbuffer, sys1, par1,
    sys2's tail, par2) equal where the repetitions add in the twin's
    order (at most two, or integers on the int8 lane), else within
    ``DERM_TOL`` / ``DERM_TOL_BF16``; timed by CUDA-graph replay beside
    its bound, and with ``time_twin`` the twin (the chain the kernel
    replaced) by CUDA-graph replay and by CUDA events as a path calls
    it."""
    import torch

    from empower_srslte_tpu_torch.ops.fec import rate_matching as rm

    g = torch.Generator(device="cuda").manual_seed(seed)
    k, rv, cbs, rows, llr, metric, _sb, _prior = shape
    x, dec, sb, pr = derm_inputs(g, shape)
    got = rm.derm_to_decoder_cuda(x, cbs, rv, dec, sb, pr)
    ref = rm._derm_to_decoder_plain(x, cbs, rv, dec, sb, pr)
    torch.cuda.synchronize()
    reps = max(-(-e // (3 * (k + 4) - 2 * f)) for e, f, _o in cbs)
    names = ("softbuffer", "sys1", "par1", "sys2_tail", "par2")
    pairs = list(zip(names, (got[0], *got[1][:4]), (ref[0], *ref[1][:4])))
    equal = all(a.dtype == b.dtype and torch.equal(a, b)
                for _n, a, b in pairs)
    err = {n: float((a.float() - b.float()).abs().max())
           / (float(b.float().abs().max()) or 1.0) for n, a, b in pairs}
    tol = DERM_TOL_BF16 if metric == "bfloat16" else DERM_TOL
    within = err["softbuffer"] <= DERM_TOL and all(
        err[n] <= tol for n in names[1:])
    exact_required = llr == "int8" or reps <= 2
    out = {"k": k, "rv": rv, "cbs": len(cbs),
           "e": sorted({e for e, _f, _o in cbs}),
           "f": sorted({f for _e, f, _o in cbs}), "rows": rows,
           "llr": llr, "metric": metric, "softbuffer": sb is not None,
           "prior": pr is not None, "max_reps": reps,
           "exact_required": exact_required, "equal": equal,
           "rel_err": err, "within_tol": within,
           "held": equal if exact_required else within,
           "ms": graph_ms(lambda: rm.derm_to_decoder_cuda(
               x, cbs, rv, dec, sb, pr), reps=20),
           **bound(derm_work(shape), 0)}
    out["over_bound"] = out["ms"] / out["bound_ms"]
    if time_twin:
        twin = lambda: rm._derm_to_decoder_plain(x, cbs, rv, dec, sb, pr)
        out["twin_ms_graphed"] = graph_ms(twin, reps=5)
        out["twin_ms"] = cuda_ms(twin, reps=5)
    return out


def phase_sch_derm():
    """The de-rate-matching kernel (``csrc/sch_derm.cu``) against its
    plain twin on the card (``derm_hold``): at the benchmark cell's shape
    (256 subframes x 2 codewords x 13 code blocks of K 5824) and a
    subframe's, with the chain it replaced timed beside it, at the main
    path's and the uplink path's (256 x 7 of K 5824), and at generated
    shapes that take every instance and
    branch: K 40 and 6144, K- and K+ with filler bits (the bfloat16
    prior, and FILLER_LLR under float32 metrics), Msg3's K 280 with two
    and three repetitions, a softbuffer on both LLR lanes, rv 0-3; then
    the launches a call of the main path at 256 and 1 subframes and of
    the uplink path (one a call on each: one K)."""
    from empower_srslte_tpu_torch.models.enb_dl import tm4_stimulus
    from empower_srslte_tpu_torch.models.sch import DlschPlan
    from empower_srslte_tpu_torch.models.ue_dl import ue_dl_tm4_batch
    from empower_srslte_tpu_torch.models.ue_ul import ul_uci_stimulus

    st256 = tm4_stimulus(BATCH, device="cuda")
    st1 = tm4_stimulus(1, device="cuda")
    ul = ul_uci_stimulus(BATCH, UL_N0, device="cuda")
    main = st256.plan
    kmain = main.segm.cb_sizes[0]
    ul_plan = ul.plan.data_plan
    k_ul = ul_plan.segm.cb_sizes[0]
    seg = DlschPlan(tbs=6128, g=9000, qm=4, rv=3)
    small = DlschPlan(tbs=100, g=480, qm=2)
    # the benchmark's 20 MHz TM4 codeword (MCS 28: 13 code blocks of
    # K 5824, E 6642 and 6648), 2 codewords a subframe
    cell = DlschPlan(tbs=75376, g=86400, qm=6)
    shapes = {
        "cell_b256x2": derm_shape(cell, 5824, 2 * BATCH),
        "cell_tti_b1x2": derm_shape(cell, 5824, 2),
        "main_path_b256x2": derm_shape(main, kmain, 2 * BATCH),
        "main_path_b1x2": derm_shape(main, kmain, 2),
        "uplink_b256": derm_shape(ul_plan, k_ul, BATCH),
        "k40_rv1": derm_shape(DlschPlan(tbs=16, g=240, qm=2, rv=1), 40, 64),
        "k6144": derm_shape(DlschPlan(tbs=6120, g=12000, qm=2), 6144, 64),
        **{f"seg_k{k}_prior": derm_shape(seg, k, 64, prior=True)
           for k in seg.k_groups},
        "filler_f32": derm_shape(DlschPlan(tbs=100, g=480, qm=2,
                                           decoder_impl="xla"), 128, 64),
        "filler_bf16_prior": derm_shape(small, 128, 64, prior=True),
        "msg3_two_reps_int8": derm_shape(
            DlschPlan(tbs=256, g=1152, qm=2, decoder_impl="windowed"), 280,
            BATCH, llr="int8"),
        "three_reps": derm_shape(DlschPlan(tbs=256, g=1852, qm=2), 280, 64),
        "three_reps_bf16": derm_shape(DlschPlan(tbs=1000, g=6400, qm=2),
                                      1024, 64),
        "three_reps_int8_sb": derm_shape(DlschPlan(tbs=256, g=1852, qm=2),
                                         280, 64, llr="int8",
                                         softbuffer=True),
        "softbuffer_f32": derm_shape(DlschPlan(tbs=1000, g=2400, qm=4),
                                     1024, 64, softbuffer=True),
        **{f"rv{rv}": derm_shape(DlschPlan(tbs=1000, g=1500, qm=2, rv=rv),
                                 1024, 64) for rv in range(4)},
    }
    held = {name: derm_hold(sh, 81 + i,
                            time_twin=name.startswith("cell_"))
            for i, (name, sh) in enumerate(shapes.items())}

    def per_call(run):
        return launches_per_call(run, ["sch_derm"])["sch_derm"]

    launches = {
        "main_b256": per_call(lambda: ue_dl_tm4_batch(
            st256.samples, st256.cfg, st256.plan)),
        "main_b1": per_call(lambda: ue_dl_tm4_batch(st1.samples, st1.cfg,
                                                    st1.plan)),
        "uplink_b256": per_call(lambda: run_uplink(ul, UL_N0)),
    }
    m = held["cell_b256x2"]
    checks = {
        "twin_every_shape": all(v["held"] for v in held.values()),
        "exact_where_required": all(v["equal"] for v in held.values()
                                    if v["exact_required"]),
        "some_shape_not_exact_by_order": any(not v["exact_required"]
                                             for v in held.values()),
        "one_launch_a_path_call": all(v == 1 for v in launches.values()),
    }
    out = {"phase": "sch_derm", "tol": DERM_TOL, "tol_bf16": DERM_TOL_BF16,
           "shapes": held, "launches_per_call": launches,
           "main": {"ms": m["ms"], "bound_ms": m["bound_ms"],
                    "over_bound": m["over_bound"],
                    "twin_ms_graphed": m["twin_ms_graphed"],
                    "twin_ms": m["twin_ms"]},
           "tti": {k: held["cell_tti_b1x2"][k] for k in (
               "ms", "bound_ms", "twin_ms_graphed", "twin_ms")},
           "ptxas": PTXAS.get("sch_derm"), "checks": checks}
    emit(out)
    check("sch_derm", checks)
    return out


def phase_turbo_enc():
    """The turbo encoder kernel (``csrc/turbo_enc.cu``) against its plain
    twin run on the card, d equal bit for bit: at every K of 36.212 Table
    5.1.3-3 on five code blocks (random, all ones, all zeros; three blocks
    a launch take a half-filled last block), on int64 and bool inputs with
    leading dims, and at the transmitter cell's shape (2 codewords x 256
    subframes x 13 code blocks of K 5824) and a subframe's; there timed by
    CUDA-graph replay beside its bound (the bits read and d written once)
    and the twin (the byte walk it replaced) by CUDA events as a call
    makes it. Then the launches of an ``enb_dl_tx_batch`` call at the
    cell's shape: one, over every code block of the call (one K)."""
    import json

    import torch

    from empower_srslte_tpu_torch.ops.fec import turbo_encoder as te
    from empower_srslte_tpu_torch.ops.fec.tables import TURBO_CB_SIZES
    from empower_srslte_tpu_torch.runtime import trace
    from phybench.drivers.enb_dl_tx_batch import Driver

    g = torch.Generator(device="cuda").manual_seed(25)

    def bits(*shape):
        return torch.randint(0, 2, shape, generator=g, device="cuda",
                             dtype=torch.int8)

    def differ(u) -> int:
        got, ref = te.turbo_encode(u), te._turbo_encode_plain(u)
        same = got.dtype == ref.dtype and got.shape == ref.shape
        return int((got != ref).sum()) if same else -1

    every_k = {}
    for k in TURBO_CB_SIZES:
        u = bits(5, k)
        u[1], u[2] = 1, 0
        every_k[k] = [differ(u), differ(u[:3])]
    dtypes = {"int64": differ(bits(2, 3, 1024).to(torch.int64)),
              "bool": differ(bits(3, 1, 2, 6144).bool()),
              "int8_lead": differ(bits(2, 2, 3, 40))}
    k_cell = 5824
    shapes = {"cell_b256x2": 2 * BATCH * 13, "cell_tti_b1x2": 2 * 13}
    timed = {}
    for name, rows in shapes.items():
        u = bits(rows, k_cell)
        nbytes = rows * (k_cell + 3 * (k_cell + te.TAIL))
        timed[name] = {"rows": rows, "k": k_cell, "mismatched": differ(u),
                       "ms": graph_ms(lambda: te.turbo_encode(u), reps=20),
                       **bound(nbytes, 0),
                       "twin_ms": cuda_ms(lambda: te._turbo_encode_plain(u),
                                          reps=2)}
        timed[name]["over_bound"] = timed[name]["ms"] / timed[name]["bound_ms"]
        timed[name]["twin_over_kernel"] = (timed[name]["twin_ms"]
                                           / timed[name]["ms"])
    conf = json.loads((ROOT / "phybench" / "configs"
                       / "enb_dl_tm4_20mhz.json").read_text())
    traffic = {"subframes_per_call": BATCH, "pool_subframes": BATCH,
               "draw_subframes": BATCH, "check_calls": 1,
               "check_subframes": 4}
    drv = Driver(conf, traffic, 61, "cuda")
    per_call = launches_per_call(lambda: drv.call(0), ["turbo_enc"])
    open_counts()
    drv.call(0)
    call_shapes = trace.launch_shapes("turbo_enc")
    cbs = 2 * BATCH * conf["code_blocks"]["count"]
    checks = {
        "twin_every_k": all(v == [0, 0] for v in every_k.values()),
        "twin_every_dtype": all(v == 0 for v in dtypes.values()),
        "twin_cell_shapes": all(v["mismatched"] == 0
                                for v in timed.values()),
        "one_launch_a_tx_call": per_call["turbo_enc"] == 1,
        "every_code_block_in_the_launch": call_shapes
        == {(conf["code_blocks"]["k"], cbs): 1},
    }
    m = timed["cell_b256x2"]
    out = {"phase": "turbo_enc", "ks": len(every_k),
           "mismatched_by_k": {k: v for k, v in every_k.items()
                               if v != [0, 0]},
           "mismatched_by_dtype": dtypes, "shapes": timed,
           "launches_per_tx_call": per_call["turbo_enc"],
           "tx_call_shapes": {str(k): v for k, v in call_shapes.items()},
           "main": {k: m[k] for k in ("ms", "bound_ms", "over_bound",
                                      "twin_ms")},
           "ptxas": PTXAS.get("turbo_enc"), "checks": checks}
    emit(out)
    check("turbo_enc", checks)
    return out


def tx_dcis(g, cell, cfi: int, count: int, levels, sizes, kind="random",
            lead=(), rntis=(0x1234, 0xFFFF, 0x003D)) -> list:
    """Up to ``count`` DCIs (bits int8 [*lead, size] on the card, rnti,
    cce, L) on disjoint CCEs of the region of ``cell`` and ``cfi``: each
    at the first aligned CCE free for the next level of ``levels``
    (cycled) that fits; sizes and RNTIs cycled; payloads random, all zero
    or all one (``kind``)."""
    import torch

    from empower_srslte_tpu_torch.models import regs

    n_cce = regs.pdcch_nof_cces(cell, cfi)
    used, out = set(), []
    for i in range(4 * count):
        if len(out) == count:
            break
        l = levels[i % len(levels)]
        cce = next((c for c in range(0, n_cce - l + 1, l)
                    if used.isdisjoint(range(c, c + l))), None)
        if cce is None:
            continue
        used.update(range(cce, cce + l))
        shape = (*lead, sizes[len(out) % len(sizes)])
        bits = torch.randint(0, 2, shape, generator=g, device="cuda",
                             dtype=torch.int8)
        if kind != "random":
            bits.fill_(int(kind == "ones"))
        out.append((bits, rntis[len(out) % len(rntis)], cce, l))
    return out


def tx_twin_mismatch(g, cell, cfi: int, sf_idx: int, dcis, lead=()) -> int:
    """The PDCCH kernel (``pdcch_encode_many``) and its plain twin run on
    the card adding ``dcis`` onto the same random grid [*lead, P, S, K]:
    -> the REs where they differ (-1 for another shape or type)."""
    import torch

    from empower_srslte_tpu_torch.models import pdcch

    shape = (*lead, cell.nof_ports, cell.nsymb_sf, cell.nof_re)
    start = torch.complex(torch.randn(shape, generator=g, device="cuda"),
                          torch.randn(shape, generator=g, device="cuda"))
    got, want = start.clone(), start.clone()
    pdcch.pdcch_encode_many(got, dcis, cell, cfi, sf_idx)
    for bits, rnti, cce, l in dcis:
        want += pdcch._pdcch_encode_plain(bits, rnti, cce, l, cell, cfi,
                                          sf_idx)
    if got.shape != want.shape or got.dtype != want.dtype:
        return -1
    return int((got != want).sum())


def tx_kernel_alone(grid, dcis, cell, cfi: int, sf_idx: int):
    """The PDCCH kernel's launches of ``dcis`` onto ``grid`` alone: the
    DCIs checked and their places copied to the card once -> a function
    that makes the launches (``pdcch_encode_at``)."""
    from empower_srslte_tpu_torch.models import pdcch
    from empower_srslte_tpu_torch.utils.device import host_ints

    checked = pdcch.tx_dcis(dcis, cell, cfi, tuple(grid.shape[:-3]),
                            grid.device)
    bits = [b for b, *_ in checked]
    places = host_ints([at for _, *at in checked], grid.device).to(
        grid.device)
    return lambda: pdcch.pdcch_encode_at(grid, bits, places, cell, cfi,
                                         sf_idx)


def tx_hold(cell, cfi: int, sf_idx: int, n: int, k: int, seed: int) -> dict:
    """The PDCCH transmit kernel at one launch shape: ``n`` DCIs of random
    payloads on ``cell``'s region (the first of K ``k``, the others of
    the format-1A size), at the levels 4, 2, 8, 1 as they fit, against
    the twin run on the card; timed by CUDA events (with the wrapper's
    host cost) and by CUDA-graph replay."""
    import torch

    from empower_srslte_tpu_torch.models import dci as dci_mod
    from empower_srslte_tpu_torch.models import pdcch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dcis = tx_dcis(g, cell, cfi, n, (4, 2, 8, 1),
                   (k - 16, dci_mod.format0_1a_size(cell.nof_prb)))
    grid = torch.zeros((1, cell.nof_ports, cell.nsymb_sf, cell.nof_re),
                       dtype=torch.complex64, device="cuda")
    run = tx_kernel_alone(grid, dcis, cell, cfi, sf_idx)
    return {"dcis": len(dcis), "levels": [l for *_, l in dcis],
            "mismatched": (tx_twin_mismatch(g, cell, cfi, sf_idx, dcis)
                           if len(dcis) == n else -1),
            "ms": cuda_ms(run, reps=50), "graph_ms": graph_ms(run, reps=20)}


def phase_pdcch_tx():
    """The PDCCH transmit kernel (``csrc/pdcch_tx.cu``) against its plain
    twin run on the card, the grid bit for bit (REs that differ: 0): at 6,
    25 and 100 PRB, 1, 2 and 4 ports, CFI 1-3, with random, all-zero and
    all-one payloads of the format-1 and format-0/1A sizes, 1-3 DCIs at
    the levels 1, 2, 4 and 8 on disjoint CCEs, added onto a random grid;
    11 DCIs (two launches), leading dims (a DCI a row, and one for every
    row), and ``pdcch_encode`` (a fresh grid) against the twin. Then at
    the transmitter cell (``phybench/configs/enb_dl_tm4_20mhz.json``,
    through ``phybench.drivers.enb_dl_tx_batch``): one launch an
    ``enb_dl_tx_batch`` call for both DCIs; its control range
    (``enb_dl_compose`` with no PDSCH) under
    ``torch.cuda.set_sync_debug_mode("error")``; the host syncs a whole
    call makes (the sync debug mode's warnings); a DCI's payload changed
    between calls changing the samples and changed back restoring them
    (so the chain copies the DCIs in every call); the kernel alone at
    the cell's two DCIs, timed by CUDA events and by
    CUDA-graph replay beside its bound and the twin (CUDA events: its
    reads back to the host); ptxas' registers and spills. The batched
    call's control range replays from its chain of CUDA graphs: its
    samples equal the eager composer's, and a whole call runs under the
    sync debug mode's "error" too. Calls whose RNTIs, CCEs, levels,
    payloads, ACK and PHICH resource change every call replay the one
    chain of their shapes (no chain added, the card's memory flat), each
    equal to the eager composer, timed beside calls that repeat one set;
    calls without DCIs, and without DCIs or HIs, equal it too."""
    import json
    import warnings

    import torch

    from empower_srslte_tpu_torch.models import dci as dci_mod
    from empower_srslte_tpu_torch.models import enb_dl, pdcch, regs
    from empower_srslte_tpu_torch.utils.cell import Cell
    from phybench.drivers.enb_dl_tx_batch import Driver

    g = torch.Generator(device="cuda").manual_seed(27)
    cases = {}
    for prb in (6, 25, 100):
        sizes = (dci_mod.format1_size(prb), dci_mod.format0_1a_size(prb))
        for ports in (1, 2, 4):
            for cfi in (1, 2, 3):
                cell = Cell(nof_prb=prb, nof_ports=ports,
                            id=3 * prb + cfi % 2 + 1)
                for j, kind in enumerate(("random", "zeros", "ones")):
                    levels = ((1, 2, 4, 8), (8, 4, 2, 1), (2, 8, 1, 4))[
                        (cfi + j) % 3]
                    dcis = tx_dcis(g, cell, cfi, 1 + (prb + cfi + j) % 3,
                                   levels, sizes, kind)
                    cases[f"{prb}prb_{ports}p_cfi{cfi}_{kind}"] = {
                        "levels": [l for *_, l in dcis],
                        "mismatched": tx_twin_mismatch(g, cell, cfi, 1,
                                                       dcis)}
    cell = Cell(nof_prb=100, nof_ports=2, id=1)
    sizes = (dci_mod.format1_size(100), dci_mod.format0_1a_size(100))
    many = tx_dcis(g, cell, 3, 11, (1,), sizes)
    rows = tx_dcis(g, cell, 2, 3, (4, 2, 1), sizes, lead=(4,))
    shared = tx_dcis(g, cell, 2, 2, (8, 4), sizes)
    bits, rnti, cce, l = rows[0]
    one = pdcch.pdcch_encode(bits, rnti, cce, l, cell, 2, 1)
    extra = {"dcis11": tx_twin_mismatch(g, cell, 3, 1, many),
             "rows4": tx_twin_mismatch(g, cell, 2, 1, rows, lead=(4,)),
             "rows4_shared": tx_twin_mismatch(g, cell, 2, 1, shared,
                                              lead=(4,)),
             "pdcch_encode_rows4": int((one != pdcch._pdcch_encode_plain(
                 bits, rnti, cce, l, cell, 2, 1)).sum())}

    conf = json.loads((ROOT / "phybench" / "configs"
                       / "enb_dl_tm4_20mhz.json").read_text())
    traffic = {"subframes_per_call": BATCH, "pool_subframes": BATCH,
               "draw_subframes": BATCH, "check_calls": 1,
               "check_subframes": 4}
    drv = Driver(conf, traffic, 63, "cuda")
    cell, cfi, sf = drv.cfg.cell, conf["cfi"], conf["sf_idx"]
    per_call = launches_per_call(lambda: drv.call(0), ["pdcch_tx"])
    open_counts()
    drv.call(0)
    call_shapes = read_counts()[1].get("pdcch_tx", {})

    def control():
        return enb_dl.enb_dl_compose(cell, sf, cfi, BATCH, dcis=drv.dcis,
                                     phichs=drv.phichs, device="cuda")

    def tx(dcis, phichs=drv.phichs):
        rows_ = drv.rows(0)
        return enb_dl.enb_dl_tx_batch(
            drv.tb[0, rows_], drv.cfg, drv.plan, tb2=drv.tb[1, rows_],
            dcis=dcis, phichs=phichs)

    def eager_tx(dcis, phichs):
        rows_ = drv.rows(0)
        return enb_dl.enb_dl_gen_signal(enb_dl.enb_dl_compose(
            cell, sf, cfi, BATCH, dcis=dcis, phichs=phichs,
            pdschs=[(drv.tb[0, rows_], drv.cfg, drv.plan,
                     drv.tb[1, rows_])], device="cuda"), cell)

    control()
    tx(drv.dcis)
    torch.cuda.synchronize()
    sync_error = {}
    for name, fn in (("control_range", control),
                     ("tx_call", lambda: tx(drv.dcis))):
        torch.cuda.set_sync_debug_mode("error")
        try:
            fn()
        except RuntimeError as e:
            sync_error[name] = str(e).splitlines()[0]
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            drv.call(0)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs_a_call = sum("synchroniz" in str(w.message) for w in caught)

    x0 = tx(drv.dcis)
    flipped = [(1 - drv.dcis[0][0], *drv.dcis[0][1:]), *drv.dcis[1:]]
    x1 = tx(flipped)
    x2 = tx(drv.dcis)
    moved = int((x1 != x0).any(-1).sum())
    restored = bool(torch.equal(x2, x0))
    rows_ = drv.rows(0)
    eager = enb_dl.enb_dl_gen_signal(enb_dl.enb_dl_compose(
        cell, sf, cfi, BATCH, dcis=drv.dcis, phichs=drv.phichs,
        pdschs=[(drv.tb[0, rows_], drv.cfg, drv.plan, drv.tb[1, rows_])],
        device="cuda"), cell)
    chain_equal = bool(torch.equal(x0, eager))
    del x1, x2, eager

    # traffic whose control values change every call (RNTIs, CCEs,
    # levels, payloads, the ACK and the PHICH resource): one chain for
    # them all, each call's samples the eager composer's, the card's
    # memory flat, and the calls timed beside calls that repeat one set
    n_group = regs.nof_phich_groups(cell, 1.0)
    assert regs.pdcch_nof_cces(cell, cfi) >= 16
    varied = []
    for j in range(8):
        half = 8 * (j % 2)
        varied.append((
            [((1 - drv.dcis[0][0]) if j % 3 else drv.dcis[0][0],
              (0x1234 + 97 * j) & 0xFFFF, half, (8, 4, 2, 1)[j % 4]),
             (drv.dcis[1][0], (0xFFF0 - 13 * j) & 0xFFFF, 8 - half,
              (1, 2, 4, 8)[j % 4])],
            [((j + 1) % 2, (3 * j) % n_group, (5 * j) % 8)]))
    chains_before = len(enb_dl._CHAINS)
    torch.cuda.synchronize()
    mem_before = torch.cuda.memory_allocated()
    varied_equal = []
    for dcis_j, phichs_j in varied:
        got_j = tx(dcis_j, phichs_j)
        varied_equal.append(bool(torch.equal(got_j,
                                             eager_tx(dcis_j, phichs_j))))
    del got_j
    torch.cuda.synchronize()
    mem_grew = torch.cuda.memory_allocated() - mem_before
    chains_added = len(enb_dl._CHAINS) - chains_before

    def calls_ms(sets, reps=3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            for dcis_j, phichs_j in sets:
                tx(dcis_j, phichs_j)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / (reps * len(sets))

    varied_ms = calls_ms(varied)
    fixed_ms = calls_ms([(drv.dcis, drv.phichs)] * len(varied))

    # calls without DCIs, and without DCIs or HIs (the entry's defaults)
    rows_ = drv.rows(0)
    bare = {
        "no_dcis": bool(torch.equal(tx((), drv.phichs),
                                    eager_tx((), drv.phichs))),
        "no_dcis_no_his": bool(torch.equal(
            enb_dl.enb_dl_tx_batch(drv.tb[0, rows_], drv.cfg, drv.plan,
                                   tb2=drv.tb[1, rows_]),
            eager_tx((), ()))),
    }

    grid = torch.zeros((1, cell.nof_ports, cell.nsymb_sf, cell.nof_re),
                       dtype=torch.complex64, device="cuda")
    run = tx_kernel_alone(grid, drv.dcis, cell, cfi, sf)

    def twin():
        for b, r, c, lv in drv.dcis:
            grid.add_(pdcch._pdcch_encode_plain(b, r, c, lv, cell, cfi, sf))

    res = sum(36 * lv for *_, lv in drv.dcis)
    nbytes = (res * cell.nof_ports * 16 + res * 4 + 2 * res * 4
              + sum(b.numel() for b, *_ in drv.dcis))
    main = {"dcis": len(drv.dcis), "ports": cell.nof_ports,
            "levels": [lv for *_, lv in drv.dcis],
            "mismatched": tx_twin_mismatch(g, cell, cfi, sf, drv.dcis),
            "ms": cuda_ms(run, reps=200), "graph_ms": graph_ms(run, reps=50),
            **bound(nbytes, 0), "twin_ms": cuda_ms(twin, reps=3)}
    main["graph_over_bound"] = main["graph_ms"] / main["bound_ms"]
    main["twin_over_kernel"] = main["twin_ms"] / main["ms"]
    checks = {
        "twin_every_case": all(v["mismatched"] == 0
                               for v in cases.values()),
        "every_level_and_count": {lv for v in cases.values()
                                  for lv in v["levels"]} == {1, 2, 4, 8}
        and {len(v["levels"]) for v in cases.values()} == {1, 2, 3},
        "twin_many_and_rows": all(v == 0 for v in extra.values()),
        "twin_cell_shape": main["mismatched"] == 0,
        "one_launch_a_tx_call": per_call["pdcch_tx"] == 1,
        "both_dcis_in_the_launch": call_shapes == {
            (2, cell.nof_ports, max(b.shape[-1] for b, *_ in drv.dcis)
             + 16): 1},
        "control_range_and_call_without_sync": sync_error == {},
        "changed_dci_changes_the_samples": moved > 0 and restored,
        "control_chain_equals_eager": chain_equal,
        "varied_values_equal_eager": all(varied_equal),
        "varied_values_one_chain": chains_added == 0,
        "varied_values_memory_flat": mem_grew < 2 ** 20,
        "calls_without_dcis_equal_eager": all(bare.values()),
    }
    out = {"phase": "pdcch_tx", "cases": cases, "extra": extra,
           "launches_per_tx_call": per_call["pdcch_tx"],
           "tx_call_shapes": {str(k): v for k, v in call_shapes.items()},
           "sync_error": sync_error, "syncs_a_tx_call": syncs_a_call,
           "sync_warnings": sorted({str(w.message).splitlines()[0][:160]
                                    for w in caught}),
           "subframes_moved_by_a_changed_dci": moved,
           "varied_values": {"calls": len(varied), "equal": varied_equal,
                             "chains_added": chains_added,
                             "memory_grew_bytes": mem_grew,
                             "ms_a_call": varied_ms,
                             "ms_a_call_one_set": fixed_ms},
           "without_dcis": bare, "main": main,
           "ptxas": PTXAS.get("pdcch_tx"), "checks": checks}
    emit(out)
    check("pdcch_tx", checks)
    return out


def phase_main_path():
    """The main path: TM4 transmitter (plain PyTorch) -> receiver."""
    import torch

    from empower_srslte_tpu_torch.models.enb_dl import tm4_stimulus
    from empower_srslte_tpu_torch.models.ue_dl import ue_dl_tm4_batch

    t0 = time.perf_counter()
    st = tm4_stimulus(BATCH, device="cuda")
    torch.cuda.synchronize()
    tx_s = time.perf_counter() - t0

    res, launches, ms_first, ms, peak, shapes = counted_run(
        lambda: ue_dl_tm4_batch(st.samples, st.cfg, st.plan))
    turbo = hold_shapes("main_path", turbo_shapes(shapes), seed=51)
    graphed = chain_checks("ue_dl.tm4_batch", st.samples, st.cfg, st.plan)
    b1, b2 = res.tb_bits
    ok1, ok2 = res.crc_ok
    checks = {
        "crc_ok": bool(ok1.all() and ok2.all()),
        "bits_equal": bool(torch.equal(b1, st.tb) and torch.equal(b2, st.tb2)),
        "cfi_found": bool((res.cfi == st.cfg.cfi).all()),
        "dci_found": bool((res.dci_hits >= 1).all()),
        "turbo_bf16_launched": launches["turbo_nii_bf16"] > 0,
        "no_turbo_f32_launch": launches["turbo_nii"] == 0,
        "pdcch_kernels_one_launch_each": launches["ctrl_llr"] == 1
        and launches["pdcch_blind"] == 1,
        **graphed,
        **turbo_checks(turbo),
    }
    tbs = st.plan.tbs
    emit({"phase": "main_path", "batch": BATCH, "nof_prb": 100,
          "mcs": 25, "tbs": tbs, "codewords": 2, "tx_s": round(tx_s, 3),
          "ms_per_batch": ms, "ms_counted_run": ms_first,
          "mbps": BATCH * 2 * tbs / (ms * 1e-3) / 1e6,
          "turbo_iterations": res.iterations, "launches": launches,
          "turbo_dtype": dt_name(st.plan.decoder(
              st.plan.segm.cb_sizes[0]).metric_dtype),
          "turbo_shapes": turbo, "peak_mem_gb": peak, "checks": checks})
    check("main path", checks)
    return launches, turbo


def chain_checks(root: str, samples, cfg, plan) -> dict:
    """A batched receiver's call replayed from its chain of CUDA graphs
    against the same stages run eagerly on the same subframes, answers
    and de-rate-matched LLRs (the hook on ``pdsch_decode``) bit for bit;
    and a replay on the subframes in reverse order, whose answers must be
    the first replay's in reverse."""
    import torch

    from empower_srslte_tpu_torch.models import ue_dl
    from empower_srslte_tpu_torch.runtime import graphs
    from phybench.observe import tapped

    soft: list = []

    def keep(_args, _kwargs, result):
        per_cw = result[2] if cfg.nof_codewords == 2 else (result[2],)
        soft.append(torch.stack([torch.stack(list(s), dim=-2)
                                 for s in per_cw]))

    with tapped([(ue_dl, "pdsch_decode", keep)]):
        res = ue_dl._ue_dl_batch(root, samples, cfg, plan)
        eager = ue_dl._ue_dl_batch(root, samples, cfg, plan,
                                   stages=graphs.EAGER)
    flipped = ue_dl._ue_dl_batch(root, samples.flip(0), cfg, plan)
    same = lambda a, b: all(torch.equal(x, y) for x, y in zip(a, b))
    rev = lambda a: tuple(x.flip(0) for x in a)
    return {
        "graphs_equal_eager": bool(
            same(res.tb_bits, eager.tb_bits) and same(res.crc_ok, eager.crc_ok)
            and torch.equal(res.cfi, eager.cfi)
            and torch.equal(res.dci_hits, eager.dci_hits)
            and torch.equal(soft[0], soft[1])),
        "graphs_follow_their_input": bool(
            same(flipped.tb_bits, rev(res.tb_bits))
            and same(flipped.crc_ok, rev(res.crc_ok))
            and torch.equal(flipped.cfi, res.cfi.flip(0))
            and torch.equal(flipped.dci_hits, res.dci_hits.flip(0))),
    }


def tm2_batch_stimulus(n: int, seed: int = 2**31 + 26):
    """``n`` subframes of the benchmark's 4-port TM2 cell
    (``phybench/configs/dl_tm2_20mhz_4port.json``: 100 PRB, 4 CRS ports,
    2 rx, MCS 28, one codeword) from its transmitter
    (``phybench/inputs/dl_tm2.py``) on the card at 30 dB: -> (the
    configuration, the transmitter's dict, the port's PdschConfig and
    plan)."""
    import torch

    from phybench.drivers.ue_dl_tm2_batch import port_plan
    from phybench.inputs import dl_tm2 as tx

    conf = json.loads((ROOT / "phybench" / "configs"
                       / "dl_tm2_20mhz_4port.json").read_text())
    g = torch.Generator(device="cuda").manual_seed(seed)
    sent = tx.transmit(conf, {"snr_db": 30.0}, n, g, "cuda")
    return conf, sent, *port_plan(conf)


def phase_dl_tm2_batch():
    """The batched transmit-diversity receiver ``ue_dl_tm2_batch`` at 100
    PRB on 4 ports and 2 rx, on the benchmark cell's waveform: the
    launches, the time and the answers of a 256-subframe call; every
    kernel held to its twin at the shapes it launched (``hold_shapes``,
    the control LLR and CRS estimate kernels included); and the call's
    de-rate-matched LLRs (the benchmark's hook, ``pdsch_decode``'s third
    result) and answers on 4 subframes against the plain reference
    ``phybench/references/dl_tm2.py``."""
    import torch

    from empower_srslte_tpu_torch.models import ue_dl
    from phybench.compare import gap, tb_diff
    from phybench.observe import tapped
    from phybench.references import dl_tm2

    conf, sent, cfg, plan = tm2_batch_stimulus(BATCH)
    samples = sent["samples"]
    sink: dict = {}

    def keep(_args, _kwargs, result):
        sink["soft"] = torch.stack(list(result[2]), dim=-2)

    res, launches, ms_first, ms, peak, shapes = counted_run(
        lambda: ue_dl.ue_dl_tm2_batch(samples, cfg, plan))
    with tapped([(ue_dl, "pdsch_decode", keep)]):
        again = ue_dl.ue_dl_tm2_batch(samples, cfg, plan)
    graphed = chain_checks("ue_dl.tm2_batch", samples, cfg, plan)
    held = hold_shapes("dl_tm2_batch", {
        **turbo_shapes(shapes), **{k: shapes[k] for k in (
            "pdcch_blind", "ctrl_llr", "chest_dl") if k in shapes}},
        seed=26, cell=cfg.cell, cfi=cfg.cfi, sf_idx=cfg.sf_idx)
    rows = 4
    t0 = time.perf_counter()
    want = dl_tm2.receive(samples[:rows].cpu().numpy(), conf)
    ref_s = time.perf_counter() - t0
    limit = json.loads((ROOT / "phybench" / "limits"
                        / "dl_tm2_4p_b256.json").read_text())["gap.soft"]
    soft_gap = gap(sink["soft"][None, :rows].float().cpu().numpy(),
                   want["soft"])
    diff = tb_diff(res.crc_ok[0][None, :rows].cpu().numpy(),
                   res.tb_bits[0][None, :rows].cpu().numpy(),
                   want["crc"], want["bits"])
    checks = {
        "crc_ok": bool(res.crc_ok[0].all()),
        "bits_equal": bool(torch.equal(res.tb_bits[0], sent["tb"])),
        "cfi_found": bool((res.cfi == cfg.cfi).all()),
        "dci_found": bool((res.dci_hits >= 1).all()),
        "gap_soft_within_limit": soft_gap <= limit,
        "answers_equal_reference": diff == 0,
        "replay_equal": bool(torch.equal(again.tb_bits[0], res.tb_bits[0])
                             and torch.equal(again.crc_ok[0],
                                             res.crc_ok[0])),
        "turbo_bf16_launched": launches["turbo_nii_bf16"] > 0,
        "no_turbo_f32_launch": launches["turbo_nii"] == 0,
        "one_chest_and_control_launch_each": launches["chest_dl"] == 1
        and launches["ctrl_llr"] == 1 and launches["pdcch_blind"] == 1,
        "e_split_n_l_2": list(plan.e_sizes) == conf["code_blocks"]["e"],
        **graphed,
        **turbo_checks(held),
    }
    emit({"phase": "dl_tm2_batch", "batch": BATCH, "nof_prb": 100,
          "ports": 4, "rx": 2, "mcs": conf["mcs"], "tbs": plan.tbs,
          "codewords": 1, "ms_per_batch": ms, "ms_counted_run": ms_first,
          "mbps": BATCH * plan.tbs / (ms * 1e-3) / 1e6,
          "turbo_iterations": res.iterations, "launches": launches,
          "gap_soft": soft_gap, "gap_soft_limit": limit, "diff_tb": diff,
          "reference_rows": rows, "reference_s": ref_s,
          "held_shapes": held, "peak_mem_gb": peak, "checks": checks})
    check("dl_tm2_batch", checks)
    return launches, held


def phase_enb_dl_tx():
    """The eNB's downlink transmitter (``enb_dl_tx_batch``) at the
    benchmark cell's shape (``phybench/configs/enb_dl_tm4_20mhz.json``):
    BATCH subframes of the 20 MHz 2x2 TM4 grant at MCS 28 with the
    format-1 and format-0 DCIs and a HARQ indicator, through the cell's
    driver. Every call's samples equal the first's; on 4 subframes the
    samples are held to ``phybench/references/dl_tx.py`` (their gap over
    the reference's largest magnitude under 1e-5, no RE decided apart).
    Its launches from the launch registry (the turbo encoder kernel, once
    a call: one K; the PDCCH kernel, once a call for both DCIs, held to
    its twin at each shape it launched, ``hold_shapes``) and, from one
    call under ``torch.profiler``, the kernels a call launches."""
    import json

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from phybench.drivers.enb_dl_tx_batch import Driver

    conf = json.loads((ROOT / "phybench" / "configs"
                       / "enb_dl_tm4_20mhz.json").read_text())
    traffic = {"subframes_per_call": BATCH, "pool_subframes": BATCH,
               "draw_subframes": BATCH, "check_calls": 1,
               "check_subframes": 4}
    drv = Driver(conf, traffic, 61, "cuda")
    res, launches, ms_first, ms, peak, shapes = counted_run(
        lambda: drv.call(0))
    drv.tally(0, res)
    del res
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        drv.tally(0, drv.call(0))
    kernels = sum(1 for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation
                  and not e.name.startswith(("Memcpy", "Memset")))
    t0 = time.perf_counter()
    readings = drv.check()
    ref_s = time.perf_counter() - t0
    held = hold_shapes("enb_dl_tx", {"pdcch_tx": shapes.get("pdcch_tx", {})},
                       seed=62, cell=drv.cfg.cell, cfi=conf["cfi"],
                       sf_idx=conf["sf_idx"])["pdcch_tx"]
    checks = {
        "gap_samples_under_1e-5": readings["gap.samples"] < 1e-5,
        "no_re_decided_apart": readings["diff.re"] == 0,
        "replay_equal": readings["replay"] == 0,
        "every_call_equal_the_first": all(bool(e.all())
                                          for e, *_ in drv.log),
        "one_turbo_enc_and_one_pdcch_tx_launch": dict(launches)
        == {"turbo_enc": 1, "pdcch_tx": 1},
        "pdcch_tx_twin_every_shape": bool(held) and all(
            v["mismatched"] == 0 for v in held.values()),
    }
    emit({"phase": "enb_dl_tx", "batch": BATCH, "nof_prb": conf["nof_prb"],
          "mcs": conf["mcs"], "tbs": conf["tbs"], "codewords": 2,
          "ms_per_batch": ms, "ms_counted_run": ms_first,
          "mbps": BATCH * 2 * conf["tbs"] / (ms * 1e-3) / 1e6,
          "launches": dict(launches), "kernels_per_call": kernels,
          "peak_mem_gb": peak, "reference_s": round(ref_s, 2),
          "readings": readings, "pdcch_tx_held": held, "checks": checks})
    check("enb_dl_tx", checks)
    return launches


def win_inputs(g, k: int, b: int, dtype="float32"):
    """Random lsa, lp [K+3, B] of one ``map_decode_win`` call, in
    ``dtype``."""
    import torch

    return tuple((torch.randn(k + 3, b, generator=g, device=g.device)
                  * 4.0).to(getattr(torch, dtype)) for _ in range(2))


def win_work(k: int, l: int, o: int, b: int, dtype="float32"):
    """(compulsory bytes, operations) of one ``map_decode_win`` launch:
    lsa, lp read once and llr written once, at 4 or 2 bytes a value."""
    w = k // l
    return (itemsize(dtype) * (2 * (k + 3) + k) * b,
            w * b * ((l + o) * 2 * WIN_OPS_STEP + l * WIN_OPS_EMIT
                     + 2 * ((l + o) // 8) * WIN_OPS_RENORM))


def win_twin(lsa, lp, kw):
    """The windowed kernel and its plain twin on the same inputs: -> (max
    abs error, the twin's output); both do the same adds in the same
    order and dtype, so the error must be exactly 0."""
    import torch

    from empower_srslte_tpu_torch.ops.fec.turbo_win import (
        map_decode_win, map_decode_win_plain)

    got = map_decode_win(lsa, lp, **kw)
    ref = map_decode_win_plain(lsa, lp, **kw)
    torch.cuda.synchronize()
    return max_abs_err(got, ref), ref


def win_shape_time(k: int, l: int, b: int, seed: int,
                   dtype="float32") -> dict:
    """The windowed kernel timed at one launch shape, in ``dtype``, as
    ``nii_shape_time`` times the NII kernel (``ms`` launch by launch,
    ``ms_graphed`` by CUDA-graph replay), its plain twin (one call) and its
    bound; not counted."""
    import torch

    from empower_srslte_tpu_torch.ops.fec.turbo_win import (
        DEFAULT_OVERLAP, map_decode_win, map_decode_win_plain, win_plan)

    g = torch.Generator(device="cuda").manual_seed(seed)
    lsa, lp = win_inputs(g, k, b, dtype)
    kw = dict(k=k, l=l, o=DEFAULT_OVERLAP)
    plan = win_plan(l, DEFAULT_OVERLAP, getattr(torch, dtype), b, k // l,
                    sms=card_sms())
    return {"k": k, "window": l, "cbs": b, "dtype": dtype,
            "design": "split" if plan.sides == 2 else "one_thread",
            "ms": cuda_ms(lambda: map_decode_win(lsa, lp, **kw), reps=10),
            "ms_graphed": graph_ms(lambda: map_decode_win(lsa, lp, **kw),
                                   reps=10),
            "plain_ms": cuda_ms(lambda: map_decode_win_plain(lsa, lp, **kw),
                                reps=1),
            **bound(*win_work(k, l, DEFAULT_OVERLAP, b, dtype), dtype)}


def turbo_win_kernel_check():
    """map_decode_win against the plain twin, max abs error exactly 0, in
    float32 and in bfloat16, at the uplink path's geometry (256 x 7 code
    blocks of K=5824, window 224, overlap 40), at K=1024 with its decoder
    window and, in bfloat16, at an odd batch (1791 code blocks); then one
    full windowed decode of 64 code blocks near threshold per dtype where
    hard bits and iteration counts must be equal. The uplink shape is
    timed in turns (float32, bfloat16, bfloat16, float32); with
    ``--baseline``, each baseline in turns with the port at the uplink
    shape in both dtypes, in bfloat16 at twice and four times its code
    blocks (copies: what more warps buy), and at one code block of K 1024,
    graphed and launch by launch. -> (float32 entry, bfloat16 entry) of
    the kernels line."""
    import torch

    from empower_srslte_tpu_torch.models.sch import _pick_window
    from empower_srslte_tpu_torch.ops.fec.turbo_decoder import TurboDecoder
    from empower_srslte_tpu_torch.ops.fec.turbo_win import (
        DEFAULT_OVERLAP, map_decode_win, map_decode_win_plain, win_plan)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    o = DEFAULT_OVERLAP
    k, b = 5824, BATCH * 7
    l = _pick_window(k)
    w = k // l
    errs, main = {}, {}
    for dt in ("float32", "bfloat16"):
        geos = {"uplink": (k, b), "k1024": (1024, BATCH)}
        if dt == "bfloat16":
            geos["odd_batch"] = (k, b - 1)
        errs[dt] = {}
        for name, (kk, bb) in geos.items():
            kw = dict(k=kk, l=_pick_window(kk), o=o)
            lsa, lp = win_inputs(g, kk, bb, dt)
            errs[dt][name], ref = win_twin(lsa, lp, kw)
            if name == "uplink":
                main[dt] = (lsa, lp, kw, ref)
    assert not any(v for e in errs.values() for v in e.values()), \
        f"windowed kernel vs plain twin: {errs}"
    run = {dt: (lambda m=main[dt]: map_decode_win(m[0], m[1], **m[2]))
           for dt in main}
    times = dtype_turns(run["float32"], run["bfloat16"], reps=10)

    cases = {dt: ((m[0], m[1]), m[2], m[3], cuda_ms)
             for dt, m in main.items()}
    if BASELINES:
        lsa, lp, kw, ref = main["bfloat16"]
        for n in (2, 4):
            cases[f"bfloat16_x{n}"] = ((lsa.repeat(1, n), lp.repeat(1, n)),
                                       kw, ref.repeat(1, n), cuda_ms)
        kw1 = dict(k=1024, l=_pick_window(1024), o=o)
        pair1 = win_inputs(g, 1024, 1, "bfloat16")
        ref = win_twin(*pair1, kw1)[1]
        cases.update(bfloat16_k1024_cbs1=(pair1, kw1, ref, graph_ms),
                     bfloat16_k1024_cbs1_ungraphed=(pair1, kw1, ref,
                                                    cuda_ms))
        for kk, bb in BASELINE_SWEEP["turbo_win"]:
            kwb = dict(k=kk, l=_pick_window(kk), o=o)
            pair = win_inputs(g, kk, bb, "bfloat16")
            cases[f"bfloat16_k{kk}_cbs{bb}"] = (
                pair, kwb, win_twin(*pair, kwb)[1], graph_ms)
    base_line = {"baselines": baseline_pairs("map_decode_win",
                                             map_decode_win, cases)}

    u, llr = awgn_code_blocks(g, k, 64, 0.9)
    out, line = {}, {"phase": "kernel_turbo_win", "cbs": b, "k": k,
                     "window": l, "overlap": o,
                     "turns_ms": times["turns_ms"]}
    for dt, tag in (("float32", "OpsF32"), ("bfloat16", "OpsBf16x2")):
        lsa, lp, kw, _ = main[dt]
        ms = times[dt]
        plain_ms = cuda_ms(lambda: map_decode_win_plain(lsa, lp, **kw),
                           reps=1)
        plan = win_plan(l, o, getattr(torch, dt), b, w, sms=card_sms())
        # what the design moves: every window's rows twice and its 2O
        # overlap rows once more (lsa, lp), llr written once and, with
        # one thread per window, the 8-value checkpoints of the segments
        # above the first written and read (the split kernel keeps them
        # on chip)
        moved = itemsize(dt) * ((2 * (2 * k + 2 * o * w) + k) * b
                                + (2 * 8 * (l // 8 - 1) * w * b
                                   if plan.sides == 1 else 0))
        dec = TurboDecoder(k=k, iterations=8, window=l, impl="windowed",
                           dtype=dt)
        ptxas = ptxas_of("turbo_win", tag)
        entry = {"max_abs_err": max(errs[dt].values()), "ms": ms,
                 "plain_ms": plain_ms,
                 **bound(*win_work(k, l, o, b, dt), dt),
                 **kernel_design("turbo_win", dt, plan)}
        line[dt] = {**entry, "max_abs_err_by_geometry": errs[dt],
                    "smem_dynamic": plan.smem,
                    "cbs_per_thread": plan.cbs_per_thread,
                    "ptxas": ptxas,
                    "moved_gb": moved / 1e9,
                    "moved_tb_s": moved / (ms * 1e-3) / 1e12,
                    "decode_cbs": 64,
                    **decode_vs_twin(dec, llr, u, map_decode_win_plain)}
        out[dt] = entry
    emit({**line, **base_line})
    return out["float32"], out["bfloat16"]


def recursion_kernel_check():
    """The probe kernel against its twin, bit for bit after 64 steps for
    each type; then the tool's own entry point at 4096 steps, which is
    the path its launch count is read from."""
    import torch

    from empower_srslte_tpu_torch.runtime import trace
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
    before = trace.launch_counts()
    rates = mr.run(steps)
    launches = sum(launches_since(before, [t[3].name for t in mr.TYPES])
                   .values())
    f32 = rates[0]
    emit({"phase": "kernel_recursion", "mismatched": mism,
          "rates": rates, "launches": launches, "plain_ms": plain_ms})
    assert launches > 0
    return launches, dict(max_abs_err=err, ms=f32["ms"], plain_ms=plain_ms,
                          **bound(2 * x.numel() * 4, f32["ops"])), rates


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


def ul_turbo_dtype(plan) -> str:
    """The metric dtype the UL-SCH plan's decoder resolves to."""
    data = plan.data_plan
    return dt_name(data.decoder(data.segm.cb_sizes[0]).metric_dtype)


def phase_uplink():
    """The uplink path: UE PUSCH+UCI transmitter (plain PyTorch) ->
    channel + AWGN -> eNB receiver, 256 subframes at n0 = UL_N0."""
    import torch

    from empower_srslte_tpu_torch.models.ue_ul import ul_uci_stimulus

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
    (out, its), launches, ms_first, ms, peak, shapes = counted_run(
        lambda: run_uplink(st, UL_N0))
    turbo = hold_shapes("uplink_path", turbo_shapes(shapes), seed=52)
    errs = uci_errors(out, st.plan)
    checks = {
        "crc_ok": bool(out["crc_ok"].all()),
        "bits_equal": bool(torch.equal(out["tb"], st.tb)),
        "ack_equal": errs["ack"] == 0, "ri_equal": errs["ri"] == 0,
        "cqi_equal": errs["cqi"] == 0, "cqi_crc_ok": errs["cqi_crc_fail"] == 0,
        "turbo_win_bf16_2_per_iteration":
            launches["turbo_win_bf16"] == 2 * sum(its),
        "no_turbo_win_f32_launch": launches["turbo_win"] == 0,
        "viterbi_launched": launches["viterbi37"] > 0,
        "no_nii_launch": launches["turbo_nii"] + launches["turbo_nii_bf16"]
        == 0,
        **turbo_checks(turbo),
    }
    tbs = st.plan.tbs
    emit({"phase": "uplink_path", "batch": BATCH, "nof_prb": 100,
          "n_prb": st.cfg.n_prb, "mcs": 20, "tbs": tbs, "n0": UL_N0,
          "q_cqi": st.plan.q_cqi, "q_ri": st.plan.q_ri,
          "q_ack": st.plan.q_ack, "tx_s": round(tx_s, 3),
          "ms_per_batch": ms, "ms_counted_run": ms_first,
          "mbps": BATCH * tbs / (ms * 1e-3) / 1e6,
          "turbo_iterations": its, "launches": launches,
          "turbo_dtype": ul_turbo_dtype(st.plan), "turbo_shapes": turbo,
          "peak_mem_gb": peak, "checks": checks})
    check("uplink path", checks)
    return launches, vit, turbo


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
          "turbo_dtype": ul_turbo_dtype(st.plan),
          "ms_per_batch": ms, "bler": bler,
          "mbps_decoded": good * st.plan.tbs / (ms * 1e-3) / 1e6,
          "turbo_iterations": its, "uci_errors": uci_errors(out, st.plan)})
    assert its[0] > 1, f"mid-SNR run did not iterate: {its}"
    assert bler <= 0.5, f"mid-SNR BLER {bler}"


def phase_tm2():
    """TM2 on 4 ports (SFBC-FSTD) through ``pdsch_decode`` with a genie
    channel: 256 subframes on the float32 lane (``tm2_path``), then the
    same draws on the int8 lane (``tm2_int8_path``), whose bits must equal
    the float32 lane's."""
    import dataclasses

    import torch

    from empower_srslte_tpu_torch.models import ra
    from empower_srslte_tpu_torch.models.enb_dl import genie_stimulus
    from empower_srslte_tpu_torch.models.pdsch import (PdschConfig,
                                                       pdsch_decode)
    from empower_srslte_tpu_torch.ops.equalizer import MimoType
    from empower_srslte_tpu_torch.utils.cell import Cell

    mod, tbs = ra.mcs_to_tbs(TM2_MCS, 100)
    cfg = PdschConfig(cell=Cell(nof_prb=100, nof_ports=4, id=1), sf_idx=1,
                      cfi=1, rnti=0x1234, mod=mod, mimo=MimoType.DIVERSITY,
                      nof_layers=4)
    t0 = time.perf_counter()
    st = genie_stimulus(cfg, cfg.plan(tbs), BATCH, DL_N0, seed=21,
                        device="cuda")
    torch.cuda.synchronize()
    tx_s = time.perf_counter() - t0
    # both lanes decode in the plan's dtype (bfloat16) at the same turbo
    # geometry
    out = {}
    for phase, c in (("tm2_path", cfg),
                     ("tm2_int8_path", dataclasses.replace(cfg,
                                                           llr_int8=True))):
        its: list = []

        def run():
            its.clear()
            return pdsch_decode(st.y, st.h, c, st.plan, noise_est=DL_N0,
                                iters_out=its)

        (bits, ok, soft), launches, ms_first, ms, peak, shapes = \
            counted_run(run)
        twin = hold_shapes(phase, turbo_shapes(shapes), seed=31)
        out[phase] = dict(bits=bits, launches=launches, turbo=twin)
        checks = {"crc_ok": bool(ok.all()),
                  "bits_equal": bool(torch.equal(bits, st.tbs[0])),
                  "turbo_bf16_launched": launches["turbo_nii_bf16"] > 0,
                  **turbo_checks(twin)}
        if c.llr_int8:
            checks["bits_equal_f32_lane"] = bool(
                torch.equal(bits, out["tm2_path"]["bits"]))
            checks["int8_softbuffers"] = all(s.dtype == torch.int8
                                             for s in soft)
        emit({"phase": phase, "batch": BATCH, "nof_prb": 100, "ports": 4,
              "rx": 2, "mimo": "diversity", "mcs": TM2_MCS, "tbs": tbs,
              "n0": DL_N0, "channel": "iid per PRB and symbol",
              "llr_int8": c.llr_int8, "tx_s": round(tx_s, 3),
              "ms_per_batch": ms, "ms_counted_run": ms_first,
              "mbps": BATCH * tbs / (ms * 1e-3) / 1e6,
              "turbo_iterations": list(its), "launches": launches,
              "turbo_shapes": twin,
              "softbuffer_bytes_per_tb": soft_bytes_per_tb(
                  [s[0] for s in soft]),
              "peak_mem_gb": peak, "checks": checks})
        check(phase, checks)
    return ({k: v["launches"] for k, v in out.items()},
            {k: v["turbo"] for k, v in out.items()})


def phase_tm3():
    """TM3 large-delay CDD, 2 layers, 2 codewords, through
    ``pdsch_decode`` with the "20mimo" genie channel (i.i.d. per RE)."""
    import torch

    from empower_srslte_tpu_torch.models import ra
    from empower_srslte_tpu_torch.models.enb_dl import genie_stimulus
    from empower_srslte_tpu_torch.models.pdsch import (PdschConfig,
                                                       pdsch_decode)
    from empower_srslte_tpu_torch.ops.equalizer import MimoType
    from empower_srslte_tpu_torch.utils.cell import Cell

    mod, tbs = ra.mcs_to_tbs(TM3_MCS, 100)
    cfg = PdschConfig(cell=Cell(nof_prb=100, nof_ports=2, id=1), sf_idx=1,
                      cfi=1, rnti=0x1234, mod=mod, mimo=MimoType.CDD,
                      nof_layers=2, nof_codewords=2)
    plan = cfg.plan(tbs)
    t0 = time.perf_counter()
    st = genie_stimulus(cfg, plan, BATCH, DL_N0, seed=23, device="cuda")
    torch.cuda.synchronize()
    tx_s = time.perf_counter() - t0
    # both codewords share the plan: one turbo batch of 2 x BATCH TBs
    its: list = []

    def run():
        its.clear()
        return pdsch_decode(st.y, st.h, cfg, plan, noise_est=DL_N0,
                            plan2=plan, iters_out=its)

    (bits, ok, _), launches, ms_first, ms, peak, shapes = counted_run(run)
    twin = hold_shapes("tm3_path", turbo_shapes(shapes), seed=32)
    checks = {"crc_ok": bool(ok[0].all() and ok[1].all()),
              "bits_equal": all(bool(torch.equal(b, t))
                                for b, t in zip(bits, st.tbs)),
              "turbo_bf16_launched": launches["turbo_nii_bf16"] > 0,
              **turbo_checks(twin)}
    emit({"phase": "tm3_path", "batch": BATCH, "nof_prb": 100, "ports": 2,
          "rx": 2, "mimo": "cdd", "codewords": 2, "mcs": TM3_MCS,
          "tbs": tbs, "n0": DL_N0, "channel": "iid per RE",
          "tx_s": round(tx_s, 3), "ms_per_batch": ms,
          "ms_counted_run": ms_first,
          "mbps": BATCH * 2 * tbs / (ms * 1e-3) / 1e6,
          "turbo_iterations": list(its), "launches": launches,
          "turbo_shapes": twin, "peak_mem_gb": peak, "checks": checks})
    check("tm3_path", checks)
    return launches, twin


def phase_ue_dl_frame():
    """The no-genie per-subframe receiver ``ue_dl_decode`` over a radio
    frame of the 4-port TM2 cell (``tm2_frame_stimulus``): CFI, the C-RNTI
    grant, its PDSCH and the PHICH in every subframe, the SI-RNTI format
    1C grant in sf 5 (a second call), and the int8-lane HARQ pair of sf 2
    (fails alone) and sf 3 (decodes combined)."""
    import torch

    from empower_srslte_tpu_torch.models import enb_dl
    from empower_srslte_tpu_torch.models.dci import DciDl, DciDl1C
    from empower_srslte_tpu_torch.models.ue_dl import ue_dl_decode
    from empower_srslte_tpu_torch.ops.equalizer import MimoType

    t0 = time.perf_counter()
    fr = enb_dl.tm2_frame_stimulus(device="cuda")
    torch.cuda.synchronize()
    tx_s = time.perf_counter() - t0
    harq_sfs = enb_dl.FRAME_HARQ_SFS

    # the turbo kernels and the blind-search kernel at every shape the
    # counted run launches (one TB per call; one blind launch a call over
    # formats 1A, 1 and 2, or 1C for the SI-RNTI, as ue_dl_decode picks)
    def run():
        harq: dict = {}
        out = []
        for sf in range(10):
            out.append(ue_dl_decode(
                fr.samples[sf], fr.cell, sf, fr.rnti,
                mimo=MimoType.DIVERSITY, harq_state=harq, phich=fr.phich,
                llr_int8=sf in harq_sfs))
            if sf == enb_dl.FRAME_SI_SF:
                out.append(ue_dl_decode(fr.samples[sf], fr.cell, sf, 0xFFFF,
                                        mimo=MimoType.DIVERSITY))
        return out

    res, launches, ms_first, ms, peak, shapes = counted_run(run)
    nii_twin = hold_shapes("ue_dl_frame", turbo_shapes(shapes), seed=33)
    blind_twin = hold_shapes("ue_dl_frame",
                             {"pdcch_blind": shapes["pdcch_blind"]},
                             seed=35)["pdcch"]
    calls = len(res)
    per_sf, checks = [], {}
    ok_all = {"cfi": True, "dci": True, "crc": True, "bits": True,
              "phich": True}
    by_call = iter(res)
    for sf in range(10):
        r = next(by_call)
        hit = [x for x in r if isinstance(x.dci, DciDl)]
        want_ok = sf != harq_sfs[0]
        crc = bool(hit) and hit[0].crc_ok
        ok_all["cfi"] &= all(x.cfi == enb_dl.FRAME_CFI for x in r)
        ok_all["dci"] &= len(hit) == 1
        ok_all["crc"] &= crc == want_ok
        ok_all["bits"] &= (not want_ok or crc and bool(
            (torch.as_tensor(hit[0].tb_bits) == fr.tb[sf].cpu()).all()))
        ok_all["phich"] &= all(x.phich_ack == bool(fr.acks[sf]) for x in r)
        per_sf.append({"sf": sf, "crc_ok": crc, "ack_sent": fr.acks[sf],
                       "snr_db": fr.snr_db[sf]})
        if sf == enb_dl.FRAME_SI_SF:
            si = next(by_call)
            hit1c = [x for x in si if isinstance(x.dci, DciDl1C)]
            checks["si_1c_decoded"] = (
                len(hit1c) == 1 and hit1c[0].crc_ok and bool(
                    (torch.as_tensor(hit1c[0].tb_bits)
                     == fr.si_tb.cpu()).all()))
    checks.update({f"{k}_all_subframes": v for k, v in ok_all.items()})
    checks["harq_sf2_fails_alone"] = per_sf[harq_sfs[0]]["crc_ok"] is False
    checks["harq_sf3_combined_ok"] = per_sf[harq_sfs[1]]["crc_ok"] is True
    # the frame's TBs (K 5120, l 256) in bfloat16, the SI's K 280 (no
    # window) in float32
    checks["turbo_bf16_launched"] = launches["turbo_nii_bf16"] > 0
    checks["blind_kernel_launched"] = launches["pdcch_blind"] == calls
    checks["blind_twin_exact_every_shape"] = bool(blind_twin) and all(
        v["exact"] for v in blind_twin.values())
    checks.update(turbo_checks(nii_twin))
    # the TBs whose CRC passed: sf 2's copy fails, sf 3 decodes that TB
    decoded_bits = sum(int(fr.tb[x["sf"]].numel()) for x in per_sf
                       if x["crc_ok"]) \
        + int(fr.si_tb.numel()) * checks["si_1c_decoded"]
    emit({"phase": "ue_dl_frame", "nof_prb": enb_dl.FRAME_NOF_PRB,
          "ports": 4, "rx": 1, "cfi": enb_dl.FRAME_CFI,
          "mcs": enb_dl.FRAME_MCS, "subframes": 10, "calls": calls,
          "snr_db": enb_dl.FRAME_SNR_DB,
          "harq_snr_db": enb_dl.FRAME_HARQ_SNR_DB,
          "harq_subframes": list(harq_sfs), "phich": list(fr.phich),
          "tbs": int(fr.tb[0].numel()), "tx_s": round(tx_s, 3),
          "ms_per_frame": ms, "ms_per_call": ms / calls,
          "ms_counted_run": ms_first,
          "mbps": decoded_bits / (ms * 1e-3) / 1e6,
          "launches": launches, "turbo_shapes": nii_twin,
          "blind_twin": blind_twin, "peak_mem_gb": peak,
          "per_subframe": per_sf, "checks": checks})
    check("ue_dl_frame", checks)
    return launches, nii_twin


def phase_uplink_int8():
    """The uplink path's grant without UCI (``ul_stimulus``: 256 subframes,
    n0 1e-3) through ``pusch_decode`` on the int8 LLR lane."""
    import dataclasses

    import torch

    from empower_srslte_tpu_torch.models.pusch import pusch_decode
    from empower_srslte_tpu_torch.models.ue_ul import (enb_ul_receive_grid,
                                                       ul_stimulus)

    st = ul_stimulus(BATCH, UL_N0, device="cuda")
    cfg = dataclasses.replace(st.cfg, llr_int8=True)
    its: list = []

    def run():
        its.clear()
        return pusch_decode(enb_ul_receive_grid(st.samples, cfg.cell), cfg,
                            st.plan, noise_est=UL_N0, iters_out=its)

    (bits, ok, soft), launches, ms_first, ms, peak, shapes = counted_run(run)
    twin = hold_shapes("uplink_int8", turbo_shapes(shapes), seed=53)
    checks = {"crc_ok": bool(ok.all()),
              "bits_equal": bool(torch.equal(bits, st.tb)),
              "int8_softbuffers": all(s.dtype == torch.int8 for s in soft),
              "turbo_win_bf16_launched": launches["turbo_win_bf16"] > 0,
              "no_turbo_win_f32_launch": launches["turbo_win"] == 0,
              "no_nii_launch": launches["turbo_nii"]
              + launches["turbo_nii_bf16"] == 0,
              **turbo_checks(twin)}
    tbs = st.plan.tbs
    emit({"phase": "uplink_int8", "batch": BATCH, "nof_prb": 100,
          "n_prb": st.cfg.n_prb, "mcs": 20, "tbs": tbs, "n0": UL_N0,
          "ms_per_batch": ms, "ms_counted_run": ms_first,
          "mbps": BATCH * tbs / (ms * 1e-3) / 1e6,
          "turbo_iterations": list(its), "launches": launches,
          "turbo_dtype": "bfloat16", "turbo_shapes": twin,
          "softbuffer_bytes_per_tb": soft_bytes_per_tb(
              [s[0] for s in soft]),
          "peak_mem_gb": peak, "checks": checks})
    check("uplink_int8", checks)
    return launches, twin


def phase_uplink_msg3():
    """The JAX stack's Msg3 grant (``MSG3_GRANT``: 4 PRB, MCS 4, TBS 256,
    one code block of K 280, which has no turbo window) in 256 subframes
    through ``pusch_decode`` at n0 1e-3. The windowed plan decodes such a
    K on the NII kernel, as one window of l = K; the kernel is held to its
    twin at that shape."""
    import torch

    from empower_srslte_tpu_torch.models.pusch import pusch_decode
    from empower_srslte_tpu_torch.models.sch import _pick_window
    from empower_srslte_tpu_torch.models.ue_ul import (MSG3_GRANT,
                                                       enb_ul_receive_grid,
                                                       ul_stimulus)

    st = ul_stimulus(BATCH, UL_N0, grant=MSG3_GRANT, device="cuda")
    cb_sizes = st.plan.segm.cb_sizes
    its: list = []

    def run():
        its.clear()
        return pusch_decode(enb_ul_receive_grid(st.samples, st.cfg.cell),
                            st.cfg, st.plan, noise_est=UL_N0, iters_out=its)

    (bits, ok, _soft), launches, ms_first, ms, peak, shapes = \
        counted_run(run)
    twin = hold_shapes("uplink_msg3", turbo_shapes(shapes), seed=29)
    checks = {"crc_ok": bool(ok.all()),
              "bits_equal": bool(torch.equal(bits, st.tb)),
              "k_has_no_window": all(_pick_window(k) is None
                                     for k in cb_sizes),
              "windowed_plan": st.plan.decoder_impl == "windowed",
              # no window: "auto" stays float32, as JAX's full sweep
              "nii_f32_2_per_iteration":
                  launches["turbo_nii"] == 2 * sum(its),
              "no_bf16_launch": launches["turbo_nii_bf16"]
              + launches["turbo_win_bf16"] == 0,
              "no_turbo_win_launch": launches["turbo_win"] == 0,
              **turbo_checks(twin)}
    tbs = st.plan.tbs
    emit({"phase": "uplink_msg3", "batch": BATCH, "nof_prb": 100,
          "grant": list(MSG3_GRANT), "tbs": tbs, "cb_sizes": list(cb_sizes),
          "n0": UL_N0, "ms_per_batch": ms, "ms_counted_run": ms_first,
          "mbps": BATCH * tbs / (ms * 1e-3) / 1e6,
          "turbo_iterations": list(its), "launches": launches,
          "turbo_dtype": "float32",
          "turbo_dtype_why": "K 280 has no turbo window: 'auto' resolves "
                             "to float32 there, as JAX's full sweep",
          "turbo_shapes": twin, "peak_mem_gb": peak, "checks": checks})
    check("uplink_msg3", checks)
    return launches, twin


def phase_cold_boot():
    """A UE's cold start at 20 MHz (what the JAX stack's ``UeStack``
    does before camping): the 26-subframe capture of ``cold_boot_stimulus``
    through the cell-search vote, ``sync_and_align`` (cell ID, frame
    timing, CFO), ``sfo_estimate`` on the aligned stream,
    ``ue_mib_acquire`` on the first whole frame's subframe 0 and
    ``ue_dl_decode`` of its sf-3 data grant on the cell the MIB
    describes, every stage on the card and timed with CUDA events. Then
    the one-rx-antenna format-2 subframe (``one_rx_tm4_stimulus``), which
    must decode codeword 0 and fail codeword 1, as the JAX package does."""
    import torch

    from empower_srslte_tpu_torch.models import enb_dl
    from empower_srslte_tpu_torch.models.dci import DciDl
    from empower_srslte_tpu_torch.models.pbch import PBCH_K
    from empower_srslte_tpu_torch.models.ue_dl import (ue_dl_decode,
                                                       ue_mib_acquire)
    from empower_srslte_tpu_torch.models.ue_sync import (cell_search_vote,
                                                         sfo_estimate,
                                                         sync_and_align)
    from empower_srslte_tpu_torch.utils.cell import Cell

    t0 = time.perf_counter()
    cap = enb_dl.cold_boot_stimulus(device="cuda")
    torch.cuda.synchronize()
    tx_s = time.perf_counter() - t0
    cell, prb = cap.cell, cap.cell.nof_prb
    sf_len, data_sf = cell.sf_sample_len, enb_dl.COLD_DATA_SF
    r_cell, r_rnti, _bits, _cand, r_cfg, r_plan = enb_dl.one_rx_tm4_grant()

    # the Viterbi kernel against its twin at the PBCH's 4 frame phases at
    # K 40; the blind searches and the turbo kernels at the shapes the
    # decodes below launch
    vit_twin = vit_path_check("cold_boot", {(PBCH_K, 4)}, seed=36)
    stage_events: list = []

    def run():
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
        stage_events.append(ev)
        ev[0].record()
        vote = cell_search_vote(cap.samples, prb, max_frames=2)
        ev[1].record()
        res = sync_and_align(cap.samples, prb)
        ev[2].record()
        sfo = sfo_estimate(res.subframes.reshape(-1), res.n_id_2, prb)
        ev[3].record()
        mib = ue_mib_acquire(res.subframes[0], Cell(nof_prb=prb, id=0),
                             res.cell_id)
        ev[4].record()
        out = [] if mib is None else ue_dl_decode(
            res.subframes[data_sf], Cell(nof_prb=mib["nof_prb"],
                                         nof_ports=mib["nof_ports"],
                                         id=res.cell_id), data_sf, cap.rnti)
        ev[5].record()
        return vote, res, sfo, mib, out

    reps = 3
    ((n_id_2, votes, _psr), res, sfo, mib, out), launches, ms_first, ms, \
        peak, shapes = counted_run(run, reps=reps)
    names = ("vote", "sync", "sfo", "mib", "decode")
    stage_ms = {f"ms_{n}": sum(ev[i].elapsed_time(ev[i + 1])
                               for ev in stage_events[-reps:]) / reps
                for i, n in enumerate(names)}
    hits = [r for r in out if isinstance(r.dci, DciDl)]
    frame = 10 * sf_len
    want_mib = dict(nof_prb=prb, phich_dur=enb_dl.COLD_PHICH[0],
                    phich_res=enb_dl.COLD_PHICH[1],
                    sfn_msb=cap.first_sfn >> 2, sfn_mod4=cap.first_sfn % 4,
                    nof_ports=1, sfn=cap.first_sfn)

    rep_y = enb_dl.one_rx_tm4_stimulus(device="cuda")[2:]
    rep, rep_launches, rep_shapes = counted(
        lambda: ue_dl_decode(rep_y[0], r_cell, r_cfg.sf_idx, r_rnti))
    # the turbo kernels at every shape both decodes launched: the data
    # grant's TB and the format-2 subframe's two equal-plan codewords
    nii_twin = hold_shapes("cold_boot", turbo_shapes(merge_shapes(
        shapes, rep_shapes)), seed=37)
    blind_twin = hold_shapes("cold_boot", {"pdcch_blind": merge_shapes(
        shapes, rep_shapes).get("pdcch_blind", {})}, seed=36)["pdcch"]
    checks = {
        "vote_n_id_2": n_id_2 == cell.n_id_2 and votes[n_id_2] == 2,
        "cell_id": res.cell_id == enb_dl.COLD_CELL_ID,
        "sf0_offset": (res.sf0_offset - enb_dl.COLD_LEAD_IN) % frame
        == 6 * sf_len,
        "cfo_error_below_0.03": abs(res.cfo - enb_dl.COLD_CFO) < 0.03,
        "sfo_drift_below_0.5": bool(
            abs(sfo["drift_samples_per_frame"]) < 0.5),
        "mib": mib == want_mib,
        "data_crc_ok": len(hits) == 1 and hits[0].crc_ok,
        "data_bits_equal": len(hits) == 1 and bool(
            (torch.as_tensor(hits[0].tb_bits) == cap.tb.cpu()).all()),
        "viterbi_launched": launches["viterbi37"] > 0,
        "blind_kernel_launched": launches["pdcch_blind"] > 0
        and rep_launches["pdcch_blind"] > 0,
        "blind_twin_exact_every_shape": bool(blind_twin) and all(
            v["exact"] for v in blind_twin.values()),
        "turbo_bf16_launched": launches["turbo_nii_bf16"] > 0,
        "one_rx_tm4_turbo_bf16_launched": rep_launches["turbo_nii_bf16"] > 0,
        **turbo_checks(nii_twin),
        "one_rx_tm4_two_format2_results":
            [type(r.dci).__name__ for r in rep] == ["DciDl2"] * 2,
        "one_rx_tm4_cw0_ok_bits_equal": rep[0].cw == 0 and rep[0].crc_ok
        and bool((torch.as_tensor(rep[0].tb_bits)
                  == rep_y[1][0].cpu()).all()),
        "one_rx_tm4_cw1_fails": rep[-1].cw == 1 and not rep[-1].crc_ok,
    }
    emit({"phase": "cold_boot", "nof_prb": prb, "ports": 1,
          "cell_id": res.cell_id, "subframes": enb_dl.COLD_NOF_SF,
          "capture_bytes": cap.samples.numel() * cap.samples.element_size(),
          "cfo_sent": enb_dl.COLD_CFO, "cfo_est": res.cfo,
          "sf0_offset": res.sf0_offset, "sss_metric": res.metric,
          "votes": votes, "sfo_drift_samples_per_frame":
              float(sfo["drift_samples_per_frame"]), "mib": mib,
          "tbs": int(cap.tb.numel()), "tx_s": round(tx_s, 3), **stage_ms,
          "ms_acquire_total": ms, "ms_counted_run": ms_first,
          "launches": launches, "one_rx_tm4_launches": rep_launches,
          "turbo_shapes": nii_twin, "blind_twin": blind_twin,
          "viterbi_twin_mismatched_bits": vit_twin, "peak_mem_gb": peak,
          "one_rx_tm4": [{"cw": r.cw, "crc_ok": r.crc_ok} for r in rep],
          "checks": checks})
    check("cold_boot", checks)
    return launches, nii_twin


def phase_pbch_batch():
    """``pbch_decode`` over BATCH subframe-0 grids of a 2-port 20 MHz cell
    (``pbch_batch_stimulus``: SFNs 0..BATCH-1, so each frame phase 64
    times; SFBC combining with ``estimate_channel``'s per-port channel):
    one Viterbi launch of 4 x BATCH words at K 40 per call."""
    import torch

    from empower_srslte_tpu_torch.models import enb_dl
    from empower_srslte_tpu_torch.models.pbch import PBCH_K, pbch_decode
    from empower_srslte_tpu_torch.models.ue_dl import estimate_channel

    st = enb_dl.pbch_batch_stimulus(BATCH, device="cuda")
    h, _n0 = estimate_channel(st.y, st.cell, 0)
    ms_chest = cuda_ms(lambda: estimate_channel(st.y, st.cell, 0), reps=5)
    vit_twin = vit_path_check("pbch_batch", {(PBCH_K, 4 * BATCH)}, seed=39)
    (bits, q, ports, ok), launches, ms_first, ms, peak, _ = counted_run(
        lambda: pbch_decode(st.y, h, st.cell))
    checks = {"all_ok": bool(ok.all()),
              "mib_equal": bool(torch.equal(bits, st.mib)),
              "sfn_mod4": bool(torch.equal(q, st.sfn % 4)),
              "nof_ports_2": bool((ports == 2).all()),
              "one_viterbi_launch": launches["viterbi37"] == 1}
    emit({"phase": "pbch_batch", "batch": BATCH, "nof_prb": st.cell.nof_prb,
          "ports": st.cell.nof_ports, "snr_db": enb_dl.PBCH_SNR_DB,
          "viterbi_words": 4 * BATCH, "k": PBCH_K, "ms_per_batch": ms,
          "ms_counted_run": ms_first, "ms_chest": ms_chest,
          "launches": launches, "viterbi_twin_mismatched_bits": vit_twin,
          "peak_mem_gb": peak, "checks": checks})
    check("pbch_batch", checks)
    return launches


def phase_ul_control():
    """The eNB's control decode of a busy 20 MHz uplink TTI
    (``ul_control_stimulus``: 256 subframes of eight PUCCH users and an
    SRS user, summed with their own flat gains, AWGN 10 dB below a
    unit-power RE): the UL grid, every PUCCH decode and the SRS LS
    estimate. Every SR (present in half the subframes, decided by the
    stack's energy rule), ACK, CQI and RI must equal what was sent, and
    the band-averaged SRS estimate each subframe's SRS gain within 0.1."""
    import torch

    from empower_srslte_tpu_torch.models.ue_ul import (
        CTRL_CFO, CTRL_TA, CTRL_TA_UE, CTRL_UES, ul_control_receive,
        ul_control_stimulus)
    from empower_srslte_tpu_torch.models.uci import (cqi_unpack_wideband,
                                                     ri_unpack)

    t0 = time.perf_counter()
    st = ul_control_stimulus(BATCH, device="cuda")
    torch.cuda.synchronize()
    tx_s = time.perf_counter() - t0
    out, launches, ms_first, ms, peak, _ = counted_run(
        lambda: ul_control_receive(st.samples, st))
    errors = {k: int((out[k] != v).any(-1).sum()) for k, v in st.sent.items()}
    srs_err = (out["srs_h"].mean(-1) - st.srs_gain).abs()
    # the payload helpers on the decoded reports (host reads, as the stack)
    cqi_0 = cqi_unpack_wideband(out["cqi"][0])
    ri_0 = ri_unpack(out["ri"][0])
    checks = {f"{k}_equal": v == 0 for k, v in errors.items()}
    sr_absent = int((st.sent["sr"] == 0).sum())
    checks.update({
        "sr_absent_in_some_subframes": 0 < sr_absent < BATCH,
        "srs_gain_within_0.1": bool((srs_err < 0.1).all()),
        "cqi_unpacks": cqi_0 == cqi_unpack_wideband(st.sent["cqi"][0]),
        "ri_unpacks": ri_0 == ri_unpack(st.sent["ri"][0]),
        "no_kernel_launch": not any(launches.values())})
    emit({"phase": "ul_control", "batch": BATCH, "nof_prb": 100,
          "users": [list(u) for u in CTRL_UES], "srs": st.srs,
          "ta_cfo_user": CTRL_TA_UE, "timing_advance": CTRL_TA,
          "cfo": CTRL_CFO, "n0": st.n0, "tx_s": round(tx_s, 3),
          "ms_per_batch": ms, "ms_counted_run": ms_first,
          "subframes_with_errors": errors,
          "subframes_without_sr": sr_absent,
          "srs_gain_err_mean": float(srs_err.mean()),
          "srs_gain_err_max": float(srs_err.max()),
          "launches": launches, "peak_mem_gb": peak, "checks": checks})
    check("ul_control", checks)


def phase_prach():
    """PRACH detection as the eNB runs it on its PRACH occasion
    (``prach_stimulus``): 256 format-0 windows of a 20 MHz cell with the
    stack's rsi 128, zcz 11 and frequency offset 4, each holding 1-3
    preambles at random delays below N_cs; the same on the restricted
    (high-speed) set; one window of each of formats 1-4; and 256
    noise-only windows. Every sent preamble must be detected with its
    offset within one delay bin. On noise the threshold (13 x the
    profile mean) lets each of the 64 zones' N_cs bins through with
    probability exp(-13), about 3.4 detections per 256 windows at zcz 11:
    the false alarms must stay within 4 times that expectation."""
    import math

    import torch

    from empower_srslte_tpu_torch.models import prach as pr
    from empower_srslte_tpu_torch.utils.cell import Cell

    cell = Cell(nof_prb=100, id=1)
    variants = {
        "format0": dict(windows=BATCH),
        "restricted": dict(windows=BATCH, high_speed=True),
        **{f"format{f}": dict(windows=1, fmt=f) for f in (1, 2, 3)},
        "format4": dict(windows=1, fmt=4, zcz=6, rsi=2),
        "noise_only": dict(windows=BATCH, max_per_window=0)}
    line, checks = {}, {}
    for seed, (name, kw) in enumerate(variants.items()):
        kw = dict(kw)
        rsi = kw.get("rsi", pr.STACK_RSI)
        st = pr.prach_stimulus(kw.pop("windows"), cell=cell, seed=60 + seed,
                               device="cuda", **kw)

        def run():
            return pr.prach_detect(st.samples, cell, rsi, zcz=st.zcz,
                                   freq_offset_prb=pr.STACK_FREQ_OFFSET,
                                   fmt=st.fmt, high_speed=st.high_speed)

        (det, off, _m), launches, ms_first, ms, peak, _ = counted_run(run)
        sent = st.index >= 0
        rows = st.index.clamp_min(0)
        found = torch.gather(det, 1, rows) & sent
        offs = torch.gather(off, 1, rows)
        bin_len = pr.prach_seq_len(cell, st.fmt) / pr._nzc(st.fmt)
        off_err = ((offs - st.delay).abs().float() / bin_len)[sent]
        n_det, n_sent = int(det.sum()), int(sent.sum())
        rec = {"windows": int(st.samples.shape[0]), "fmt": st.fmt,
               "zcz": st.zcz, "ncs": pr.n_cs(st.zcz, st.fmt, st.high_speed),
               "roots": len({u for u, _ in pr.preamble_table(
                   rsi, st.zcz, st.fmt, st.high_speed)}),
               "seq_len": pr.prach_seq_len(cell, st.fmt),
               "preambles_sent": n_sent,
               "missed": int((sent & ~found).sum()),
               "max_offset_err_bins": float(off_err.max()) if n_sent else 0,
               "detections_not_sent": n_det - int(found.sum()),
               "ms_per_batch": ms, "ms_counted_run": ms_first,
               "launches": launches, "peak_mem_gb": peak}
        if n_sent:
            checks[f"{name}_all_detected"] = rec["missed"] == 0
            checks[f"{name}_offsets_within_1_bin"] = \
                rec["max_offset_err_bins"] <= 1.0
        else:
            expect = pr.prach_false_alarm_rate(
                st.zcz, st.fmt, st.high_speed) * rec["windows"]
            rec["false_alarms_expected"] = expect
            checks["noise_false_alarms_within_4x_expected"] = \
                n_det <= math.ceil(4 * expect)
        line[name] = rec
    emit({"phase": "prach", "nof_prb": 100, "rsi": pr.STACK_RSI,
          "freq_offset_prb": pr.STACK_FREQ_OFFSET,
          "snr_db_per_sample": pr.PRACH_SNR_DB, "variants": line,
          "checks": checks})
    check("prach", checks)


def phase_pmch():
    """The MBSFN broadcast (``pmch_stimulus``): 256 subframes at MCS 16
    on the 100-PRB cell's extended-CP twin, area 1, cfi 2, transmitted
    with ``ofdm_tx_sf_mbsfn`` through a flat gain and AWGN 25 dB below a
    unit-power RE, received by ``ofdm_rx_sf_mbsfn`` -> ``pmch_chest`` ->
    ``pmch_decode`` (NII kernel); then one MCCH subframe at MCS 2. The
    kernel is first held to its twin at this path's launch shape."""
    import torch

    from empower_srslte_tpu_torch.models import pmch

    t0 = time.perf_counter()
    st = pmch.pmch_stimulus(BATCH, device="cuda")
    torch.cuda.synchronize()
    tx_s = time.perf_counter() - t0
    its: list = []

    def run():
        its.clear()
        return pmch.pmch_receive(st.samples, st, iters_out=its)

    (bits, ok, _), launches, ms_first, ms, peak, shapes = counted_run(run)
    mcch = pmch.pmch_stimulus(1, mcs=pmch.MCCH_MCS, device="cuda")
    (m_bits, m_ok, _), _, m_shapes = counted(
        lambda: pmch.pmch_receive(mcch.samples, mcch))
    twin = hold_shapes("pmch_path", turbo_shapes(merge_shapes(
        shapes, m_shapes)), seed=40)
    checks = {"crc_ok": bool(ok.all()),
              "bits_equal": bool(torch.equal(bits, st.tb)),
              "turbo_bf16_launched": launches["turbo_nii_bf16"] > 0,
              **turbo_checks(twin),
              "mcch_crc_ok": bool(m_ok.all()),
              "mcch_bits_equal": bool(torch.equal(m_bits, mcch.tb))}
    tbs = st.plan.tbs
    emit({"phase": "pmch_path", "batch": BATCH, "nof_prb": 100,
          "mcs": pmch.MTCH_MCS, "tbs": tbs, "g": st.plan.g,
          "cb_sizes": list(st.plan.segm.cb_sizes), "cfi": pmch.MBMS_CFI,
          "area": pmch.MBMS_AREA, "snr_db": pmch.MBMS_SNR_DB,
          "tx_s": round(tx_s, 3), "ms_per_batch": ms,
          "ms_counted_run": ms_first,
          "mbps": BATCH * tbs / (ms * 1e-3) / 1e6,
          "turbo_iterations": list(its), "launches": launches,
          "turbo_shapes": twin, "mcch_tbs": mcch.plan.tbs,
          "sample_bytes": st.samples.numel() * st.samples.element_size(),
          "peak_mem_gb": peak, "checks": checks})
    check("pmch_path", checks)
    return launches, twin


def phase_turbo_xla():
    """``TurboDecoder(impl="xla")``, the plain PyTorch copies of the JAX
    package's XLA scans, on 64 CRC24B code blocks of K 1024 at Eb/N0 2 dB:
    the windowed sweep (the decoder's window) and the full sweep (no
    window), each once; bits must equal the sent ones. They run a few
    tensor operations per trellis step and launch no kernel of ours."""
    import numpy as np
    import torch

    from empower_srslte_tpu_torch.models.sch import _pick_window
    from empower_srslte_tpu_torch.ops.fec.turbo_decoder import TurboDecoder
    from empower_srslte_tpu_torch.ops.fec.turbo_encoder import turbo_encode
    from empower_srslte_tpu_torch.utils.crc import CRC24B

    dev = torch.device("cuda")
    k, nb, ebn0_db = 1024, 64, 2.0
    g = torch.Generator(device=dev).manual_seed(17)
    rng = np.random.default_rng(17)
    payload = torch.as_tensor(rng.integers(0, 2, (nb, k - 24)), device=dev)
    u = torch.cat([payload, CRC24B.compute(payload)], -1).to(torch.int8)
    d = turbo_encode(u).to(torch.float32)
    n0 = 3.0 / 10 ** (ebn0_db / 10)
    y = 1.0 - 2.0 * d + (n0 / 2) ** 0.5 * torch.randn(d.shape, generator=g,
                                                       device=dev)
    llr = 4.0 / n0 * y
    line, checks = {}, {}
    for name, window in (("windowed", _pick_window(k)), ("full", None)):
        dec = TurboDecoder(k=k, iterations=6, window=window, impl="xla")
        its: list = []
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        bits, _ = dec.decode(llr, crc=CRC24B, iters_out=its)
        e1.record()
        torch.cuda.synchronize()
        line[name] = {"window": window, "iterations": its,
                      "ms": e0.elapsed_time(e1),
                      "bit_errors": int((bits != u).sum())}
        checks[f"{name}_bits_equal"] = bool(torch.equal(bits, u))
    emit({"phase": "turbo_xla", "k": k, "cbs": nb, "ebn0_db": ebn0_db,
          **line, "checks": checks})
    check("turbo_xla", checks)


def vit_shape_time(k: int, halo: int, words: int, seed: int) -> dict:
    """The Viterbi kernel at one launch shape (CUDA events over 10
    launches, as the stack calls it), its plain twin (one call), its bound
    and its mismatched bits against the twin. Launches made here are not
    counted: no phase's count is open."""
    import torch

    from empower_srslte_tpu_torch.ops.fec.convcoder import (
        viterbi_decode_plain)
    from empower_srslte_tpu_torch.ops.fec.viterbi37 import viterbi_regs_cuda

    g = torch.Generator(device="cuda").manual_seed(seed)
    llr = vit_inputs(g, k, words)
    train = None if halo == k else halo
    steps = 2 * halo + k
    return {"k": k, "halo": halo, "words": words,
            "mismatched_bits": vit_twin_mismatch(llr, train),
            "ms": cuda_ms(lambda: viterbi_regs_cuda(llr, halo), reps=10),
            "plain_ms": cuda_ms(lambda: viterbi_decode_plain(llr, train),
                                reps=1),
            **bound(4 * words * (3 * k + (k - 1) // 32 + 1),
                    words * (steps * VIT_OPS_STEP
                             + (k + halo) * VIT_OPS_TRACE))}


def open_counts() -> None:
    """After a synchronize, the device's peak memory reset and the launch
    registry cleared (``trace.reset()``)."""
    import torch

    from empower_srslte_tpu_torch.runtime import trace

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trace.reset()


def read_counts() -> tuple:
    """(launches by kernel, launches by shape per kernel) since
    ``open_counts``, from the launch registry: a kernel not launched reads
    0 and has no shapes, and each turbo kernel's float32 and bfloat16
    launches share its float32 name's shapes (a turbo shape is (K, window,
    code blocks, dtype), the NII kernel's followed by the (first, last) of
    its resolved ``bounds``)."""
    import collections

    from empower_srslte_tpu_torch.runtime import trace

    launches = collections.Counter(trace.launch_counts())
    shapes: dict = collections.defaultdict(dict)
    for kernel in launches:
        shapes[kernel.removesuffix("_bf16")].update(
            trace.launch_shapes(kernel))
    return launches, shapes


def launches_since(before: dict, kernels) -> dict:
    """Each of ``kernels``' launches since the launch registry read
    ``before`` (``trace.launch_counts()``)."""
    from empower_srslte_tpu_torch.runtime import trace

    after = trace.launch_counts()
    return {k: after.get(k, 0) - before.get(k, 0) for k in kernels}


def launches_per_call(run, kernels) -> dict:
    """``run()`` once to warm up, then once more: -> each of ``kernels``'
    launches in the second call."""
    import torch

    from empower_srslte_tpu_torch.runtime import trace

    run()
    torch.cuda.synchronize()
    before = trace.launch_counts()
    run()
    torch.cuda.synchronize()
    return launches_since(before, kernels)


def hold_shapes(phase: str, shapes: dict, seed: int, cell=None,
                cfi: int = 1, sf_idx: int = 1) -> dict:
    """Each kernel held to its twin, and timed, at every shape a phase
    launched it (``read_counts``), the turbo kernels in the dtype of the
    launch and the NII kernel at every ``bounds`` it was launched with
    (the name of a shape launched off the default bounds (0, W-1) ends in
    ``_bounds{first}_{last}``): -> {"turbo_nii": {...}, "turbo_win":
    {...}, "viterbi37": {...}, "pdcch": {...}, "sch_derm": {...},
    "ctrl_llr": {...}, "chest_dl": {...}, "pdcch_tx": {...}} per shape,
    with its launches;
    the blind-search kernel (``pdcch``, a shape being its DCI sizes,
    candidates and subframes) on noisy LLRs (``blind_hold``); the
    de-rate-matching kernel on random LLRs (``derm_hold``); given the
    phase's ``cell`` (and its CFI and subframe), the control LLR kernel
    (``ctrl_hold``) and the CRS estimate kernel (``chest_shape``) on
    random grids and channels of that cell, and the PDCCH transmit kernel
    (``tx_hold``, a shape being its DCIs, ports and largest K) on random
    DCIs of that cell. The phase's checks require
    every error to be 0, the de-rate-matching kernel's to be 0 or within
    its stated tolerance, and the control and estimate kernels' within
    theirs (``turbo_checks``, ``shape_checks``)."""
    import torch

    from empower_srslte_tpu_torch.ops.fec.turbo_win import DEFAULT_OVERLAP

    g = torch.Generator(device="cuda").manual_seed(seed)
    out = {"turbo_nii": {}, "turbo_win": {}, "viterbi37": {}, "pdcch": {},
           "sch_derm": {}, "ctrl_llr": {}, "chest_dl": {}, "pdcch_tx": {}}
    i = 0
    for (n, ports, n_re), c in sorted(shapes.get("ctrl_llr", {}).items()):
        if cell is None:
            break
        name = f"sf{n}_p{ports}_re{n_re}"
        out["ctrl_llr"][name] = {**ctrl_hold(cell, cfi, sf_idx, n, ports,
                                             seed + i), "launches": c}
        PATH_TWIN["pdcch_rx"][f"{phase}_ctrl_{name}"] = \
            out["ctrl_llr"][name]["held"]
        i += 1
    for (n, ports, prb), c in sorted(shapes.get("chest_dl", {}).items()):
        if cell is None:
            break
        name = f"grids{n}_p{ports}_prb{prb}"
        v = chest_shape(g, cell, sf_idx, tuple(range(ports)), (n,))
        v["held"] = (v["h_err_cpu_twin"] <= CHEST_TOL
                     and v["h_err"] <= CHEST_TOL_CARD
                     and max(v["noise_rel_err_cpu_twin"], v["noise_rel_err"],
                             v["noise_only_rel_err"]) <= CHEST_TOL)
        out["chest_dl"][name] = {**v, "launches": c}
        PATH_TWIN["chest_dl"][f"{phase}_{name}"] = v["held"]
    for shape, c in sorted(shapes.get("sch_derm", {}).items(), key=str):
        name = derm_name(shape)
        out["sch_derm"][name] = {**derm_hold(shape, seed + i),
                                 "launches": c}
        PATH_TWIN["sch_derm"][f"{phase}_{name}"] = \
            out["sch_derm"][name]["held"]
        i += 1
    for (k, l, b, dt, first, last), c in sorted(
            shapes.get("turbo_nii", {}).items()):
        bd = None if (first, last) == (0, k // l - 1) else (first, last)
        name = f"k{k}_l{l}_cbs{b}_{dt}" + (
            f"_bounds{first}_{last}" if bd else "")
        out["turbo_nii"][name] = {
            **nii_shape_time(k, l, b, seed + i, dt, bd), "launches": c,
            "bounds": [first, last],
            "max_abs_err": nii_twin(*nii_inputs(g, k, l, b, bounds=bd,
                                                dtype=dt))[0]}
        key = "turbo_nii_bf16" if dt == "bfloat16" else "turbo_nii"
        PATH_TWIN[key][f"{phase}_{name}"] = \
            out["turbo_nii"][name]["max_abs_err"]
        i += 1
    for (k, l, b, dt), c in sorted(shapes.get("turbo_win", {}).items()):
        name = f"k{k}_l{l}_cbs{b}_{dt}"
        out["turbo_win"][name] = {
            **win_shape_time(k, l, b, seed + i, dt), "launches": c,
            "max_abs_err": win_twin(*win_inputs(g, k, b, dt),
                                    dict(k=k, l=l, o=DEFAULT_OVERLAP))[0]}
        key = "turbo_win_bf16" if dt == "bfloat16" else "turbo_win"
        PATH_TWIN[key][f"{phase}_{name}"] = \
            out["turbo_win"][name]["max_abs_err"]
        i += 1
    for (k, h, w), c in sorted(shapes.get("viterbi37", {}).items()):
        name = f"k{k}_halo{h}_words{w}"
        out["viterbi37"][name] = {**vit_shape_time(k, h, w, seed + i),
                                  "launches": c}
        PATH_TWIN["viterbi37"][f"{phase}_{name}"] = \
            out["viterbi37"][name]["mismatched_bits"]
        i += 1
    for (n, ports, k), c in sorted(shapes.get("pdcch_tx", {}).items()):
        if cell is None:
            break
        name = f"dcis{n}_p{ports}_k{k}"
        out["pdcch_tx"][name] = {
            **tx_hold(cell, cfi, sf_idx, n, k, seed + i), "launches": c}
        PATH_TWIN["pdcch_tx"][f"{phase}_{name}"] = \
            out["pdcch_tx"][name]["mismatched"]
        i += 1
    for (sizes, cands, n), c in sorted(
            shapes.get("pdcch_blind", {}).items()):
        name = f"sizes{'_'.join(map(str, sizes))}_cands{len(cands)}_sf{n}"
        out["pdcch"][name] = {**blind_hold(sizes, cands, n, seed + i),
                              "launches": c}
        PATH_TWIN["pdcch_rx"][f"{phase}_{name}"] = \
            out["pdcch"][name]["exact"]
        i += 1
    return out


def blind_hold(sizes, cands, n: int, seed: int) -> dict:
    """The blind-search kernel at one launch shape on noisy LLRs (each
    subframe's at a random scale, so that most candidates are noise),
    held to its twins (``blind_twin_check``) and timed (CUDA events over
    10 launches, as a path calls it)."""
    import torch

    from empower_srslte_tpu_torch.models import pdcch

    g = torch.Generator(device="cuda").manual_seed(seed)
    n_llr = 72 * max(cce + l for l, cce in cands)
    llr = (torch.randn((n, n_llr), generator=g, device="cuda")
           * 4 * torch.rand((n, 1), generator=g, device="cuda"))
    return {"sizes": list(sizes), "candidates": len(cands), "subframes": n,
            **blind_twin_check(llr, cands, sizes, 0x1234),
            "ms": cuda_ms(lambda: pdcch.pdcch_blind_cuda(
                llr, cands, sizes, 0x1234),
                reps=10)}


def ctrl_hold(cell, cfi: int, sf_idx: int, n: int, ports: int,
              seed: int) -> dict:
    """The control LLR kernel at one launch shape, ``n`` subframes of
    ``cell``'s region with a ``ports``-port channel, on random grids and
    channels: its CFI and LLRs against the plain twin run on the CPU
    (``PDCCH_LLR_TOL``), timed by CUDA-graph replay."""
    import torch

    from empower_srslte_tpu_torch.models import pcfich, pdcch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def cplx(*shape):
        return torch.complex(torch.randn(shape, generator=g, device="cuda"),
                             torch.randn(shape, generator=g, device="cuda"))

    grid = cplx(n, cell.nsymb_sf, cell.nof_re)
    h = cplx(n, ports, cell.nsymb_sf, cell.nof_re)
    noise = 0.01 + torch.rand(n, generator=g, device="cuda")
    cfi_hat, _corr, llr = pdcch.ctrl_llr_cuda(grid, h, cell, sf_idx, noise,
                                              region=(cfi, 1.0))
    gc, hc, nc = grid.cpu(), h.cpu(), noise.cpu()[:, None]
    t_cfi, _ = pcfich._pcfich_decode_plain(gc, hc, cell, sf_idx, nc)
    t_llr = pdcch._pdcch_extract_llr_plain(gc, hc, cell, cfi, sf_idx, nc)
    err = float((llr.cpu() - t_llr).abs().max() / t_llr.abs().max())
    same = bool(torch.equal(cfi_hat.cpu(), t_cfi))
    return {"subframes": n, "ports": ports, "n_re": llr.shape[-1] // 2,
            "cfi_equal_twin": same, "llr_err": err,
            "held": same and err <= PDCCH_LLR_TOL,
            "ms": graph_ms(lambda: pdcch.ctrl_llr_cuda(
                grid, h, cell, sf_idx, noise, region=(cfi, 1.0)), reps=20)}


def bounds_kind(bounds, windows: int) -> str:
    """The NII launch's trellis slice: "whole" (0, W-1), a trellis-sharded
    decode's "first" (0, -1), "interior" (-1, -1) or "last" (-1, W-1)
    shard."""
    first, last = bounds
    if first == 0:
        return "whole" if last == windows - 1 else "first"
    return "interior" if last == -1 else "last"


def turbo_checks(shapes: dict) -> dict:
    """Each turbo kernel held to its twin exactly, and the de-rate-matching
    kernel exactly or within its tolerance (``derm_hold``), at every
    shape a path launched it (``hold_shapes``)."""
    return {"turbo_twin_exact_every_shape": all(
        v["max_abs_err"] == 0.0 for name in ("turbo_nii", "turbo_win")
        for v in shapes.get(name, {}).values()),
        "sch_derm_twin_every_shape": all(
            v["held"] for v in shapes.get("sch_derm", {}).values()),
        "ctrl_llr_and_chest_twin_every_shape": all(
            v["held"] for name in ("ctrl_llr", "chest_dl")
            for v in shapes.get(name, {}).values())}


def ms_stats(v) -> dict:
    import numpy as np

    return {"median": float(np.median(v)),
            "p95": float(np.percentile(v, 95)), "max": float(max(v))}


#: every (kernel, shape name) the stack phases of this run launched so far
#: (``StackPhase.close``'s ``new_shapes`` are those not in it)
STACK_SHAPES: set = set()
#: the two-UE phase's cell width: 20 MHz, the widest LTE carrier
MULTI_UE_PRB = 100


class StackPhase:
    """One stack phase on the card: its scenarios' ``StackDrive``\\ s
    (made with ``drive``, through a ``ScenarioRun`` on "cuda" of
    ``tools/stack_scenarios.py``; every ``enb.tti`` / ``ue.tti`` timed on
    the host clock up to a synchronize: the air is host memory, so each
    TTI ends in host reads anyway), with every kernel's launch counts (and
    per-shape counts) at 0 and the device's peak memory reset when the
    phase opens, read when it closes: over all of its scenarios."""

    def __init__(self, phase: str, seed: int):
        import torch

        from empower_srslte_tpu_torch.tools.stack_scenarios import \
            ScenarioRun

        self.phase, self.seed = phase, seed
        self.run = ScenarioRun("cuda", sync=torch.cuda.synchronize)
        self.scenarios: dict = {}
        self.checks: dict = {}
        open_counts()

    def drive(self, enbs, ues, **kw):
        return self.run.drive(enbs, ues, **kw)

    def scenario(self, fn, **kw) -> None:
        """Run the scenario ``fn(self.run, **kw)`` (its checks: the JAX
        test's asserts, and what else its line reports); its checks join
        the phase's as ``{name}.{check}``."""
        first = len(self.run.drives)
        checks, info = fn(self.run, **kw)
        self.scenarios[fn.__name__] = {
            **drive_stats(self.run.drives[first:]), **info}
        self.checks.update({f"{fn.__name__}.{k}": bool(v)
                            for k, v in checks.items()})

    def close(self) -> dict:
        """The phase line's fields over the whole phase: TTIs, ms per
        ``enb.tti`` / ``ue.tti``, launches, peak memory, each kernel held
        to its twin and timed at every shape the phase launched
        (``hold_shapes``), and the shapes no earlier stack phase of this
        run launched."""
        import torch

        launches, shapes = read_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        held = hold_shapes(self.phase, shapes, self.seed)
        names = {(k, n) for k, by in held.items() for n in by}
        new = sorted(f"{k}:{n}" for k, n in names - STACK_SHAPES)
        STACK_SHAPES.update(names)
        stats = drive_stats(self.run.drives)
        stats.pop("event_tti", None)
        return dict(**stats, launches=launches, peak_mem_gb=peak,
                    shapes=held, new_shapes=new)


def drive_stats(drives) -> dict:
    """TTIs run, ms per ``enb.tti`` and per ``ue.tti`` (median, p95, max;
    None where none ran) and the TTI of each watched event, over
    ``drives``."""
    enb = [t for d in drives for ms in d.ms_enb for t in ms]
    ue = [t for d in drives for ms in d.ms_ue for t in ms]
    out = dict(ttis=sum(d.tti for d in drives),
               ms_enb_tti=ms_stats(enb) if enb else None,
               ms_ue_tti=ms_stats(ue) if ue else None)
    events = {k: v for d in drives for k, v in d.event_tti.items()}
    return {**out, "event_tti": events} if events else out


def shape_checks(shapes: dict, launches: dict) -> dict:
    """The on-path kernels launched at a non-empty set of shapes
    (``hold_shapes``; the NII kernel in either dtype; a Viterbi decode on
    the Viterbi kernel or the blind-search kernel), each held to its
    twin exactly (0.0 error, 0 bits); the de-rate-matching kernel exactly
    or within its tolerance."""
    nii, vit = shapes["turbo_nii"], shapes["viterbi37"]
    blind = shapes.get("pdcch", {})
    return {"turbo_launched_shapes": bool(nii)
            and launches["turbo_nii"] + launches["turbo_nii_bf16"] > 0,
            "viterbi_launched_shapes": bool(vit or blind)
            and launches["viterbi37"] + launches["pdcch_blind"] > 0,
            "nii_twin_exact_every_shape": all(v["max_abs_err"] == 0.0
                                              for v in nii.values()),
            "viterbi_twin_exact_every_shape": all(
                v["mismatched_bits"] == 0 for v in vit.values())
            and all(v["exact"] for v in blind.values()),
            "sch_derm_twin_every_shape": all(
                v["held"] for v in shapes.get("sch_derm", {}).values())}


STACK_PING = b"\x45\x00" + bytes(18) + b"PING-FROM-UE-01"


def phase_stack_attach():
    """The entry point's path (``apps/lte_attach.py``) at the JAX stack
    tests' size, Cell(25 PRB, id 1): S1AP over a local socket, air at 15 dB
    with h_dl 0.9 e^{j0.5} and h_ul 0.85 e^{-j0.3} (``tests/
    test_stack.py:56-70``), up to 100 TTIs to attach; then one ping up and
    one pong down the user plane (``:72-105``)."""
    import numpy as np

    from empower_srslte_tpu_torch.apps import lte_attach
    from empower_srslte_tpu_torch.s1ap.procedures import EnbS1ap, MmeS1ap
    from empower_srslte_tpu_torch.s1ap.transport import S1Client, S1Server
    from empower_srslte_tpu_torch.stack import Air, EnbStack, UeStack
    from empower_srslte_tpu_torch.tools.stack_scenarios import pong
    from empower_srslte_tpu_torch.utils.cell import Cell

    ph = StackPhase("stack_attach", seed=80)
    mme, nas = lte_attach.epc()
    mme_s1 = MmeS1ap(mme=mme)
    server = S1Server(mme_s1.handle)
    client = S1Client("127.0.0.1", server.port)
    try:
        cell = Cell(nof_prb=25, id=1)
        enb = EnbStack(cell, EnbS1ap(send=client), device="cuda")
        ue = UeStack(cell, nas, device="cuda")
        air = Air(cell.sf_sample_len, snr_db=15.0,
                  h_dl=0.9 * np.exp(1j * 0.5), h_ul=0.85 * np.exp(-1j * 0.3))
        attached = []

        def step(tti):
            if not attached and ue.rrc.nas.attached and ue.rrc.drbs:
                attached.append(tti)
                ue.send_ip(STACK_PING)
                fwd = mme.spgw.downlink(pong(ue.rrc.nas.ue_ip,
                                             b"PONG-TO-THE-UE!"))
                enb.deliver_gtpu(fwd[1])
            return bool(enb.ul_gtpu and ue.rx_ip)

        ph.drive([enb], [ue], air=air).run(100, step)
    finally:
        server.close()
        client.close()
    line = ph.close()
    sgi = mme.spgw.uplink(enb.ul_gtpu[0]) if enb.ul_gtpu else b""
    checks = {"attached": ue.rrc.nas.attached,
              "drbs": ue.rrc.drbs == [1],
              "security_activated": bool(ue.rrc.security_activated),
              "initial_ctx_setup_complete":
                  "initial_ctx_setup_complete" in mme_s1.events,
              "ping_at_sgi": bool(sgi.endswith(b"PING-FROM-UE-01")),
              "pong_at_ue": bool(ue.rx_ip)
              and ue.rx_ip[0].endswith(b"PONG-TO-THE-UE!"),
              **shape_checks(line["shapes"], line["launches"])}
    emit({"phase": "stack_attach", "nof_prb": 25, "snr_db": 15.0,
          "s1ap": "socket", "ttis_to_attach": attached[0] + 1
          if attached else None, **line, "checks": checks})
    check("stack_attach", checks)
    return line


def phase_stack_tm4():
    """``tests/test_mimo_stack.py::test_tm4_two_codewords``: a 2-port
    Cell(25 PRB, id 1), per-port DL gains (1, 0.45-0.62j) summed at a
    one-antenna UE; 12 TTIs after attach two tagged 155-byte packets go
    down, and must ride one format-2 grant (two codewords)."""
    from empower_srslte_tpu_torch.apps import lte_attach
    from empower_srslte_tpu_torch.stack import Air, EnbStack, UeStack
    from empower_srslte_tpu_torch.tools.stack_scenarios import pong
    from empower_srslte_tpu_torch.utils.cell import Cell

    ph = StackPhase("stack_tm4", seed=90)
    mme, nas = lte_attach.epc()
    cell = Cell(nof_prb=25, id=1, nof_ports=2)
    enb = EnbStack(cell, mme, device="cuda")
    ue = UeStack(cell, nas, device="cuda")
    air = Air(cell.sf_sample_len, h_dl=(1.0, 0.45 - 0.62j))
    attached, pushed = [], []
    tags = (b"TB0-OVER-LAYER0", b"TB1-OVER-LAYER1")

    def step(tti):
        if not attached and ue.rrc.nas.attached and ue.rrc.drbs:
            attached.append(tti)
        if attached and not pushed and tti == attached[0] + 12:
            pushed.append(tti)
            for tag, fill in zip(tags, (b"0", b"1")):
                fwd = mme.spgw.downlink(pong(ue.rrc.nas.ue_ip,
                                             tag + fill * 140))
                enb.deliver_gtpu(fwd[1])
        return bool(pushed) and len(ue.rx_ip) >= 2

    ph.drive([enb], [ue], air=air).run(140, step)
    line = ph.close()
    checks = {"attached": bool(attached),
              "tm4_tx": any(e.startswith("tm4_tx") for e in enb.events),
              "both_tagged_packets": {p[20:35] for p in ue.rx_ip}
              == set(tags), **shape_checks(line["shapes"], line["launches"])}
    emit({"phase": "stack_tm4", "nof_prb": 25, "ports": 2,
          "ttis_to_attach": attached[0] + 1 if attached else None,
          "tm4_tx": [e for e in enb.events if e.startswith("tm4_tx")],
          **line, "checks": checks})
    check("stack_tm4", checks)
    return line


def phase_stack_cold_boot():
    """``tests/test_cold_boot.py::test_search_mib_sib_attach``: the eNB
    (Cell(25 PRB, id 77), PRACH root 384) broadcasts MIB, SIB1 and SIB2;
    the UE knows only the RF geometry (PCI 0, root 0) and searches,
    reads the MIB on the PBCH (Viterbi kernel at K 40) and the SIBs,
    camps and attaches, within 260 TTIs."""
    from empower_srslte_tpu_torch.apps import lte_attach
    from empower_srslte_tpu_torch.stack import Air, EnbStack, UeStack
    from empower_srslte_tpu_torch.tools.stack_scenarios import has
    from empower_srslte_tpu_torch.utils.cell import Cell

    ph = StackPhase("stack_cold_boot", seed=100)
    mme, nas = lte_attach.epc()
    cell = Cell(nof_prb=25, id=77)
    enb = EnbStack(cell, mme, rsi=384, broadcast=True, device="cuda")
    ue = UeStack(Cell(nof_prb=25, id=0), nas, rsi=0, cold_start=True,
                 device="cuda")
    ph.drive([enb], [ue], air=Air(cell.sf_sample_len)).run(
        260, lambda tti: ue.rrc.nas.attached and bool(ue.rrc.drbs))
    line = ph.close()
    log = ue.events
    checks = {"cell_found_id77": has(log, "cell_found_id77"),
              "mib_prb25": has(log, "mib_prb25"),
              "sib1_acquired": "sib1_acquired" in log,
              "sib2_acquired_rsi384": has(log, "sib2_acquired_rsi384"),
              "camped": "camped" in log,
              "cell_acquired": ue.cell.id == 77 and ue.cell.nof_prb == 25,
              "rsi_acquired": ue.rsi == 384,
              "attached": ue.rrc.nas.attached and bool(ue.rrc.drbs),
              "pbch_k40_launched": any(
                  v["k"] == 40 for v in line["shapes"]["viterbi37"].values()),
              **shape_checks(line["shapes"], line["launches"])}
    acq = [e for e in log if e.startswith(("cell_found", "mib_", "sib",
                                           "camped"))]
    emit({"phase": "stack_cold_boot", "nof_prb": 25, "cell_id": 77,
          "ttis_to_attach": line["ttis"] if checks["attached"] else None,
          "acquisition_events": acq, **line, "checks": checks})
    check("stack_cold_boot", checks)
    return line


#: the phases of the JAX stack tests' remaining over-the-air scenarios
#: (``tools/stack_scenarios.py``'s ``PHASES``; each also runs alone with
#: ``--phases``): the seed of the twins' inputs, the scenarios' arguments
#: and the line's own fields. The two-UE phase runs at the full 20 MHz
#: width, every other at the stack tests' 25 PRB.
STACK_SCENARIO_PHASES = {
    "stack_multi_ue": (110, {"nof_prb": MULTI_UE_PRB},
                       {"nof_prb": MULTI_UE_PRB, "ues": 2}),
    "stack_mac_harq": (120, {}, {"nof_prb": 25}),
    "stack_idle": (130, {}, {"nof_prb": 25}),
    "stack_mobility": (140, {}, {"nof_prb": 25}),
    "stack_csi": (150, {}, {"nof_prb": 25}),
}


def phase_stack_scenarios(phase: str) -> dict:
    """One phase of ``STACK_SCENARIO_PHASES``: its scenarios on the card
    at their JAX tests' horizons, their checks and ``shape_checks``;
    the line emitted and checked. -> the line's fields of
    ``StackPhase.close``."""
    from empower_srslte_tpu_torch.tools.stack_scenarios import PHASES

    seed, kw, fields = STACK_SCENARIO_PHASES[phase]
    ph = StackPhase(phase, seed)
    for fn in PHASES[phase]:
        ph.scenario(fn, **kw)
    line = ph.close()
    checks = {**ph.checks, **shape_checks(line["shapes"], line["launches"])}
    emit({"phase": phase, **fields, **line, "scenarios": ph.scenarios,
          "checks": checks})
    check(phase, checks)
    return line


#: the example programs' captures (``chiprun_out/`` is not committed);
#: the 20 MHz ones are deleted when the app phases end
APP_DIR = OUT_DIR / "apps"
#: the README's example chain at 20 MHz: the generator's and receiver's
#: flags (``pdsch_enodeb -p 100 -c 1 -m 16 -f 10``, ``pdsch_ue -r 0x1234
#: -n 100``)
APP_PRB, APP_CELL, APP_MCS, APP_FRAMES, APP_RNTI = 100, 1, 16, 10, 0x1234


def app_rx_checks(run, tbs: int) -> dict:
    """``pdsch_ue``'s results on a capture of the generator: the cell,
    one DCI and a passing CRC in every aligned subframe, and every TB
    equal to the transmitter's draw for that subframe."""
    import itertools

    import numpy as np

    from empower_srslte_tpu_torch.apps import pdsch_enodeb

    sent = itertools.islice(pdsch_enodeb.tb_draws(tbs), len(run.subframes))
    return {"cell_id": run.cell_id == APP_CELL,
            "subframes_decoded": len(run.subframes) > 0,
            "dci_every_subframe": all(len(sf.dci) == 1
                                      for sf in run.subframes),
            "crc_every_subframe": all(sf.crc_ok == [True]
                                      for sf in run.subframes),
            "tb_bits_equal_sent": all(
                len(sf.tb_bits) == 1 and np.array_equal(sf.tb_bits[0], tb[0])
                for sf, tb in zip(run.subframes, sent))}


def app_rx_line(run) -> dict:
    return {"cell_id": run.cell_id, "sf0_offset": run.sf0_offset,
            "cfo": run.cfo, "subframes": len(run.subframes),
            "blocks": run.blocks, "errors": run.errors,
            "ms_ue_dl_decode": ms_stats([sf.ms for sf in run.subframes]),
            "proc_mbps": run.reports[-1]["proc_mbps"] if run.reports
            else None,
            "net_mbps": run.reports[-1]["net_mbps"] if run.reports
            else None}


def phase_app_pdsch():
    """The README's example chain at 20 MHz, through the apps' own entry
    points: ``pdsch_enodeb`` writes 10 frames of Cell(100 PRB, id 1) with
    a 98-PRB MCS 16 grant in every subframe; ``pdsch_ue``'s ``receive``
    syncs to the capture and runs one ``ue_dl_decode`` per aligned
    subframe on the card (the counted run), then its ``main`` runs the
    same decode and prints the metrics table."""
    import numpy as np
    import torch

    from empower_srslte_tpu_torch.apps import pdsch_enodeb, pdsch_ue

    APP_DIR.mkdir(parents=True, exist_ok=True)
    cap = APP_DIR / "enb_20mhz.bin"
    _, tbs, _ = pdsch_enodeb.grant(APP_PRB, APP_MCS)
    open_counts()
    t0 = time.perf_counter()
    rc_enb = pdsch_enodeb.main(["-o", str(cap), "-p", str(APP_PRB), "-c",
                                str(APP_CELL), "-m", str(APP_MCS), "-f",
                                str(APP_FRAMES)])
    torch.cuda.synchronize()
    ms_gen = (time.perf_counter() - t0) * 1e3 / (10 * APP_FRAMES)
    samples = np.fromfile(cap, np.complex64)
    run = pdsch_ue.receive(samples, APP_PRB, APP_RNTI, 10 * APP_FRAMES)
    launches, shapes_run = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    rc_ue = pdsch_ue.main(["-i", str(cap), "-p", str(APP_PRB), "-r",
                           hex(APP_RNTI), "-n", str(10 * APP_FRAMES)])
    shapes = hold_shapes("app_pdsch", shapes_run, seed=110)
    sf_len = 30720
    checks = {"enodeb_rc0": rc_enb == 0, "pdsch_ue_rc0": rc_ue == 0,
              "capture_size": samples.size == 10 * APP_FRAMES * sf_len,
              **app_rx_checks(run, tbs),
              # sync starts the first subframe inside the first symbol's
              # cyclic prefix: every whole subframe after it is decoded
              "sf0_inside_cp": 0 <= run.sf0_offset < 160,
              "all_whole_subframes": len(run.subframes)
              == (samples.size - run.sf0_offset) // sf_len,
              **shape_checks(shapes, launches)}
    line = {"phase": "app_pdsch", "nof_prb": APP_PRB, "mcs": APP_MCS,
            "tbs": tbs, "capture_bytes": int(samples.nbytes),
            "ms_enodeb_per_subframe": ms_gen, **app_rx_line(run),
            "launches": launches, "peak_mem_gb": peak, "shapes": shapes,
            "checks": checks}
    emit(line)
    check("app_pdsch", checks)
    return line, run


def phase_app_stream(ref_run):
    """The RF HAL and the native ring: ``iq_capture -d stream`` reads the
    20 MHz capture through ``StreamRfDevice`` over the port's
    ``SampleStream`` (``csrc/ring_buffer.cpp``, built by ``g++``) and its
    file producer into a second capture, which must be the first byte
    for byte; ``cell_measurement`` measures it on the card, and
    ``pdsch_ue`` decodes it as in ``app_pdsch``."""
    import dataclasses
    import math
    import pathlib

    import numpy as np
    import torch

    from empower_srslte_tpu_torch.apps import (cell_measurement, iq_capture,
                                               pdsch_enodeb, pdsch_ue)
    from empower_srslte_tpu_torch.models.ue_sync import sync_and_align
    from empower_srslte_tpu_torch.runtime import stream
    from empower_srslte_tpu_torch.utils import cuda_build

    cap, cap2 = APP_DIR / "enb_20mhz.bin", APP_DIR / "capture_20mhz.bin"
    n_sf = 10 * APP_FRAMES
    open_counts()
    t0 = time.perf_counter()
    got = iq_capture.capture(str(cap2), n_sf, APP_PRB, device_name="stream",
                             device_args=f"rx={cap}")
    ms_capture = (time.perf_counter() - t0) * 1e3
    same = cap2.read_bytes() == cap.read_bytes()
    rc_capt = iq_capture.main(["-d", "stream", "-a", f"rx={cap}", "-p",
                               str(APP_PRB), "-n", str(n_sf), "-o",
                               str(cap2)])
    same_main = cap2.read_bytes() == cap.read_bytes()
    samples = np.fromfile(cap2, np.complex64)

    t0 = time.perf_counter()
    res = sync_and_align(samples, APP_PRB)
    meas = cell_measurement.measure(res.subframes, APP_PRB, res.cell_id)
    torch.cuda.synchronize()
    ms_measure = (time.perf_counter() - t0) * 1e3
    # the same capture cut at the transmitter's own subframe boundaries:
    # the sync starts one sample late at 20 MHz (as the JAX package's
    # does), and that sample of the next symbol caps the synced SNR
    meas_tx = cell_measurement.measure(
        torch.as_tensor(samples, device="cuda").reshape(n_sf, -1), APP_PRB,
        APP_CELL)
    rc_meas = cell_measurement.main(["-i", str(cap2), "-p", str(APP_PRB)])
    run = pdsch_ue.receive(samples, APP_PRB, APP_RNTI, n_sf)
    launches, shapes_run = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    shapes = hold_shapes("app_stream", shapes_run, seed=120)
    _, tbs, _ = pdsch_enodeb.grant(APP_PRB, APP_MCS)
    lib = stream.load_native()
    def db(m):
        return {k: 10 * math.log10(v) if v > 0 else None
                for k, v in m.items()}
    checks = {
        "ring_built_from_csrc": lib is not None
        and pathlib.Path(lib._name) == cuda_build.library_path("ring_buffer")
        and cuda_build.library_path("ring_buffer").exists(),
        "stream_device": got["device"] == "stream",
        "no_overflows": got["overflows"] == 0,
        "timestamps": got["timestamps"] == [30720 * i for i in range(n_sf)],
        "capture_byte_equal": same, "iq_capture_main_byte_equal":
            rc_capt == 0 and same_main,
        "cell_measurement_rc0": rc_meas == 0,
        "measurements_finite": all(math.isfinite(v) for v in
                                   [*meas.values(), *meas_tx.values()]),
        "snr_above_30db_tx_aligned": meas_tx["snr"] > 1e3,
        "sf0_offset_as_app_pdsch": res.sf0_offset == ref_run.sf0_offset,
        **app_rx_checks(run, tbs),
        "same_results_as_app_pdsch":
            len(run.subframes) == len(ref_run.subframes)
            and all([dataclasses.asdict(d) for d in a.dci]
                    == [dataclasses.asdict(d) for d in b.dci]
                    and a.crc_ok == b.crc_ok
                    and all(np.array_equal(x, y)
                            for x, y in zip(a.tb_bits, b.tb_bits))
                    for a, b in zip(run.subframes, ref_run.subframes)),
        **shape_checks(shapes, launches)}
    line = {"phase": "app_stream", "nof_prb": APP_PRB,
            "ring_library": pathlib.Path(lib._name).name if lib else None,
            "overflows": got["overflows"], "ms_iq_capture": ms_capture,
            "ms_sync_and_measure": ms_measure, "measure_linear": meas,
            "measure_db": db(meas), "measure_db_tx_aligned": db(meas_tx),
            **app_rx_line(run), "launches": launches,
            "peak_mem_gb": peak, "shapes": shapes, "checks": checks}
    emit(line)
    check("app_stream", checks)
    return line


def phase_app_cell_search():
    """``cell_search`` at the MIB acquisition rate: ``pdsch_enodeb -p 6
    -c 1 -f 4`` on the card, then ``cell_search -p 6`` (PSS/SSS scan, then
    the PBCH on the Viterbi kernel at K 40); and ``cell_search -p 100`` on
    the 20 MHz capture, which finds the cell and, as the JAX app, decodes
    no MIB there."""
    import numpy as np
    import torch

    from empower_srslte_tpu_torch.apps import cell_search, pdsch_enodeb
    from empower_srslte_tpu_torch.models.pbch import PBCH_K

    cap6, cap20 = APP_DIR / "enb_6prb.bin", APP_DIR / "enb_20mhz.bin"
    open_counts()
    rc_enb = pdsch_enodeb.main(["-o", str(cap6), "-p", "6", "-c",
                                str(APP_CELL), "-f", "4"])
    s6 = np.fromfile(cap6, np.complex64)
    t0 = time.perf_counter()
    found = cell_search.search(s6, 6)
    torch.cuda.synchronize()
    ms_search6 = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    found20 = cell_search.search(np.fromfile(cap20, np.complex64), APP_PRB)
    torch.cuda.synchronize()
    ms_search20 = (time.perf_counter() - t0) * 1e3
    launches, shapes_run = read_counts()
    peak = torch.cuda.max_memory_allocated() / 1e9
    rc_srch = cell_search.main(["-i", str(cap6), "-p", "6"])
    shapes = hold_shapes("app_cell_search", shapes_run, seed=130)
    want_mib = dict(nof_prb=6, phich_dur=0, phich_res=1, sfn_msb=0,
                    sfn_mod4=0, nof_ports=1)
    checks = {"enodeb_rc0": rc_enb == 0, "cell_search_rc0": rc_srch == 0,
              "cell_id_6prb": found["cell_id"] == APP_CELL,
              "n_id_2": found["n_id_2"] == APP_CELL % 3,
              "mib": found["mib"] == want_mib,
              "cell_id_20mhz": found20["cell_id"] == APP_CELL,
              "no_mib_at_20mhz": found20["mib"] is None,
              "pbch_k40_launched": any(
                  k == PBCH_K for k, _h, _w in shapes_run.get("viterbi37",
                                                              {})),
              "viterbi_twin_exact_every_shape": all(
                  v["mismatched_bits"] == 0
                  for v in shapes["viterbi37"].values()),
              "turbo_not_launched": launches["turbo_nii"]
              + launches["turbo_nii_bf16"] == 0}
    line = {"phase": "app_cell_search", "found_6prb": found,
            "found_20mhz": found20, "ms_cell_search_6prb": ms_search6,
            "ms_cell_search_20mhz": ms_search20, "launches": launches,
            "peak_mem_gb": peak, "shapes": shapes, "checks": checks}
    emit(line)
    for path in APP_DIR.glob("*_20mhz.bin"):
        path.unlink()
    check("app_cell_search", checks)
    return line


#: code blocks of the trellis-sharded decodes at K 6144 (JAX's
#: dryrun_multichip part 2) and the shard counts of ``parallel_sp``
SP_CBS, SP_SHARDS = 8, (2, 4)


def sync_cards():
    """Wait for every visible card (a mesh over several cards runs on all
    of them)."""
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def host_ms(fn, reps: int = 3) -> float:
    """Host-clock ms per call of ``fn`` up to a synchronize of every card,
    mean of ``reps`` calls after one warm-up."""
    fn()
    sync_cards()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    sync_cards()
    return (time.perf_counter() - t0) * 1e3 / reps


def card_meshes():
    """The meshes ``make_mesh`` builds over every visible card: its default
    (carrier, sf) shape and all cards on sf, each once; none on one
    card."""
    import torch

    from empower_srslte_tpu_torch.parallel import make_mesh

    if torch.cuda.device_count() < 2:
        return {}
    out = {}
    for mesh in (make_mesh(carriers=1), make_mesh()):
        out.setdefault("cards_c{carrier}_sf{sf}".format(**mesh.shape), mesh)
    return out


def main_path_tti_code_blocks():
    """One TTI of the main path as its turbo decoder receives it: a
    subframe of ``tm4_stimulus`` through ``ue_dl_tm4_batch`` with
    ``models/sch.py``'s ``derm_to_decoder`` recorded (its first result,
    each code block's de-rate-matched LLRs, which the decoder's inputs
    are but for the filler bits' prior), -> (d_llr [20, 3, K+4] float32:
    2 codewords x 10 code blocks of K 5760, K)."""
    import torch

    from empower_srslte_tpu_torch.models import sch
    from empower_srslte_tpu_torch.models.enb_dl import tm4_stimulus
    from empower_srslte_tpu_torch.models.ue_dl import ue_dl_tm4_batch

    seen = []
    derm = sch.derm_to_decoder

    def recorded(*args, **kw):
        soft, prepared = derm(*args, **kw)
        seen.append(soft)
        return soft, prepared

    st = tm4_stimulus(1, device="cuda")
    sch.derm_to_decoder = recorded
    try:
        res = ue_dl_tm4_batch(st.samples, st.cfg, st.plan)
    finally:
        sch.derm_to_decoder = derm
    assert all(bool(o.all()) for o in res.crc_ok), "main-path TTI failed"
    k = st.plan.segm.cb_sizes[0]
    d_llr = torch.cat([d.reshape(-1, 3, k + 4) for d in seen])
    return d_llr.to(torch.float32), k


def phase_parallel_sp():
    """The trellis-sharded NII decode (``parallel/turbo_sp.py
    sp_turbo_decode_nii``) on an in-process mesh of n = 2 and 4 shards,
    all on cuda:0, each shard one ``turbo_nii`` float32 launch per
    half-iteration with its own bounds ((0, -1), (-1, -1), (-1, last)):
    K 6144 x 8 code blocks at JAX's dry-run stimulus ((1 - 2d) * 8, 2
    iterations) and at Eb/N0 1.2 dB (3 iterations), and one TTI of the
    main path (2 codewords x 10 code blocks of K 5760, 3 iterations).
    Bits and LLRs must equal the one-device NII decode at the same window
    exactly, and the sent bits on the clean stimulus (every code block's
    CRC24B on the TTI); every (shape, bounds) launched is held to the
    twin at 0.0. Host-clock ms per decode are reported beside the
    one-device decode's, not gated. Then ``sp_turbo_decode`` (the plain
    sweeps with halos) on K 1024 x 4 code blocks at n 2. Where two cards
    or more are visible, the three decodes run again on ``make_mesh``
    over the cards (``card_meshes``), one shard per card, and must equal
    the one-device decode as exactly; on one card the line says so."""
    import numpy as np
    import torch

    from empower_srslte_tpu_torch.ops.fec.turbo_decoder import TurboDecoder
    from empower_srslte_tpu_torch.ops.fec.turbo_encoder import turbo_encode
    from empower_srslte_tpu_torch.parallel import (make_mesh,
                                                   sp_turbo_decode,
                                                   sp_turbo_decode_nii)
    from empower_srslte_tpu_torch.parallel.turbo_sp import _pick_window
    from empower_srslte_tpu_torch.utils.crc import CRC24B

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(71)
    rng = np.random.default_rng(71)
    u = torch.as_tensor(rng.integers(0, 2, (SP_CBS, 6144)), device=dev) \
        .to(torch.int8)
    clean = (1.0 - 2.0 * turbo_encode(u).to(torch.float32)) * 8.0
    cb_u, noisy = awgn_code_blocks(g, 6144, SP_CBS, 1.2)
    tti, k_tti = main_path_tti_code_blocks()
    cases = {"k6144_clean": (clean, 6144, 2, u),
             "k6144_noisy": (noisy, 6144, 3, None),
             "main_path_tti": (tti, k_tti, 3, None)}
    line, checks, shapes_all = {"phase": "parallel_sp"}, {}, []
    checks["main_path_tti_20_cbs"] = tti.shape[0] == 20
    total = 0
    for name, (llr, k, its, sent) in cases.items():
        for n in SP_SHARDS:
            mesh = make_mesh(n, carriers=1, devices=[dev] * n)
            l = _pick_window(k // n, 16)
            one = TurboDecoder(k=k, iterations=its, window=l, impl="nii",
                               dtype="float32")
            ref_bits, ref_llr = one.decode(llr)
            (bits, soft), launches, shapes = counted(
                lambda: sp_turbo_decode_nii(llr, k, mesh, axis="sf",
                                            iterations=its))
            shapes_all.append(shapes)
            total += launches["turbo_nii"]
            tag = f"{name}_n{n}"
            checks[f"{tag}_bits_equal_one_device"] = bool(
                torch.equal(bits, ref_bits))
            checks[f"{tag}_llrs_equal_one_device"] = bool(
                torch.equal(soft, ref_llr))
            if sent is not None:
                checks[f"{tag}_bits_equal_sent"] = bool(torch.equal(bits,
                                                                    sent))
            if name == "main_path_tti":
                checks[f"{tag}_every_cb_crc"] = bool(CRC24B.check(bits).all())
            checks[f"{tag}_launches"] = launches["turbo_nii"] == 2 * its * n
            line[tag] = {
                "k": k, "cbs": llr.shape[0], "iterations": its, "window": l,
                "windows_per_shard": k // n // l,
                "launches_per_decode": launches["turbo_nii"],
                "ms_sharded": host_ms(lambda: sp_turbo_decode_nii(
                    llr, k, mesh, axis="sf", iterations=its)),
                "ms_one_device": host_ms(lambda: one.decode(llr)),
                "bit_errors_vs_sent": None if sent is None
                else int((bits != sent).sum()),
                "bit_errors_one_device_noisy": int((ref_bits != cb_u).sum())
                if name == "k6144_noisy" else None}
    multicard = {}
    for mtag, mesh in card_meshes().items():
        n = mesh.shape["sf"]
        for name, (llr, k, its, sent) in cases.items():
            one = TurboDecoder(k=k, iterations=its,
                               window=_pick_window(k // n, 16), impl="nii",
                               dtype="float32")
            ref_bits, ref_llr = one.decode(llr)
            (bits, soft), launches, shapes = counted(
                lambda: sp_turbo_decode_nii(llr, k, mesh, axis="sf",
                                            iterations=its))
            shapes_all.append(shapes)
            tag = f"{name}_{mtag}"
            checks[f"{tag}_bits_equal_one_device"] = bool(
                torch.equal(bits, ref_bits))
            checks[f"{tag}_llrs_equal_one_device"] = bool(
                torch.equal(soft, ref_llr))
            checks[f"{tag}_launches"] = \
                launches["turbo_nii"] == 2 * its * len(mesh.local())
            multicard[tag] = {
                "mesh": mesh.shape,
                "devices": [str(d) for d in mesh.devices.flat],
                "launches_per_decode": launches["turbo_nii"],
                "ms_sharded": host_ms(lambda: sp_turbo_decode_nii(
                    llr, k, mesh, axis="sf", iterations=its)),
                "ms_one_device": host_ms(lambda: one.decode(llr))}
    line["multicard"] = multicard or "not run: 1 card"
    shapes = merge_shapes(*shapes_all)
    twin = hold_shapes("parallel_sp", turbo_shapes(shapes), seed=72)
    checks["every_bounds_variant_launched"] = {
        "first", "interior", "last"} <= {
        bounds_kind(v["bounds"], v["k"] // v["window"])
        for v in twin["turbo_nii"].values()}
    checks.update(turbo_checks(twin))

    k = 1024
    uh = u[:4, :k].contiguous()
    llr_h = (1.0 - 2.0 * turbo_encode(uh).to(torch.float32)) * 8.0
    mesh = make_mesh(2, carriers=1, devices=[dev] * 2)
    t0 = time.perf_counter()
    (bits_h, _), launches_h, _ = counted(
        lambda: sp_turbo_decode(llr_h, k, mesh, axis="sf", iterations=2))
    line["halo_k1024_n2"] = {"k": k, "cbs": 4, "iterations": 2,
                             "ms": (time.perf_counter() - t0) * 1e3,
                             "launches": launches_h}
    checks["halo_bits_equal_sent"] = bool(torch.equal(bits_h, uh))
    checks["halo_no_kernel"] = not any(launches_h.values())
    emit({**line, "turbo_shapes": twin, "checks": checks})
    check("parallel_sp", checks)
    return {"turbo_nii": total}, twin


def batch_on_mesh(st, mesh):
    """``tm4_stimulus``'s batch split by ``shard_batch`` over ``mesh``'s
    (carrier, sf) axes, each shard its own ``ue_dl_tm4_batch`` call
    (``smap``): -> (the run, and a function of the unsharded result
    giving, per field, whether every shard's equals its rows)."""
    import torch

    from empower_srslte_tpu_torch.models.ue_dl import ue_dl_tm4_batch
    from empower_srslte_tpu_torch.parallel import shard_batch
    from empower_srslte_tpu_torch.parallel.mesh import smap

    c, s = mesh.shape["carrier"], mesh.shape["sf"]
    per = BATCH // (c * s)
    x = st.samples.reshape(c, s, per, *st.samples.shape[1:])

    def run():
        return smap(lambda blk: ue_dl_tm4_batch(
            blk.reshape(per, *blk.shape[3:]), st.cfg, st.plan),
            shard_batch(mesh, x))

    def same(out, ref):
        eq = lambda a, b: bool(torch.equal(a.to(b.device), b))
        res = {"tb_bits": True, "crc_ok": True, "cfi": True,
               "dci_hits": True}
        for (ci, si), r in out.items():
            rows = slice((ci * s + si) * per, (ci * s + si + 1) * per)
            for cw in range(2):
                res["tb_bits"] &= eq(r.tb_bits[cw], ref.tb_bits[cw][rows])
                res["crc_ok"] &= eq(r.crc_ok[cw], ref.crc_ok[cw][rows])
            res["cfi"] &= eq(r.cfi, ref.cfi[rows])
            res["dci_hits"] &= eq(r.dci_hits, ref.dci_hits[rows])
        return res

    return run, same


def mini_on_mesh(mini, tbs: int, mesh, dev):
    """``build_uedl_mini``'s step over ``mesh``'s (carrier, sf) axes, one
    subframe a shard: -> (host ms, launches, shapes, the ok flags summed
    over both axes, whether every shard's bits equal its TB)."""
    import torch

    from empower_srslte_tpu_torch.parallel import shard_batch
    from empower_srslte_tpu_torch.parallel.comm import psum
    from empower_srslte_tpu_torch.parallel.mesh import smap

    tb = torch.randint(0, 2, (mesh.shape["carrier"], mesh.shape["sf"], tbs),
                       device=dev,
                       generator=torch.Generator(device=dev).manual_seed(7)) \
        .to(torch.int8)
    t0 = time.perf_counter()
    out, launches, shapes = counted(lambda: smap(mini, shard_batch(mesh, tb)))
    sync_cards()
    ms = (time.perf_counter() - t0) * 1e3
    n_ok = psum(mesh, {co: ok.to(torch.int32).sum()
                       for co, (_, ok) in out.items()}, ("carrier", "sf"))
    bits = all(torch.equal(b[0, 0], tb[co].to(b.device))
               for co, (b, _) in out.items())
    return ms, launches, shapes, sorted({int(v) for v in n_ok.values()}), bits


def phase_parallel_batch():
    """The main path's 256-subframe batch (``tm4_stimulus`` ->
    ``ue_dl_tm4_batch``) split by ``shard_batch`` over an in-process
    ``make_mesh`` of 4 shards on cuda:0 (carrier 2 x sf 2, 64 subframes a
    shard), each shard its own receiver call (``smap``): every TB, CRC
    flag, CFI and DCI count must equal the unsharded call's. Then
    ``build_uedl_mini`` (the 6-PRB no-genie chain of the multi-process
    dry run) over a (2, 2) mesh, its ok flags summed over both axes: 4.
    Where two cards or more are visible, both run again on ``make_mesh``
    over the cards (``card_meshes``) with the same checks; on one card
    the line says so. Kernels are held to their twins at every shape
    launched."""
    import torch

    from empower_srslte_tpu_torch.models.enb_dl import tm4_stimulus
    from empower_srslte_tpu_torch.models.ue_dl import ue_dl_tm4_batch
    from empower_srslte_tpu_torch.parallel import make_mesh
    from empower_srslte_tpu_torch.parallel.validate import build_uedl_mini

    dev = torch.device("cuda", 0)
    st = tm4_stimulus(BATCH, device="cuda")
    mesh = make_mesh(4, devices=[dev] * 4)
    run_one = lambda: ue_dl_tm4_batch(st.samples, st.cfg, st.plan)
    run_sharded, same_as = batch_on_mesh(st, mesh)
    ref = run_one()
    out, launches, shapes = counted(run_sharded)
    same = same_as(out, ref)
    ms_one, ms_sharded = host_ms(run_one), host_ms(run_sharded)
    ms_sharded2, ms_one2 = host_ms(run_sharded), host_ms(run_one)

    mini, tbs = build_uedl_mini(seed=7, device=dev)
    mesh2 = make_mesh(4, carriers=2, devices=[dev] * 4)
    ms_mini, mini_launches, mini_shapes, mini_ok, mini_bits = mini_on_mesh(
        mini, tbs, mesh2, dev)
    checks = {**{f"{k}_equal_unsharded": v for k, v in same.items()},
              "every_crc_ok": bool(all(o.all() for o in ref.crc_ok)),
              "bits_equal_sent": bool(torch.equal(ref.tb_bits[0], st.tb)
                                      and torch.equal(ref.tb_bits[1], st.tb2)),
              "turbo_bf16_launched": launches["turbo_nii_bf16"] > 0,
              "blind_kernel_launched": launches["pdcch_blind"] > 0,
              "mini_ok_sum": mini_ok == [4],
              "mini_bits_equal_sent": mini_bits,
              "mini_viterbi_launched": mini_launches["viterbi37"] > 0}
    shapes_all = [shapes, mini_shapes]
    multicard = {}
    for mtag, cmesh in card_meshes().items():
        run_cards, same_cards = batch_on_mesh(st, cmesh)
        c_out, c_launches, c_shapes = counted(run_cards)
        for k, v in same_cards(c_out, ref).items():
            checks[f"{mtag}_{k}_equal_unsharded"] = v
        ms_c, mc_launches, mc_shapes, mc_ok, mc_bits = mini_on_mesh(
            mini, tbs, cmesh, dev)
        checks[f"{mtag}_mini_ok_sum"] = mc_ok == [len(cmesh.local())]
        checks[f"{mtag}_mini_bits_equal_sent"] = mc_bits
        shapes_all += [c_shapes, mc_shapes]
        multicard[mtag] = {
            "mesh": cmesh.shape,
            "devices": [str(d) for d in cmesh.devices.flat],
            "ms_sharded": host_ms(run_cards), "launches": c_launches,
            "mini": {"ms": ms_c, "ok_sum": mc_ok, "launches": mc_launches}}
    twin = hold_shapes("parallel_batch", merge_shapes(*shapes_all), seed=73)
    checks.update(turbo_checks(twin))
    checks["viterbi_twin_exact_every_shape"] = all(
        v["mismatched_bits"] == 0 for v in twin["viterbi37"].values()) \
        and all(v["exact"] for v in twin["pdcch"].values())
    emit({"phase": "parallel_batch", "batch": BATCH, "mesh": mesh.shape,
          "subframes_per_shard": BATCH // len(mesh.local()),
          "ms_unsharded": (ms_one + ms_one2) / 2,
          "ms_sharded": (ms_sharded + ms_sharded2) / 2,
          "turns_ms": [ms_one, ms_sharded, ms_sharded2, ms_one2],
          "launches": launches, "mini": {
              "mesh": mesh2.shape, "tbs": tbs, "ms": ms_mini,
              "ok_sum": mini_ok, "launches": mini_launches},
          "multicard": multicard or "not run: 1 card",
          "shapes": twin, "checks": checks})
    check("parallel_batch", checks)
    return launches + mini_launches, twin


def run_multihost(backend: str) -> dict:
    """``tools/multihost_dryrun.py`` with 2 processes on ``backend``,
    part B at K 1024 and 6144: -> rank 0's JSON line (``None`` if absent),
    the return code and whether it printed MULTIHOST_OK, with the wall
    seconds."""
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "empower_srslte_tpu_torch.tools."
         "multihost_dryrun", "2", "--backend", backend], cwd=ROOT,
        capture_output=True, text=True, timeout=360)
    report = next((json.loads(ln) for ln in out.stdout.splitlines()
                   if ln.startswith('{"rank"')), None)
    (OUT_DIR / f"multihost_{backend}.log").write_text(out.stdout
                                                      + out.stderr)
    return {"rc": out.returncode, "ok": "MULTIHOST_OK" in out.stdout,
            "seconds": time.perf_counter() - t0, "report": report}


def phase_multihost():
    """The port's multi-process dry run on the card: 2 OS processes, each
    with 4 shards on cuda:0, over gloo (the exchanges staged through host
    memory): the 6-PRB chain over (host, carrier, sf) with a cross-process
    sum, and the trellis-sharded NII decode with axis "host" at K 1024 and
    6144 x 8 code blocks. It must print MULTIHOST_OK. With two cards or
    more it runs again over NCCL, one card per process; with one the line
    says so and nothing stands in for it. The workers count their own
    launches; each (shape, bounds) they report is held to the twin here."""
    import torch

    gloo = run_multihost("gloo")
    cards = torch.cuda.device_count()
    nccl = run_multihost("nccl") if cards >= 2 else "not run: 1 card"
    by_bounds = {}
    for run in (gloo, nccl):
        if isinstance(run, dict) and run["report"]:
            for part in run["report"]["part_b"]:
                for *key, c in part["by_bounds"]:
                    by_bounds[tuple(key)] = by_bounds.get(tuple(key), 0) + c
    twin = hold_shapes("multihost", {"turbo_nii": by_bounds}, seed=74)
    launches = sum(p["launches"] for run in (gloo, nccl)
                   if isinstance(run, dict) and run["report"]
                   for p in run["report"]["part_b"])
    checks = {"gloo_multihost_ok": gloo["rc"] == 0 and gloo["ok"],
              "gloo_report": gloo["report"] is not None,
              "turbo_launched": launches > 0 and bool(twin["turbo_nii"]),
              **turbo_checks(twin)}
    if isinstance(nccl, dict):
        checks["nccl_multihost_ok"] = nccl["rc"] == 0 and nccl["ok"]
    emit({"phase": "multihost", "cards": cards, "gloo": gloo, "nccl": nccl,
          "launches_in_workers": launches, "turbo_shapes": twin,
          "checks": checks})
    check("multihost", checks)
    return {"turbo_nii": launches}, twin


def phase_precision_pair():
    """``main_path``'s and ``uplink_path``'s stimulus through their
    receivers with the turbo decoders pinned to float32 and at the default
    ``"auto"`` (bfloat16 there), in turns (float32, auto, auto, float32),
    each a counted run: ms per batch, Mbps, peak memory and launches per
    precision. Both precisions must decode every TB and UCI field; each
    launches only its own kernels. No gain is claimed either way."""
    import copy
    import dataclasses

    import torch

    from empower_srslte_tpu_torch.models.enb_dl import tm4_stimulus
    from empower_srslte_tpu_torch.models.ue_dl import ue_dl_tm4_batch
    from empower_srslte_tpu_torch.models.ue_ul import ul_uci_stimulus
    from empower_srslte_tpu_torch.tools.rx_bler_sweep import float32_plan

    dl = tm4_stimulus(BATCH, device="cuda")
    ul = ul_uci_stimulus(BATCH, UL_N0, device="cuda")
    ul32 = copy.copy(ul.plan)
    ul32.data_plan = float32_plan(ul.plan.data_plan)
    plans = {"main_path": {"float32": float32_plan(dl.plan),
                           "auto": dl.plan},
             "uplink_path": {"float32": ul32, "auto": ul.plan}}
    kernel = {"main_path": "turbo_nii", "uplink_path": "turbo_win"}

    def run(path, prec):
        if path == "main_path":
            return ue_dl_tm4_batch(dl.samples, dl.cfg, plans[path][prec])
        return run_uplink(dataclasses.replace(ul, plan=plans[path][prec]),
                          UL_N0)[0]

    def ok(path, out) -> bool:
        if path == "main_path":
            return bool(all(o.all() for o in out.crc_ok)
                        and torch.equal(out.tb_bits[0], dl.tb)
                        and torch.equal(out.tb_bits[1], dl.tb2))
        return bool(out["crc_ok"].all() and torch.equal(out["tb"], ul.tb)
                    and not any(uci_errors(out, ul.plan).values()))

    line, checks = {"phase": "precision_pair", "batch": BATCH,
                    "order": ["float32", "auto", "auto", "float32"]}, {}
    for path, st in (("main_path", dl), ("uplink_path", ul)):
        tbs = st.plan.tbs * (2 if path == "main_path" else 1)
        per = {p: {"ms_runs": [], "peak_runs": []}
               for p in ("float32", "auto")}
        for prec in line["order"]:
            out, launches, _ms_first, ms, peak, _ = counted_run(
                lambda: run(path, prec))
            per[prec]["ms_runs"].append(ms)
            per[prec]["peak_runs"].append(peak)
            per[prec]["launches"] = launches
            checks[f"{path}_{prec}_decodes"] = ok(path, out)
        for prec, v in per.items():
            ms = sum(v["ms_runs"]) / 2
            v.update(ms_per_batch=ms,
                     mbps=BATCH * tbs / (ms * 1e-3) / 1e6,
                     peak_mem_gb=max(v["peak_runs"]))
        k = kernel[path]
        checks[f"{path}_float32_only_f32_kernel"] = (
            per["float32"]["launches"][k] > 0
            and per["float32"]["launches"][k + "_bf16"] == 0)
        checks[f"{path}_auto_only_bf16_kernel"] = (
            per["auto"]["launches"][k + "_bf16"] > 0
            and per["auto"]["launches"][k] == 0)
        line[path] = per
    emit({**line, "checks": checks})
    check("precision_pair", checks)
    return {path: {p: line[path][p]["launches"] for p in ("float32", "auto")}
            for path in ("main_path", "uplink_path")}


def phase_bler_gate():
    """The port's BLER sweep tool (``tools/bler_sweep.py``) on the card:
    K 1024, 6 iterations, window 128, both kernel decoders at float32 and
    bfloat16, float32 and int8 LLRs, ``BLER_CBS`` code blocks per point on
    the JAX tool's grid plus 0.1 dB steps from 0.6 to 1.4 dB. Fails
    unless ``bler_sweep.gate`` holds: each bfloat16 curve within 0.1 dB of
    its float32 curve (3 sigma, binomial), every curve <= 0.378 (srsLTE's
    decoder) at 1.0 dB and <= 0.05 at 1.2 dB. The kernels are held to their
    twins at every shape the sweep launched."""
    import torch

    from empower_srslte_tpu_torch.tools import bler_sweep

    t0 = time.perf_counter()
    res, launches, shapes = counted(
        lambda: bler_sweep.sweep(cbs=BLER_CBS, device="cuda"))
    seconds = time.perf_counter() - t0
    verdict = bler_sweep.gate(res)
    twin = hold_shapes("bler_gate", turbo_shapes(shapes), seed=60)
    checks = {**verdict["checks"], **turbo_checks(twin),
              "every_kernel_launched": all(
                  launches[n] > 0 for n in ("turbo_nii", "turbo_nii_bf16",
                                            "turbo_win", "turbo_win_bf16"))}
    emit({"phase": "bler_gate", "seconds": seconds, **res,
          "gate": verdict, "launches": launches, "turbo_shapes": twin,
          "device_name": torch.cuda.get_device_name(0), "checks": checks})
    check("bler_gate", checks)
    return launches, twin


def phase_rx_bler_gate():
    """The port's receiver BLER sweep tool (``tools/rx_bler_sweep.py``)
    with its gate on the card: the whole downlink chain (compose, iFFT,
    AWGN, FFT, chest off the CRS, noise estimate, equalize, decode) at 50
    PRB for MCS 4, 12 and 22, every batch decoded at float32 and at
    "auto" (bfloat16) on the same noise; first the JAX tool's own inputs
    (64 subframes a point, seed 0), then each waterfall in 0.1 dB steps
    at ``rx_bler_sweep.WATERFALL_N`` subframes a point. Fails unless
    ``rx_bler_sweep.gate`` holds (the float32 curves within max(3 sigma,
    2/64) of the JAX package's, each "auto" curve within 0.1 dB of its
    float32 curve), both ``turbo_nii`` instances launched, and the kernel
    equals its twin at every shape the sweep launched."""
    import torch

    from empower_srslte_tpu_torch.tools import rx_bler_sweep

    t0 = time.perf_counter()
    (parity, water), launches, shapes = counted(
        lambda: rx_bler_sweep.gate_passes(device="cuda"))
    seconds = time.perf_counter() - t0
    verdict = rx_bler_sweep.gate(parity, water)
    twin = hold_shapes("rx_bler_gate", turbo_shapes(shapes), seed=90)
    checks = {**verdict["checks"], **turbo_checks(twin),
              "both_nii_instances_launched": (
                  launches["turbo_nii"] > 0
                  and launches["turbo_nii_bf16"] > 0)}
    emit({"phase": "rx_bler_gate", "seconds": seconds,
          "hold_seconds": time.perf_counter() - t0 - seconds,
          "parity": parity, "waterfall": water, "gate": verdict,
          "launches": launches, "turbo_shapes": twin,
          "device_name": torch.cuda.get_device_name(0), "checks": checks})
    check("rx_bler_gate", checks)
    return launches, twin


def phase_scaling_sweep():
    """The port's weak-scaling tool (``tools/scaling_sweep.py``) on the
    card: the sharded 20 MHz TM4 step (MCS 18, 2 codewords, the ``"xla"``
    plan, as the JAX tool pins it: the plain sweeps, no kernel) at n = 1,
    2 and 4 over cuda:0 four times, one repetition; where two cards or
    more are visible, again over the cards. Every CRC at every n must
    pass (the tool raises otherwise), and at each n the mesh must have
    had n shards on the devices given. ms per step are host-bound by
    design: reported, not gated."""
    import torch

    from empower_srslte_tpu_torch.parallel.mesh import visible_devices
    from empower_srslte_tpu_torch.tools import scaling_sweep

    runs = {"virtual4": [torch.device("cuda", 0)] * 4}
    if torch.cuda.device_count() >= 2:
        runs["cards"] = visible_devices()
    line, checks, total = {"phase": "scaling_sweep"}, {}, {}
    for tag, devs in runs.items():
        t0 = time.perf_counter()
        res, launches, _ = counted(
            lambda devs=devs: scaling_sweep.sweep(devs, reps=1))
        rows = res["rows"]
        sizes = [n for n in scaling_sweep.SIZES if n <= len(devs)]
        checks[f"{tag}_every_n_ran"] = [r["devices"] for r in rows] == sizes
        checks[f"{tag}_every_crc_ok"] = all(
            all(all(v) for v in r["crc_ok"]) for r in rows)
        checks[f"{tag}_n_shards"] = all(
            r["shards"] == r["devices"] == len(r["device_list"])
            and r["device_list"] == [str(d) for d in devs[:r["devices"]]]
            for r in rows)
        line[tag] = {**res, "launches": launches,
                     "seconds": time.perf_counter() - t0}
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    if "cards" not in runs:
        line["cards"] = "not run: 1 card"
    emit({**line, "checks": checks})
    check("scaling_sweep", checks)
    return total


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
    from empower_srslte_tpu_torch.models.pbch import PBCH_K
    from empower_srslte_tpu_torch.ops.fec.convcoder import TRAIN_LEN

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if "--baseline" in sys.argv:
        BASELINES[:] = load_baselines(
            sys.argv[sys.argv.index("--baseline") + 1])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "phases.jsonl").unlink(missing_ok=True)
    phase_device()
    phase_build()
    if "--phases" in sys.argv:
        names = sys.argv[sys.argv.index("--phases") + 1].split(",")
        alone = {"chest_dl": phase_chest_dl,
                 "pdcch_rx": phase_pdcch_rx,
                 "sch_derm": phase_sch_derm,
                 "turbo_enc": phase_turbo_enc,
                 "pdcch_tx": phase_pdcch_tx,
                 "main_path": phase_main_path,
                 "dl_tm2_batch": phase_dl_tm2_batch,
                 "enb_dl_tx": phase_enb_dl_tx,
                 "tm2": phase_tm2,
                 "tm3": phase_tm3,
                 "pmch": phase_pmch,
                 "bler_gate": phase_bler_gate,
                 "ue_dl_frame": phase_ue_dl_frame,
                 "cold_boot": phase_cold_boot,
                 "kernel_turbo": turbo_kernel_check,
                 "kernel_turbo_win": turbo_win_kernel_check,
                 "parallel_sp": phase_parallel_sp,
                 "parallel_batch": phase_parallel_batch,
                 "multihost": phase_multihost,
                 "rx_bler_gate": phase_rx_bler_gate,
                 "scaling_sweep": phase_scaling_sweep,
                 "uplink_path": phase_uplink,
                 "uplink_midsnr": phase_uplink_midsnr,
                 "uplink_int8": phase_uplink_int8,
                 "uplink_msg3": phase_uplink_msg3,
                 "ul_control": phase_ul_control,
                 "precision_pair": phase_precision_pair,
                 "stack_attach": phase_stack_attach,
                 "stack_tm4": phase_stack_tm4,
                 "stack_cold_boot": phase_stack_cold_boot,
                 **{name: (lambda name=name: phase_stack_scenarios(name))
                    for name in STACK_SCENARIO_PHASES}}
        for name in names:
            alone[name]()
        emit({"ok": True, "phases": names,
              "device": {"platform": "gpu",
                         "kind": torch.cuda.get_device_name(0),
                         "count": torch.cuda.device_count()}})
        return 0
    chest_out = phase_chest_dl()
    pdcch_out = phase_pdcch_rx()
    derm_out = phase_sch_derm()
    enc_out = phase_turbo_enc()
    tx_out = phase_pdcch_tx()
    turbo, turbo16 = turbo_kernel_check()
    words = BATCH * n_candidates()
    vit = viterbi_kernel_check(
        "kernel_viterbi", [(55, words), (44, words), (PBCH_K, 4 * BATCH)],
        seed=3,
        extra=[(20, 512, TRAIN_LEN, "noisy"), (31, 512, TRAIN_LEN, "noisy"),
               (64, 512, TRAIN_LEN, "noisy"),
               (256, 512, TRAIN_LEN, "noisy"), (55, 512, None, "noisy"),
               (256, 256, None, "noisy"), (55, 512, TRAIN_LEN, "ints"),
               (20, 512, None, "ints")])
    win, win16 = turbo_win_kernel_check()
    rec_launches, rec, rates = recursion_kernel_check()
    probe_bf16 = next(r["tops"] for r in rates if r["type"] == "bf16")
    launches, main_shapes = phase_main_path()
    tm2b_launches, tm2b_shapes = phase_dl_tm2_batch()
    tx_launches = phase_enb_dl_tx()
    ul_launches, vit_ul, ul_shapes = phase_uplink()
    phase_uplink_midsnr()
    tm2, tm2_shapes = phase_tm2()
    tm3, tm3_shapes = phase_tm3()
    frame, frame_shapes = phase_ue_dl_frame()
    ul8, ul8_shapes = phase_uplink_int8()
    msg3, msg3_shapes = phase_uplink_msg3()
    cold, cold_shapes = phase_cold_boot()
    pbch = phase_pbch_batch()
    phase_ul_control()
    phase_prach()
    pmch_launches, pmch_shapes = phase_pmch()
    phase_turbo_xla()
    stack = {"stack_attach": phase_stack_attach(),
             "stack_tm4": phase_stack_tm4(),
             "stack_cold_boot": phase_stack_cold_boot(),
             **{name: phase_stack_scenarios(name)
                for name in STACK_SCENARIO_PHASES}}
    app_pdsch, app_run = phase_app_pdsch()
    apps = {"app_pdsch": app_pdsch,
            "app_stream": phase_app_stream(app_run),
            "app_cell_search": phase_app_cell_search()}
    sp_launches, sp_shapes = phase_parallel_sp()
    batch_launches, batch_shapes = phase_parallel_batch()
    mh_launches, mh_shapes = phase_multihost()
    pair = phase_precision_pair()
    gate_launches, gate_shapes = phase_bler_gate()
    rx_launches, rx_shapes = phase_rx_bler_gate()
    scaling_launches = phase_scaling_sweep()
    shaped = {**stack, **apps}
    by_path = {"main_path": launches, "dl_tm2_batch": tm2b_launches,
               "enb_dl_tx": tx_launches,
               "uplink_path": ul_launches, **tm2,
               "tm3_path": tm3, "ue_dl_frame": frame, "uplink_int8": ul8,
               "uplink_msg3": msg3,
               "cold_boot": cold, "pbch_batch": pbch,
               "pmch_path": pmch_launches,
               **{k: v["launches"] for k, v in shaped.items()},
               "parallel_sp": sp_launches, "parallel_batch": batch_launches,
               "multihost": mh_launches,
               **{f"precision_pair_{path}_{prec}": v
                  for path, by in pair.items() for prec, v in by.items()},
               "bler_gate": gate_launches, "rx_bler_gate": rx_launches,
               "scaling_sweep": scaling_launches}
    path_shapes = {"main_path": main_shapes, "dl_tm2_batch": tm2b_shapes,
                   "uplink_path": ul_shapes,
                   **tm2_shapes, "tm3_path": tm3_shapes,
                   "ue_dl_frame": frame_shapes, "uplink_int8": ul8_shapes,
                   "uplink_msg3": msg3_shapes, "cold_boot": cold_shapes,
                   "pmch_path": pmch_shapes, "bler_gate": gate_shapes,
                   "rx_bler_gate": rx_shapes,
                   "parallel_sp": sp_shapes, "parallel_batch": batch_shapes,
                   "multihost": mh_shapes,
                   **{k: v["shapes"] for k, v in shaped.items()}}

    def per_path(name):
        return {k: v[name] for k, v in by_path.items() if v.get(name)}

    def turbo_entry(name, module, entry, main_launches):
        """A turbo kernel's entry: its launches on its main path, per
        path, its shapes per path (the dtype's only), every path
        geometry's error folded into ``max_abs_err``."""
        dt = "bfloat16" if name.endswith("bf16") else "float32"
        shapes = {p: {n: v for n, v in sh.get(module, {}).items()
                      if v["dtype"] == dt}
                  for p, sh in path_shapes.items()}
        by_bounds = {}
        for v in (v for sh in shapes.values() for v in sh.values()
                  if "bounds" in v):
            kind = bounds_kind(v["bounds"], v["k"] // v["window"])
            by_bounds[kind] = max(by_bounds.get(kind, 0.0), v["max_abs_err"])
        return {"name": name, "route": "cuda",
                "source": f"empower_srslte_tpu_torch/csrc/{module}.cu",
                "replaces": REPLACES[module], "dtype": dt,
                "launches": main_launches,
                "launches_by_path": per_path(name), **entry,
                "max_abs_err": max([entry["max_abs_err"],
                                    *PATH_TWIN[name].values()]),
                "max_abs_err_by_path_geometry": PATH_TWIN[name],
                **({"max_abs_err_by_bounds": by_bounds} if by_bounds else {}),
                "by_path_shape": {p: v for p, v in shapes.items() if v},
                "ptxas": ptxas_of(module, "OpsBf16x2" if dt == "bfloat16"
                                  else "OpsF32"),
                **({"ops_rate": PEAK_BF16_OPS_PER_S,
                    "probe_bf16_tops": probe_bf16}
                   if dt == "bfloat16" else {}),
                "library_ms": None}

    emit({"kernels": [
        # the float32 kernels' path is precision_pair's float32 run (the
        # main and uplink paths decode in bfloat16 by default)
        turbo_entry("turbo_nii", "turbo_nii", turbo,
                    pair["main_path"]["float32"]["turbo_nii"]),
        turbo_entry("turbo_nii_bf16", "turbo_nii", turbo16,
                    launches["turbo_nii_bf16"]),
        {"name": "viterbi37", "route": "cuda",
         "source": "empower_srslte_tpu_torch/csrc/viterbi37.cu",
         "replaces": "empower_srslte_tpu/ops/fec/viterbi_pallas.py:146",
         "launches": launches["viterbi37"],
         "launches_by_path": per_path("viterbi37"), **vit,
         "mismatched_bits_by_path_geometry": PATH_TWIN["viterbi37"],
         "by_path_shape": {k: v["shapes"]["viterbi37"]
                           for k, v in shaped.items()},
         "library_ms": None,
         "uplink": {"launches": ul_launches["viterbi37"], **vit_ul}},
        turbo_entry("turbo_win", "turbo_win", win,
                    pair["uplink_path"]["float32"]["turbo_win"]),
        turbo_entry("turbo_win_bf16", "turbo_win", win16,
                    ul_launches["turbo_win_bf16"]),
        {"name": "chest_dl", "route": "cuda",
         "source": "empower_srslte_tpu_torch/csrc/chest_dl.cu",
         "replaces": None, "launches": launches["chest_dl"],
         "launches_by_path": per_path("chest_dl"),
         "held_by_path_shape": PATH_TWIN["chest_dl"],
         **{k: chest_out[k] for k in ("shapes", "launches_per_call",
                                      "ptxas")},
         "library_ms": None},
        {"name": "pdcch_rx", "route": "cuda",
         "source": "empower_srslte_tpu_torch/csrc/pdcch_rx.cu",
         "replaces": "empower_srslte_tpu/ops/fec/viterbi_pallas.py:146 "
                     "(the blind search's Viterbi; the rest none)",
         "launches": launches["ctrl_llr"] + launches["pdcch_blind"],
         "launches_by_path": {k: {n: v.get(n, 0)
                                  for n in ("ctrl_llr", "pdcch_blind")}
                              for k, v in by_path.items()
                              if v.get("ctrl_llr") or v.get("pdcch_blind")},
         "exact_by_path_shape": PATH_TWIN["pdcch_rx"],
         **{k: pdcch_out[k] for k in ("shapes", "launches_per_call",
                                      "ptxas")},
         "library_ms": None},
        {"name": "sch_derm", "route": "cuda",
         "source": "empower_srslte_tpu_torch/csrc/sch_derm.cu",
         "replaces": None, "launches": launches["sch_derm"],
         "launches_by_path": per_path("sch_derm"),
         "held_by_path_shape": PATH_TWIN["sch_derm"],
         **{k: derm_out[k] for k in ("shapes", "launches_per_call",
                                      "main", "tti", "ptxas")},
         "library_ms": None},
        {"name": "turbo_enc", "route": "cuda",
         "source": "empower_srslte_tpu_torch/csrc/turbo_enc.cu",
         "replaces": None, "launches": tx_launches["turbo_enc"],
         "launches_by_path": per_path("turbo_enc"),
         **{k: enc_out[k] for k in ("shapes", "mismatched_by_k",
                                    "mismatched_by_dtype", "main", "ptxas")},
         "library_ms": None},
        {"name": "pdcch_tx", "route": "cuda",
         "source": "empower_srslte_tpu_torch/csrc/pdcch_tx.cu",
         "replaces": None, "launches": tx_launches["pdcch_tx"],
         "launches_by_path": per_path("pdcch_tx"),
         "mismatched_by_path_shape": PATH_TWIN["pdcch_tx"],
         **{k: tx_out[k] for k in ("cases", "extra", "main", "ptxas")},
         "library_ms": None},
        {"name": "recursion_probe", "route": "cuda",
         "source": "empower_srslte_tpu_torch/csrc/recursion_probe.cu",
         "replaces": "tools/microbench_vpu.py:55",
         "launches": rec_launches,
         "launches_by_path": {"microbench_recursion": rec_launches}, **rec,
         "library_ms": None},
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
