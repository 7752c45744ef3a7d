"""The port's program ranges and first-use counters (``runtime.trace``) on
the CPU, at a tiny 2x2 TM4 cell (6 PRB, batch 2, 30 dB).

Under ``torch.profiler`` the batched receiver emits its root range
``ue_dl.tm4_batch``, every stage range by its old name (the PCFICH runs
inside ``ue_dl.pdcch_llr``, as its kernel does on the card, so
``ue_dl.pcfich`` is gone), and one
``turbo.stop_read`` inside ``dlsch.turbo_decode`` per early-stop check;
the new ranges nested in a stage hold no operation that would launch a
kernel on a card (only the early-stop read's own scalar copy). With the
profiler off a span is one flag check: no ``record_function`` is entered
and nothing is counted. A fresh device table counts one
``table_build``, a forced full collection one ``gc_gen2``.
"""

import gc
import re
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from empower_srslte_tpu_torch import profile_main_path
from empower_srslte_tpu_torch.models import ra
from empower_srslte_tpu_torch.models.dci import format1_size
from empower_srslte_tpu_torch.models.enb_dl import enb_dl_tm4, tm4_draws
from empower_srslte_tpu_torch.models.pdsch import PdschConfig
from empower_srslte_tpu_torch.models.ue_dl import ue_dl_tm4_batch
from empower_srslte_tpu_torch.ops.equalizer import MimoType
from empower_srslte_tpu_torch.runtime import trace
from empower_srslte_tpu_torch.utils.cell import Cell
from empower_srslte_tpu_torch.utils.device import device_table

BATCH, NOF_PRB, MCS, CFI, SF_IDX, RNTI = 2, 6, 10, 2, 1, 0x1234
#: the stage ranges the benchmark's per-layer metrics read, by name
STAGES = ("ue_dl.ofdm_rx", "ue_dl.chest_noise", "ue_dl.pdcch_llr", "ue_dl.pdcch_blind_search", "pdsch.eq_demod",
          "dlsch.derm", "dlsch.turbo_decode", "dlsch.crc_reassembly")
#: the ranges this module nests inside a stage: none may launch a kernel
NESTED = re.compile(r"^(turbo\.stop_read|runtime\.\w+)$")
#: CPU ops a nested range may hold: the early-stop read's scalar copy
#: to the host, and a new table's copy to the card
READ_OPS = re.compile(r"^aten::(is_nonzero|item|_local_scalar_dense|copy_"
                      r"|to|_to_copy|empty|empty_strided|lift_fresh"
                      r"|detach_)$")


def _ranges(events, name):
    return [e for e in events if e.device_type == DeviceType.CPU
            and e.name == name]


def _inside(e, r) -> bool:
    return (e is not r and r.time_range.start <= e.time_range.start
            and e.time_range.end <= r.time_range.end)


@pytest.fixture(scope="module")
def tm4():
    """A tiny TM4 batch, its receiver warmed, and one call traced."""
    torch.manual_seed(0)
    cell = Cell(nof_prb=NOF_PRB, nof_ports=2, id=1)
    mod, tbs = ra.mcs_to_tbs(MCS, NOF_PRB)
    cfg = PdschConfig(cell=cell, sf_idx=SF_IDX, cfi=CFI, rnti=RNTI, mod=mod,
                      mimo=MimoType.SPATIAL_MUX, nof_layers=2,
                      nof_codewords=2)
    plan = cfg.plan(tbs)
    d = tm4_draws(BATCH, tbs, format1_size(NOF_PRB), cell.sf_sample_len)
    noise = torch.complex(torch.as_tensor(d["nz_re"]),
                          torch.as_tensor(d["nz_im"]))
    samples = enb_dl_tm4(torch.as_tensor(d["tb"]), torch.as_tensor(d["tb2"]),
                         torch.as_tensor(d["h2"]), noise, cfg, plan,
                         torch.as_tensor(d["dci_bits"]), 0, 4)
    ue_dl_tm4_batch(samples, cfg, plan)
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = ue_dl_tm4_batch(samples, cfg, plan)
        counted = trace.counts()
    return SimpleNamespace(samples=samples, cfg=cfg, plan=plan, res=res,
                           events=prof.events(), counted=counted,
                           sent=(d["tb"], d["tb2"]))


def test_the_traced_call_decodes(tm4):
    for bits, ok, sent in zip(tm4.res.tb_bits, tm4.res.crc_ok, tm4.sent):
        assert ok.all()
        assert (bits.numpy() == sent).all()


@pytest.mark.parametrize("name", STAGES)
def test_every_stage_range_keeps_its_name_inside_the_root(tm4, name):
    root, = _ranges(tm4.events, "ue_dl.tm4_batch")
    got = _ranges(tm4.events, name)
    assert len(got) == 1
    assert _inside(got[0], root)


def test_the_pcfich_decodes_inside_the_pdcch_llr_range(tm4, monkeypatch):
    """The PCFICH has no range of its own any more: it is decoded in
    ``ue_dl.pdcch_llr``, with the region's LLRs."""
    from empower_srslte_tpu_torch.models import pcfich

    assert _ranges(tm4.events, "ue_dl.pcfich") == []
    seen = []
    real = pcfich._pcfich_decode_plain

    def spy(*args, **kw):
        seen.append(trace.tracing())
        return real(*args, **kw)

    monkeypatch.setattr(pcfich, "_pcfich_decode_plain", spy)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        res = ue_dl_tm4_batch(tm4.samples, tm4.cfg, tm4.plan)
    assert seen == [True]
    assert (res.cfi == CFI).all()
    llr, = _ranges(prof.events(), "ue_dl.pdcch_llr")
    assert any(e.name == "aten::einsum" and _inside(e, llr)
               for e in prof.events())


def test_one_stop_read_per_early_stop_check(tm4):
    """The turbo decoder reads its flag after every iteration but the
    last allowed one, and stops at the first that passes."""
    limit = tm4.plan.max_iterations
    checks = sum(it if it < limit else limit - 1
                 for it in tm4.res.iterations)
    reads = _ranges(tm4.events, "turbo.stop_read")
    assert checks >= 1 and len(reads) == checks
    decode, = _ranges(tm4.events, "dlsch.turbo_decode")
    assert all(_inside(r, decode) for r in reads)


def test_no_nested_range_holds_a_kernel_launching_op(tm4):
    nested = [e for e in tm4.events if e.device_type == DeviceType.CPU
              and NESTED.match(e.name)]
    assert nested
    held = {e.name for r in nested for e in tm4.events
            if e.device_type == DeviceType.CPU and _inside(e, r)
            and e.name.startswith("aten::")}
    assert held and all(READ_OPS.match(n) for n in held), held
    assert "aten::_local_scalar_dense" in held


def test_a_warm_call_counts_no_first_use_event(tm4):
    assert {k: v for k, v in tm4.counted.items() if k != "gc_gen2"} == {}


def test_profiler_off_enters_no_range_and_counts_nothing(tm4, monkeypatch):
    def refuse(name, *args):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert not trace.tracing()
    assert trace.span("a.b") is trace.span("c.d")
    assert trace.root("ue_dl.tm4_batch", "cpu") is trace.span("a.b")
    trace.reset()
    res = ue_dl_tm4_batch(tm4.samples, tm4.cfg, tm4.plan)
    device_table(("trace_test_off", 1), "cpu", lambda: [1, 2])
    trace.count("table_build")
    gc.collect()
    assert trace.counts() == {}
    for got, ref in zip(res.tb_bits, tm4.res.tb_bits):
        assert torch.equal(got, ref)


def test_a_fresh_device_table_counts_one_build_and_its_reuse_none():
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        first = device_table(("trace_test_fresh", 7), "cpu", lambda: [7, 8])
        once = trace.counts()
        again = device_table(("trace_test_fresh", 7), "cpu", lambda: [0])
        twice = trace.counts()
    assert once.get("table_build") == 1 and twice.get("table_build") == 1
    assert again is first
    built, = _ranges(prof.events(), "runtime.table_build")
    held = {e.name for e in prof.events() if _inside(e, built)
            and e.name.startswith("aten::")}
    assert all(READ_OPS.match(n) for n in held), held


def test_a_forced_collection_counts_one_gc_gen2():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.reset()
        gc.collect()
        counted = trace.counts()
    assert counted.get("gc_gen2") == 1
    assert _ranges(prof.events(), "runtime.gc")


def test_enable_counts_without_the_profiler():
    trace.reset()
    trace.enable()
    try:
        assert trace.tracing()
        trace.count("kernel_load")
        with trace.span("runtime.kernel_load"):
            pass
    finally:
        trace.disable()
    trace.count("kernel_load")
    assert trace.counts() == {"kernel_load": 1}
    trace.reset()
    assert trace.counts() == {}


def test_root_counts_the_growth_of_the_device_counters(monkeypatch):
    """``alloc_segment`` and ``cufft_plan`` are read before the root range
    opens and after it closes; only growth counts."""
    readings = iter([(5, 3), (7, 3)])
    monkeypatch.setattr(trace, "_device_counters",
                        lambda device: next(readings))
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.root("ue_dl.tm4_batch", "cuda:0"):
            pass
        counted = trace.counts()
    assert counted == {"alloc_segment": 2}


def _event(name, start, end, *, cuda=False, eid=0, device_us=0.0):
    return SimpleNamespace(
        name=name, id=eid, time_range=SimpleNamespace(start=start, end=end),
        device_type=DeviceType.CUDA if cuda else DeviceType.CPU,
        is_user_annotation=False, cpu_time_total=end - start,
        device_time=device_us)


def test_profile_main_path_gives_a_kernel_to_the_innermost_range():
    """With a root range around the call, a kernel still belongs to the
    stage (or nested range) its launch was made in."""
    events = [_event("ue_dl.tm4_batch", 0, 100),
              _event("dlsch.turbo_decode", 10, 60),
              _event("turbo.stop_read", 40, 50),
              _event("cudaLaunchKernel", 20, 21, eid=1),
              _event("cudaMemcpyAsync", 45, 46, eid=2),
              _event("cudaLaunchKernel", 80, 81, eid=3),
              _event("nii_kernel", 22, 30, cuda=True, eid=1, device_us=8.0),
              _event("Memcpy DtoH", 47, 48, cuda=True, eid=2, device_us=1.0),
              _event("cat_kernel", 82, 84, cuda=True, eid=3, device_us=2.0)]
    out = profile_main_path.read_trace(events, wall_ms=0.1)
    device = {n: s["device_ms"] for n, s in out["stages"].items()}
    assert device == pytest.approx({"ue_dl.tm4_batch": 0.002,
                                    "dlsch.turbo_decode": 0.008,
                                    "turbo.stop_read": 0.001})
    assert out["device_ms_outside_stages"] == 0.0
    assert out["kernel_launches"] == 3
