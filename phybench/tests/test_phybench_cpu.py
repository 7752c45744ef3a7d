"""The harness on the CPU at a tiny size: each driver through the port's
plain twins against the plain reference, the control, the faults the
check must catch, and what the metrics read."""

from __future__ import annotations

import pathlib
import shutil
import time

import numpy as np
import pytest
import torch

from phybench import roofline, stats
from phybench.harness import Window, measure, run_cell

from .conftest import TINY


def driver_for(spec, workload, seed=2**31 + 17):
    import importlib

    cell = spec.cell(workload)
    conf, traffic = spec.config(cell["config"]), spec.traffic(cell["traffic"])
    mod = importlib.import_module(f"phybench.drivers.{conf['driver']}")
    return mod.Driver(conf, traffic, seed, "cpu")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", sorted(TINY))
def test_port_agrees_with_reference(tiny_spec, workload):
    out = run_cell(tiny_spec, workload, 2**31 + 5, 0.5, False, "cpu",
                   time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    checks = {k: v["value"] for k, v in out["checks"].items()}
    # float32 against the reference's float64: close, not equal
    assert 0 < checks["gap.soft"] < 1e-5, checks
    assert checks["diff.tb"] == 0 and checks["replay"] == 0, checks
    assert {"mbps", "setup_s", "batch_p95_ms"} <= set(out["metrics"])


@pytest.mark.parametrize("workload", sorted(TINY))
def test_control_fails(tiny_spec, workload):
    """The reference at the precision below the configuration's, in the
    port's place, fails the cell's limits."""
    drv = driver_for(tiny_spec, workload)
    readings = drv.check(lower=True)
    limits = tiny_spec.limits(workload)
    assert readings["gap.soft"] > limits["gap.soft"], readings


def test_reference_decodes_the_sent_bits(tiny_spec):
    """The plain reference, sharing no code with the transmitter, decodes
    its subframes to the sent bits."""
    from phybench.references import dl_pdsch

    drv = driver_for(tiny_spec, "t_dl")
    got = dl_pdsch.receive(drv.samples[:4].numpy(), drv.conf)
    assert got["crc"].all()
    assert (got["bits"] == drv.tb[:, :4].numpy()).all()
    assert got["soft"].shape[:2] == (2, 4)


@pytest.mark.parametrize("prb,cfi", [(100, 1), (100, 3), (25, 2), (6, 2)])
def test_transmitter_control_region_is_the_specification(prb, cfi):
    """The transmitter's PCFICH and PDCCH (a copy of the port's encoders)
    equal, RE for RE, the control region written from TS 36.211/36.212
    alone: so the window's ``cfi_wrong`` and ``dci_missed`` hold the port
    to the specification."""
    import json

    from phybench.frozen.models.pcfich import pcfich_put
    from phybench.frozen.models.pdcch import pdcch_encode
    from phybench.inputs import dl_tm4 as tx
    from phybench.references import dl_control

    conf = json.loads((pathlib.Path(__file__).resolve().parent.parent
                       / "configs" / "dl_tm4_20mhz.json").read_text())
    conf.update(nof_prb=prb, cfi=cfi)
    cell = tx.plan(conf)[0].cell
    gen = torch.Generator()
    gen.manual_seed(prb * 10 + cfi)
    bits = torch.randint(0, 2, (tx.DCI_SIZES[conf["dci_format"]](prb),),
                         generator=gen, dtype=torch.int8)
    grid = torch.zeros((2, 14, 12 * prb), dtype=torch.complex64)
    grid = pcfich_put(grid, cfi, cell, conf["sf_idx"]) + pdcch_encode(
        bits, conf["rnti"], conf["dci_cce"], conf["dci_l"], cell, cfi,
        conf["sf_idx"])
    ref = dl_control.control_region(conf, bits.numpy())
    n = ref.shape[1]
    assert np.abs(grid[:, :n].numpy() - ref).max() < 1e-6
    assert (np.abs(ref) > 0).sum() == 2 * (16 + 36 * conf["dci_l"])
    assert not grid[:, n:].abs().any()


def test_uplink_reference_decodes_the_specification_waveform():
    """The uplink's plain reference decodes the benchmark's uplink
    transmitter (TS 36.211 5.5.2.1.1 DMRS with n_PN, 5.6 SC-FDMA) to the
    sent bits. The port's receiver does not (PERF.md, Open questions),
    so no uplink cell is in BENCHMARK.json."""
    from phybench.inputs import ul_pusch as tx
    from phybench.references import ul_pusch as ref

    conf = {"nof_prb": 6, "cell_id": 1, "sf_idx": 1, "rnti": 4660,
            "prb_start": 1, "n_prb": 4, "mcs": 20, "ack": [1, 0], "ri": 1,
            "max_iterations": 5}
    host = torch.Generator()
    host.manual_seed(7)
    payload = tx.uci_payload(conf, host)
    conf["tbs"] = tx.plan(conf, payload)[1].tbs
    gen = torch.Generator()
    gen.manual_seed(2**31 + 11)
    out = tx.transmit(conf, {"h": [0.95, 0.1], "n0": 1e-3}, payload, 3, gen,
                      "cpu")
    got = ref.receive(out["samples"].numpy(), conf, 1e-3,
                      len(payload["cqi_bits"]))
    assert got["crc"].all()
    assert (got["bits"] == out["tb"].numpy()).all()


def test_check_reads_missing_when_the_hook_is_gone(tiny_spec, monkeypatch):
    """A port whose receiver no longer calls the hooked function records
    no soft output: the gap reads MISSING and the cell fails."""
    from phybench.compare import MISSING
    from empower_srslte_tpu_torch.models import ue_dl

    drv = driver_for(tiny_spec, "t_dl")
    monkeypatch.setattr(drv, "hooks", lambda sink: [
        (ue_dl, "no_such_stage", lambda a, k, r: None)])
    assert drv.check()["gap.soft"] == MISSING


def _flip_first_bit(monkeypatch):
    """The fault ``an answer altered where it is produced``: the first
    decoded TB bit flipped in the DL-SCH decode's output, its CRC flag
    left as it was."""
    from empower_srslte_tpu_torch.models import pdsch

    inner = pdsch.dlsch_decode

    def faulty(*args, **kwargs):
        bits, ok, soft = inner(*args, **kwargs)
        bits = bits.clone()
        bits.view(-1, bits.shape[-1])[0, 0] ^= 1
        return bits, ok, soft

    monkeypatch.setattr(pdsch, "dlsch_decode", faulty)


def _half_batch(monkeypatch):
    """The fault ``half of the batch left out``: the receiver decodes the
    first half of its subframes and answers the rest with their
    answers."""
    from empower_srslte_tpu_torch.models import ue_dl

    inner = ue_dl.ue_dl_tm4_batch

    def faulty(samples, cfg, plan):
        h = samples.shape[0] // 2
        r = inner(samples[:h], cfg, plan)
        two = lambda x: torch.cat([x, x])
        return ue_dl.Tm4BatchResult(
            two(r.cfi), two(r.dci_hits), tuple(map(two, r.tb_bits)),
            tuple(map(two, r.crc_ok)), r.iterations)

    monkeypatch.setattr(ue_dl, "ue_dl_tm4_batch", faulty)


@pytest.mark.parametrize("fault", ["answer_altered", "half_batch"])
def test_faults_fail(tiny_spec, fault, monkeypatch):
    if fault == "answer_altered":
        _flip_first_bit(monkeypatch)
    else:
        _half_batch(monkeypatch)
    out = run_cell(tiny_spec, "t_dl", 2**31 + 9, 0.3, False, "cpu",
                   time.perf_counter())
    assert not out["correct"]
    assert out["checks"]["wrong_tbs"]["value"] > 0
    assert out["checks"]["diff.tb"]["value"] > 0


def test_gap_and_tb_diff():
    from phybench.compare import MISSING, gap, tb_diff

    ref = np.array([[1.0, -2.0], [4.0, 0.5]])
    assert gap(ref.copy(), ref) == 0.0
    assert gap(ref + np.array([[0.0, 0.4], [0.0, 0.0]]), ref) == \
        pytest.approx(0.1)
    assert gap(None, ref) == MISSING and gap(ref[:1], ref) == MISSING
    assert gap(ref * np.nan, ref) == MISSING
    bits = np.zeros((3, 5), np.uint8)
    ok = np.array([True, True, False])
    flipped = bits.copy()
    flipped[1, 4] = 1
    assert tb_diff(ok, bits, ok, bits) == 0
    assert tb_diff(ok, flipped, ok, bits) == 1
    # two failed blocks are one answer whatever their bits
    other = bits.copy()
    other[2] = 1
    assert tb_diff(ok, other, ok, bits) == 0
    assert tb_diff(~ok, bits, ok, bits) == 3
    assert tb_diff(ok[:2], bits[:2], ok, bits) == 3


def test_percentile_and_rate_use_every_call():
    lat = [0.001] * 94 + [0.005, 0.006, 0.007, 0.008, 0.009, 0.010]
    assert stats.p95(lat) == pytest.approx(np.percentile(lat, 95))
    assert stats.p95(lat) > 0.005
    assert stats.p95(lat[:94]) == pytest.approx(0.001)

    class Fake:
        n_calls = 3

        def __init__(self):
            self.calls, self.tallied = 0, 0

        def call(self, i):
            self.calls += 1
            time.sleep(0.002)
            return i

        def tally(self, i, res):
            self.tallied += 1

    fake = Fake()
    got, wall = measure(fake, 0.05)
    assert len(got) == fake.calls == fake.tallied and wall >= 0.05
    assert sum(got) <= wall

    from phybench.harness import Spec

    spec = Spec({})
    win = Window(got, wall, 1.5, {"bits": 10_000_000})
    assert spec.reader("end_to_end", "mbps").read(win) == \
        pytest.approx(10 / wall)
    assert spec.reader("end_to_end", "batch_p95_ms").read(win) == \
        pytest.approx(np.percentile(got, 95) * 1e3)
    assert spec.reader("end_to_end", "setup_s").read(win) == 1.5


def test_roofline_counts():
    assert roofline.OPS_PER_STEP == 101
    assert roofline.turbo_ops(5760, 1) == 2 * 5763 * 101
    assert roofline.turbo_ops(40, 4) == 4 * 2 * 43 * 101
    assert roofline.turbo_bytes(5760) == 3 * 5764 * 4 + 5760
    work = [(5760, 5120, 1, "bfloat16")]
    ops_s = 5120 * 2 * 5763 * 101 / 66.9e12
    bytes_s = 5120 * (3 * 5764 * 4 + 5760) / 3.35e12
    assert roofline.turbo_least_s(work) == pytest.approx(max(ops_s, bytes_s))
    # at four iterations the same code blocks are bound by operations
    work4 = [(5824, 1792, 4, "bfloat16")]
    assert roofline.turbo_least_s(work4) == pytest.approx(
        1792 * 4 * 2 * 5827 * 101 / 66.9e12)
    assert roofline.turbo_least_s([(5760, 10, 1, "float32")]) == \
        pytest.approx(max(10 * 2 * 5763 * 101 / 33.5e12,
                          10 * (3 * 5764 * 4 + 5760) / 3.35e12))


def test_turbo_work_from_segmentation(tiny_spec):
    drv = driver_for(tiny_spec, "t_dl")
    (k, n, dt), = drv.segments()
    assert (k, n, dt) == (3520, 1, "bfloat16")
    assert drv.turbo_work([2], 4) == [(3520, 8, 2, "bfloat16")]


def test_metric_file_dropped_in_is_read(tiny_spec, tmp_path):
    """A per-layer metric added as one file and one BENCHMARK.json entry,
    with no other edit, comes out of a traced run."""
    root = tmp_path / "readers"
    src = pathlib.Path(__file__).resolve().parent.parent
    for d in ("metrics", "end_to_end"):
        shutil.copytree(src / d, root / d)
    (root / "metrics" / "rx.ranges_seen.tput.py").write_text(
        "def read(trace, ctx):\n"
        "    return float(len({r[0] for r in trace.ranges}))\n")
    tiny_spec.root = root
    tiny_spec.bench["per_layer"].append(
        {"name": "rx.ranges_seen.tput", "unit": "count", "better": "higher",
         "source": "program_span", "layer": "receiver", "moves": "mbps"})
    out = run_cell(tiny_spec, "t_dl", 2**31 + 3, 0.0, True, "cpu",
                   time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["metrics"]["rx.ranges_seen.tput"]["value"] >= 8
    assert "front_end.host_ms.tput" in out["metrics"]
    # no device on the CPU: the device readers find nothing and say so
    assert "device.idle_share.tput" not in out["metrics"]
    assert "turbo_roofline" not in out["metrics"]
