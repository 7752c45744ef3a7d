"""The uplink cell's driver on the CPU at a tiny size (6 PRB, a 4-PRB
grant, 2 subframes a call): the port's eNB PUSCH-with-UCI receiver
through its plain twins against the plain reference, the control, the
window's UCI counts, a UCI answer altered, and what the uplink's
per-layer metrics read."""

from __future__ import annotations

import json
import pathlib
import shutil
import time

import pytest
import torch

from phybench.harness import Spec, run_cell

HERE = pathlib.Path(__file__).resolve().parent
PHYBENCH = HERE.parent
SEED = 2**31 + 29


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def ul_spec(tmp_path):
    """A Spec of one tiny uplink cell ``t_ul`` held to the limits of
    ``ul_pusch_b256``, reporting the metrics that cell reports."""
    bench = json.loads((PHYBENCH.parent / "BENCHMARK.json").read_text())
    for d in ("configs", "traffic", "limits"):
        (tmp_path / d).mkdir()
    shutil.copy(HERE / "data" / "tiny_ul.json", tmp_path / "configs")
    shutil.copy(HERE / "data" / "tiny_ul_b2.json", tmp_path / "traffic")
    shutil.copy(PHYBENCH / "limits" / "ul_pusch_b256.json",
                tmp_path / "limits" / "t_ul.json")
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            if "ul_pusch_b256" in m.get("workloads", ()):
                m["workloads"] = ["t_ul"]
    bench["workloads"] = [{"name": "t_ul", "config": "tiny_ul",
                           "traffic": "tiny_ul_b2", "chips": 1}]
    return Spec(bench, data=tmp_path)


def _driver(spec, seed=SEED):
    from phybench.drivers.enb_ul_pusch_batch import Driver

    cell = spec.cell("t_ul")
    return Driver(spec.config(cell["config"]), spec.traffic(cell["traffic"]),
                  seed, "cpu")


def test_port_agrees_with_reference(ul_spec):
    out = run_cell(ul_spec, "t_ul", SEED, 0.3, False, "cpu",
                   time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert 0 < checks["gap.soft"] < 1e-5, checks
    for name in ("diff.tb", "replay", "wrong_tbs", "ack_wrong", "ri_wrong",
                 "cqi_wrong"):
        assert checks[name] == 0, checks
    assert set(out["metrics"]) == {"mbps", "batch_p95_ms", "setup_s"}


def test_control_fails(ul_spec):
    readings = _driver(ul_spec).check(lower=True)
    assert readings["gap.soft"] > ul_spec.limits("t_ul")["gap.soft"], \
        readings


def test_the_driver_refuses_another_tbs(ul_spec):
    cell = ul_spec.cell("t_ul")
    conf = dict(ul_spec.config(cell["config"]), tbs=1800)
    from phybench.drivers.enb_ul_pusch_batch import Driver

    with pytest.raises(ValueError, match="TBS 1800 stated"):
        Driver(conf, ul_spec.traffic(cell["traffic"]), SEED, "cpu")


@pytest.mark.parametrize("field", ["ack", "ri", "cqi"])
def test_a_wrong_uci_answer_is_counted(ul_spec, monkeypatch, field):
    """The fault ``a UCI answer altered where it is produced``: the first
    subframe's HARQ-ACK, RI or CQI bit flipped in the receiver's result."""
    from empower_srslte_tpu_torch.models import ue_ul

    inner = ue_ul.pusch_decode_uci

    def faulty(*args, **kwargs):
        out = dict(inner(*args, **kwargs))
        if field == "ack":
            first = out["ack"][0].clone()
            first[0] ^= 1
            out["ack"] = (first,) + tuple(out["ack"][1:])
        elif field == "ri":
            out["ri"] = out["ri"].clone()
            out["ri"][0] ^= 1
        else:
            out["cqi_bits"] = out["cqi_bits"].clone()
            out["cqi_bits"][0, 0] ^= 1
        return out

    monkeypatch.setattr(ue_ul, "pusch_decode_uci", faulty)
    out = run_cell(ul_spec, "t_ul", SEED, 0.2, False, "cpu",
                   time.perf_counter())
    assert not out["correct"]
    assert out["checks"][f"{field}_wrong"]["value"] > 0


def test_traced_run_reads_the_uplink_ranges(ul_spec):
    out = run_cell(ul_spec, "t_ul", SEED, 0.0, True, "cpu",
                   time.perf_counter())
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in ("rx.glue_host_ms.ul", "front_end.host_ms.ul",
                 "shared_channel.host_ms.ul", "uci.host_ms.ul",
                 "sch.host_ms.ul", "sch.read_wait_ms.ul"):
        assert got[name]["value"] >= 0, name
    # no device on the CPU: the device readers find nothing and say so
    for name in ("rx.launches.ul", "device.idle_share.ul",
                 "turbo_win_roofline", "sch.device_ms.ul"):
        assert name not in got or got[name]["value"] == 0.0, name
