"""The TM2 cell on the CPU at a tiny size: the 4-port transmit-diversity
receiver (``ue_dl_tm2_batch``, through the port's plain twins) against
the plain reference, the control, the readers of its traced calls, and
the faults the check must catch: a decoded bit flipped, the DL-SCH's E
split on N_L 1 put back, and the PDCCH combined as 2-port SFBC on ports 0
and 1 put back."""

from __future__ import annotations

import json
import shutil
import time

import pytest
import torch

from phybench.harness import Spec, run_cell

from .conftest import HERE, PHYBENCH

CELL = "dl_tm2_4p_b256"


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tm2_spec(tmp_path):
    """A Spec of the tiny TM2 cell (25 PRB, 4 ports, 2 rx, 3 code blocks
    whose E differ between N_L 1 and 2; 2 subframes a call) under the
    real cell's limits, reporting the cell's metrics."""
    bench = json.loads((PHYBENCH.parent / "BENCHMARK.json").read_text())
    for d in ("configs", "traffic", "limits"):
        (tmp_path / d).mkdir()
    shutil.copy(HERE / "data" / "tiny_tm2.json", tmp_path / "configs")
    shutil.copy(HERE / "data" / "tiny_b2.json", tmp_path / "traffic")
    shutil.copy(PHYBENCH / "limits" / f"{CELL}.json",
                tmp_path / "limits" / "t_tm2.json")
    for section in ("end_to_end", "per_layer"):
        bench[section] = [m for m in bench[section]
                          if CELL in m.get("workloads", [CELL])]
        for m in bench[section]:
            m.pop("workloads", None)
    bench["workloads"] = [{"name": "t_tm2", "config": "tiny_tm2",
                           "traffic": "tiny_b2", "chips": 1}]
    return Spec(bench, data=tmp_path)


def _driver(spec, seed=2**31 + 17):
    from phybench.drivers.ue_dl_tm2_batch import Driver

    cell = spec.cell("t_tm2")
    return Driver(spec.config(cell["config"]), spec.traffic(cell["traffic"]),
                  seed, "cpu")


def _run(spec, seed=2**31 + 9, trace=False):
    return run_cell(spec, "t_tm2", seed, 0.3, trace, "cpu",
                    time.perf_counter())


def test_port_agrees_with_reference(tm2_spec):
    out = _run(tm2_spec)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    checks = {k: v["value"] for k, v in out["checks"].items()}
    assert 0 < checks["gap.soft"] < 1e-5, checks
    assert {"mbps", "setup_s", "batch_p95_ms"} <= set(out["metrics"])


def test_control_fails(tm2_spec):
    readings = _driver(tm2_spec).check(lower=True)
    assert readings["gap.soft"] > tm2_spec.limits("t_tm2")["gap.soft"]


def test_traced_readers(tm2_spec):
    """A traced run reads the TM2 receiver's root and stage ranges; the
    device readers find nothing on the CPU and say so."""
    out = _run(tm2_spec, trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in ("rx.glue_host_ms.tm2", "front_end.host_ms.tm2",
                 "control.host_ms.tm2", "shared_channel.host_ms.tm2",
                 "sch.host_ms.tm2", "sch.read_wait_ms.tm2",
                 "rx.cold_events.tm2"):
        assert got[name]["value"] >= 0, name
    assert "device.idle_share.tm2" not in got
    assert "turbo_roofline.tm2" not in got


def test_fault_bit_flipped(tm2_spec, monkeypatch):
    """The first decoded TB bit flipped in the DL-SCH decode's output, its
    CRC flag left as it was."""
    from empower_srslte_tpu_torch.models import pdsch

    inner = pdsch.dlsch_decode

    def faulty(*args, **kwargs):
        bits, ok, soft = inner(*args, **kwargs)
        bits = bits.clone()
        bits.view(-1, bits.shape[-1])[0, 0] ^= 1
        return bits, ok, soft

    monkeypatch.setattr(pdsch, "dlsch_decode", faulty)
    out = _run(tm2_spec)
    assert not out["correct"]
    assert out["checks"]["wrong_tbs"]["value"] > 0
    assert out["checks"]["diff.tb"]["value"] > 0


def test_fault_e_split_on_one_layer(tm2_spec, monkeypatch):
    """The port's E split back on N_L 1: the driver refuses to start on
    the stated E, and a port that ran so anyway de-rate-matches the later
    code blocks from other bits than were sent: the check fails."""
    from empower_srslte_tpu_torch.models.pdsch import PdschConfig

    drv = _driver(tm2_spec)
    stated = tuple(drv.conf["code_blocks"]["e"])
    monkeypatch.setattr(PdschConfig, "split_layers", property(lambda s: 1))
    with pytest.raises(ValueError, match="code blocks' E"):
        _driver(tm2_spec)
    drv.plan = drv.cfg.plan(drv.tbs,
                            max_iterations=drv.conf["max_iterations"])
    assert tuple(drv.plan.e_sizes) != stated
    got = drv.check()
    assert got["diff.tb"] > 0, got
    assert got["gap.soft"] > tm2_spec.limits("t_tm2")["gap.soft"], got


def test_fault_two_port_pdcch(tm2_spec, monkeypatch):
    """The PDCCH region combined as 2-port SFBC on ports 0 and 1 of the
    4-port channel, as the port did before: no DCI is found."""
    from empower_srslte_tpu_torch.models import pdcch

    inner = pdcch.combine_diversity

    def sfbc_on_two(y, h, noise_est=0.0):
        if h.dim() == y.dim() + 1 and h.shape[-2] == 4:
            h = h[..., :2, :]
        return inner(y, h, noise_est)

    monkeypatch.setattr(pdcch, "combine_diversity", sfbc_on_two)
    out = _run(tm2_spec)
    assert not out["correct"]
    assert out["checks"]["dci_missed"]["value"] > 0
