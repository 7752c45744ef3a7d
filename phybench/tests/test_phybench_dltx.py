"""The transmitter cell's driver on the CPU at a tiny size (6 PRB, 2
subframes a call): the port's eNB downlink transmitter against the plain
reference ``references/dl_tx.py``, the control, the faults the check must
catch, and what the transmitter's per-layer metrics read."""

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
SEED = 2**31 + 53


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tx_spec(tmp_path):
    """A Spec of one tiny transmitter cell ``t_tx`` held to the limits of
    ``enb_dl_tm4_b256``, reporting the metrics that cell reports."""
    bench = json.loads((PHYBENCH.parent / "BENCHMARK.json").read_text())
    for d in ("configs", "traffic", "limits"):
        (tmp_path / d).mkdir()
    shutil.copy(HERE / "data" / "tiny_dltx.json", tmp_path / "configs")
    shutil.copy(HERE / "data" / "tiny_dltx_b2.json", tmp_path / "traffic")
    shutil.copy(PHYBENCH / "limits" / "enb_dl_tm4_b256.json",
                tmp_path / "limits" / "t_tx.json")
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            if "enb_dl_tm4_b256" in m.get("workloads", ()):
                m["workloads"] = ["t_tx"]
    bench["workloads"] = [{"name": "t_tx", "config": "tiny_dltx",
                           "traffic": "tiny_dltx_b2", "chips": 1}]
    return Spec(bench, data=tmp_path)


def _driver(spec, seed=SEED, **conf):
    from phybench.drivers.enb_dl_tx_batch import Driver

    cell = spec.cell("t_tx")
    return Driver(dict(spec.config(cell["config"]), **conf),
                  spec.traffic(cell["traffic"]), seed, "cpu")


def _run(spec, seconds=0.3, trace=False):
    return run_cell(spec, "t_tx", SEED, seconds, trace, "cpu",
                    time.perf_counter())


def test_port_agrees_with_reference(tx_spec):
    out = _run(tx_spec)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    checks = {k: v["value"] for k, v in out["checks"].items()}
    # complex64 against the reference's complex128: close, not equal
    assert 0 < checks["gap.samples"] < 1e-6, checks
    for name in ("diff.re", "replay", "wrong_tbs"):
        assert checks[name] == 0, checks
    assert set(out["metrics"]) == {"mbps", "batch_p95_ms", "setup_s"}


def test_control_fails(tx_spec):
    readings = _driver(tx_spec).check(lower=True)
    assert readings["gap.samples"] > tx_spec.limits("t_tx")["gap.samples"], \
        readings


@pytest.mark.parametrize("field,value", [("tbs", 3752), ("g", 4200),
                                         ("code_blocks", {"count": 2,
                                                          "k": 1760})])
def test_the_driver_refuses_another_grant(tx_spec, field, value):
    with pytest.raises(ValueError, match="the port's plan resolves"):
        _driver(tx_spec, **{field: value})


def test_a_flipped_coded_bit_is_an_re_apart(tx_spec, monkeypatch):
    """The fault ``a coded bit flipped where it is produced``: the first
    bit of the DL-SCH encoder's output, in every call."""
    from empower_srslte_tpu_torch.models import pdsch

    inner = pdsch.dlsch_encode

    def faulty(*args, **kwargs):
        out = inner(*args, **kwargs).clone()
        out.view(-1, out.shape[-1])[:, 0] ^= 1
        return out

    monkeypatch.setattr(pdsch, "dlsch_encode", faulty)
    out = _run(tx_spec, 0.1)
    assert not out["correct"]
    assert out["checks"]["diff.re"]["value"] > 0
    assert out["checks"]["wrong_tbs"]["value"] == 0


def test_a_missing_phich_is_an_re_apart(tx_spec, monkeypatch):
    """The fault ``the HARQ indicator left out``."""
    from empower_srslte_tpu_torch.models import phich

    monkeypatch.setattr(phich, "phich_put", lambda grid, *a, **k: grid)
    out = _run(tx_spec, 0.1)
    assert not out["correct"]
    # a group's 12 REs on each of the two ports, in every check row
    assert out["checks"]["diff.re"]["value"] == 2 * 12 * 2


def test_a_call_whose_output_differs_counts_wrong_tbs(tx_spec, monkeypatch):
    """The fault ``a later call's samples differ from the first's``: from
    the third call on, one sample of the first subframe moves."""
    from empower_srslte_tpu_torch.models import enb_dl

    inner, calls = enb_dl.enb_dl_tx_batch, []

    def faulty(*args, **kwargs):
        out = inner(*args, **kwargs)
        calls.append(1)
        if len(calls) > 2:
            out[0, 0, 100] += 1e-3
        return out

    monkeypatch.setattr(enb_dl, "enb_dl_tx_batch", faulty)
    out = _run(tx_spec, 0.1)
    assert not out["correct"]
    assert out["checks"]["wrong_tbs"]["value"] > 0


def test_traced_run_reads_the_transmitter_ranges(tx_spec):
    out = _run(tx_spec, 0.0, trace=True)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    for name in ("tx.glue_host_ms.dltx", "control_tx.host_ms.dltx",
                 "turbo_encode.host_ms.dltx", "sch_tx.host_ms.dltx",
                 "mapping.host_ms.dltx", "ofdm_tx.host_ms.dltx",
                 "tx.cold_events.dltx"):
        assert got[name]["value"] >= 0, name
    # no device on the CPU: the device readers find nothing and say so
    for name in ("tx.launches.dltx", "device.idle_share.dltx",
                 "turbo_encode.device_ms.dltx", "ofdm_tx.device_ms.dltx"):
        assert name not in got or got[name]["value"] == 0.0, name
