"""Fixtures of phybench's tests: a tiny spec for the CPU, and the card.

Run them from the repository root with
``python -m pytest -o addopts="" phybench/tests -q -p no:cacheprovider``;
on a card the tests marked ``card`` run too.
"""

from __future__ import annotations

import json
import pathlib
import shutil

import pytest

HERE = pathlib.Path(__file__).resolve().parent
PHYBENCH = HERE.parent
#: the tiny cells: (workload, configuration, the real cell whose limits
#: they are held to)
TINY = {"t_dl": ("tiny_dl", "dl_tm4_b256")}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    """Skips the test where there is no CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")


@pytest.fixture
def tiny_spec(tmp_path):
    """A Spec of a tiny CPU cell (6 PRB, 2 subframes a call), held to
    the limits of the real cells, reporting every end-to-end metric and
    every per-layer metric of BENCHMARK.json."""
    from phybench.harness import Spec

    bench = json.loads((PHYBENCH.parent / "BENCHMARK.json").read_text())
    for d in ("configs", "traffic", "limits"):
        (tmp_path / d).mkdir()
    shutil.copy(HERE / "data" / "tiny_b2.json", tmp_path / "traffic")
    workloads = []
    for name, (conf, real) in TINY.items():
        shutil.copy(HERE / "data" / f"{conf}.json", tmp_path / "configs")
        shutil.copy(PHYBENCH / "limits" / f"{real}.json",
                    tmp_path / "limits" / f"{name}.json")
        workloads.append({"name": name, "config": conf,
                          "traffic": "tiny_b2", "chips": 1})
    for section in ("end_to_end", "per_layer"):
        for m in bench[section]:
            m.pop("workloads", None)
            if m["name"].endswith(".tti"):
                m["name"] = None
        bench[section] = [m for m in bench[section] if m["name"]]
    bench["workloads"] = workloads
    return Spec(bench, data=tmp_path)
