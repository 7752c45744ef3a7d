"""Package rules of the PyTorch port: it never imports JAX or the JAX
package, its entry points default to the CUDA card and refuse to fall
back to the CPU, every module imports without a card or a CUDA compiler,
and ``convert.py`` carries the JAX package's configuration and HARQ
softbuffers across."""

import ast
import importlib
import pathlib
import pkgutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import empower_srslte_tpu_torch
from empower_srslte_tpu_torch import convert

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "empower_srslte_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "empower_srslte_tpu"}


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_never_imports_jax(path):
    bad = FORBIDDEN & set(_imported_roots(path))
    assert not bad, f"{path.name} imports {sorted(bad)}"


def test_every_module_imports_without_a_card():
    names = [m.name for m in pkgutil.walk_packages(
        empower_srslte_tpu_torch.__path__, "empower_srslte_tpu_torch.")]
    assert len(names) >= 25
    for name in names:
        importlib.import_module(name)


def test_entry_points_refuse_to_fall_back(monkeypatch):
    from empower_srslte_tpu_torch.models.enb_dl import (enb_dl_base_grid,
                                                        tm4_stimulus)
    from empower_srslte_tpu_torch.utils.cell import Cell
    from empower_srslte_tpu_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        enb_dl_base_grid(Cell(nof_prb=6, nof_ports=2, id=1), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm4_stimulus(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.softbuffers_from_numpy([np.zeros(8, np.float32)])
    grid = enb_dl_base_grid(Cell(nof_prb=6, nof_ports=2, id=1), 1,
                            device="cpu")
    assert grid.device.type == "cpu" and grid.shape == (2, 14, 72)


def test_convert_round_trips_plan_and_softbuffers(rng):
    """A JAX DlschPlan and the softbuffers of a failed JAX decode carry
    into the port, whose HARQ-combined decode then agrees with the JAX
    package's."""
    from empower_srslte_tpu.models.sch import DlschPlan as JPlan
    from empower_srslte_tpu.models.sch import dlsch_decode as jax_decode
    from empower_srslte_tpu.models.sch import dlsch_encode as jax_encode

    from empower_srslte_tpu_torch.models.sch import dlsch_decode

    jplan = JPlan(tbs=328, g=1200, qm=2, max_iterations=4)
    plan = convert.dlsch_plan_from_fields(vars(jplan))
    assert JPlan(**convert.plan_fields(plan)) == jplan
    assert plan.cb_plans == jplan.cb_plans

    tb = rng.integers(0, 2, size=(2, jplan.tbs)).astype(np.int8)
    coded = np.asarray(jax_encode(jnp.asarray(tb), jplan)).astype(np.float32)
    clean = 1.0 - 2.0 * coded
    first = (0.5 * clean + rng.normal(size=coded.shape)).astype(np.float32)
    second = (0.8 * clean + rng.normal(size=coded.shape)).astype(np.float32)

    _b, ok_j, soft_j = jax_decode(jnp.asarray(first), jplan)
    soft_np = [np.asarray(s) for s in soft_j]
    soft = convert.softbuffers_from_numpy(soft_np, device="cpu")
    for s, n in zip(convert.softbuffers_to_numpy(soft), soft_np):
        np.testing.assert_array_equal(s, n)

    bits_j, ok2_j, new_j = jax_decode(jnp.asarray(second), jplan,
                                      softbuffers=soft_j)
    bits, ok2, new = dlsch_decode(torch.as_tensor(second), plan,
                                  softbuffers=soft)
    np.testing.assert_array_equal(ok2.numpy(), np.asarray(ok2_j))
    assert ok2.all()
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_j))
    np.testing.assert_array_equal(bits.numpy(), tb)
    for a, b in zip(new, new_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
