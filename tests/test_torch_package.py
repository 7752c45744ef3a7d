"""Package rules of the PyTorch port: it never imports JAX or the JAX
package, its entry points default to the CUDA card and refuse to fall
back to the CPU, every module imports without a card or a CUDA compiler,
the protocol layers it copies from the JAX package equal their originals
(``ast.dump``) but for the named repairs, and ``convert.py`` carries the
JAX package's configuration and HARQ softbuffers across."""

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


def _attributes(path: pathlib.Path):
    """(name, is a store) of every name and attribute in ``path``."""
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Name):
            yield node.id, isinstance(node.ctx, ast.Store)
        elif isinstance(node, ast.Attribute):
            yield node.attr, isinstance(node.ctx, ast.Store)


def test_kernels_launch_through_one_declared_launcher():
    """Only ``utils/cuda_build.py`` (the kernels' ``Kernel``) and
    ``runtime/`` (the ring buffer) declare a C function's ``argtypes``;
    neither the port nor its tests keep or read a ``LAUNCHES*`` counter
    beside the launch registry."""
    pkg = ROOT / "empower_srslte_tpu_torch"
    declares = [str(path.relative_to(ROOT)) for path in PORT_FILES
                if path.is_relative_to(pkg)
                and path != pkg / "utils" / "cuda_build.py"
                and not path.is_relative_to(pkg / "runtime")
                and ("argtypes", True) in set(_attributes(path))]
    assert declares == []
    counters = [str(path.relative_to(ROOT)) for path in
                PORT_FILES + sorted((ROOT / "tests").glob("*torch*.py"))
                if any(name.lstrip("_").startswith("LAUNCHES")
                       for name, _store in _attributes(path))]
    assert counters == []


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


def test_stack_entry_points_refuse_to_fall_back(monkeypatch):
    """``EnbStack``, ``UeStack`` and ``lte_attach`` run the PHY on the card
    unless asked for the CPU, and raise without one."""
    from empower_srslte_tpu_torch.apps import lte_attach
    from empower_srslte_tpu_torch.epc import Hss
    from empower_srslte_tpu_torch.epc.mme import Mme, UeNas
    from empower_srslte_tpu_torch.stack import EnbStack, UeStack
    from empower_srslte_tpu_torch.utils.cell import Cell

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cell = Cell(nof_prb=25, id=1)
    nas = UeNas(imsi="001010123456789", key=bytes(16), opc=bytes(16))
    with pytest.raises(RuntimeError, match="CUDA"):
        EnbStack(cell, Mme(Hss()))
    with pytest.raises(RuntimeError, match="CUDA"):
        UeStack(cell, nas)
    with pytest.raises(RuntimeError, match="CUDA"):
        lte_attach.main([])
    assert EnbStack(cell, Mme(Hss()), device="cpu").device.type == "cpu"
    assert UeStack(cell, nas, device="cpu").device.type == "cpu"


#: modules the port copies from the JAX package (relative imports, so
#: the copies' imports stay as they are)
COPIES = [f"{pkg}/{m}.py" for pkg, mods in (
    ("upper", ("__init__", "gtpu", "pdcp", "rlc", "security")),
    ("mac", ("__init__", "pdu", "procs", "harq", "bcch", "scheduler", "ran",
             "scheduler_ran", "agent")),
    ("rrc", ("__init__", "per", "schema", "messages", "procedures")),
    ("epc", ("__init__", "hss", "nas", "gtpc", "spgw", "mme", "mbms_gw")),
    ("s1ap", ("__init__", "per", "messages", "procedures", "transport")),
    ("runtime", ("logging", "tun", "io", "metrics", "crash", "config",
                 "libconf", "pcap", "rf")),
    ("utils", ("band",)),
    ("stack", ("__init__", "params", "air", "si", "mbms")),
) for m in mods]
#: the only methods a copy changes: repairs of reference faults
REPAIRS = {"runtime/tun.py": ("NetNs", "__init__"),
           "s1ap/procedures.py": ("MmeS1ap", "_nas_response")}


def _tree(path: pathlib.Path) -> ast.Module:
    """The module's AST with any absolute import of the JAX package
    renamed to the port's."""
    tree = ast.parse(path.read_text(), filename=str(path))
    jax_pkg, port_pkg = "empower_srslte_tpu", "empower_srslte_tpu_torch"
    for node in ast.walk(tree):
        names = ([node] if isinstance(node, ast.ImportFrom) and node.module
                 else node.names if isinstance(node, ast.Import) else [])
        for n in names:
            attr = "module" if isinstance(n, ast.ImportFrom) else "name"
            v = getattr(n, attr)
            if v == jax_pkg or v.startswith(jax_pkg + "."):
                setattr(n, attr, port_pkg + v[len(jax_pkg):])
    return tree


def _method(tree: ast.Module, cls: str, name: str) -> ast.FunctionDef:
    return next(f for c in tree.body if isinstance(c, ast.ClassDef)
                and c.name == cls for f in c.body
                if isinstance(f, ast.FunctionDef) and f.name == name)


def _pair(rel: str):
    return (_tree(ROOT / "empower_srslte_tpu_torch" / rel),
            _tree(ROOT / "empower_srslte_tpu" / rel))


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_the_jax_module(rel):
    """Each copy's AST equals its JAX module's, the repaired methods of
    ``REPAIRS`` taken out of both."""
    port, ref = _pair(rel)
    if rel in REPAIRS:
        for tree in (port, ref):
            cls = next(c for c in tree.body if isinstance(c, ast.ClassDef)
                       and c.name == REPAIRS[rel][0])
            cls.body.remove(_method(tree, *REPAIRS[rel]))
    assert ast.dump(port) == ast.dump(ref)


def test_netns_repair_deletes_a_stale_namespace_first():
    """``NetNs.__init__`` is JAX's plus one statement before ``ip netns
    add``: delete a namespace of that name left by an earlier run."""
    port, ref = (_method(t, *REPAIRS["runtime/tun.py"])
                 for t in _pair("runtime/tun.py"))
    repair = port.body.pop(1)
    assert ast.unparse(repair) == ("subprocess.run(['ip', 'netns', 'del', "
                                   "name], capture_output=True)")
    assert "'add'" in ast.unparse(port.body[1])
    assert ast.dump(port) == ast.dump(ref)


def test_s1ap_repair_advertises_the_sessions_teid(monkeypatch):
    """``MmeS1ap`` puts the attach's SP-GW TEID in the E-RAB of its
    InitialContextSetupRequest (JAX looks for a ``sessions`` table the
    SP-GW does not have and sends TEID 0, which the SP-GW drops)."""
    import empower_srslte_tpu_torch.s1ap.procedures as P
    from empower_srslte_tpu_torch.epc import Hss
    from empower_srslte_tpu_torch.epc.mme import Mme

    port, ref = (_method(t, *REPAIRS["s1ap/procedures.py"])
                 for t in _pair("s1ap/procedures.py"))
    assert "spgw.sessions" in ast.unparse(ref)
    assert "spgw.sessions" not in ast.unparse(port)

    class Ctx:
        pending_ctx_setup, kasme, spgw_teid = True, bytes(32), 7

    mme = Mme(Hss())
    mme.handle_ul_nas = lambda pdu: b"\x07\x42"
    mme.last_ctx = Ctx()
    sent = {}
    monkeypatch.setattr(P.S, "pack_initial_context_setup_request",
                        lambda *a, **kw: sent.update(kw) or b"")
    P.MmeS1ap(mme=mme)._nas_response(1, b"\x00")
    assert sent["teid"] == 7


def test_runtime_exports_a_subset_of_the_jax_runtime():
    """The port's runtime exports the JAX runtime's names, all of them
    (a subset that is the whole set), each its own object."""
    import empower_srslte_tpu.runtime as jax_runtime

    import empower_srslte_tpu_torch.runtime as runtime

    assert runtime.__all__ == jax_runtime.__all__
    for name in runtime.__all__:
        assert getattr(runtime, name) is not getattr(jax_runtime, name)
        assert getattr(runtime, name).__module__.startswith(
            "empower_srslte_tpu_torch.")


def test_ring_buffer_source_is_the_jax_packages():
    """The port builds its own copy of the native ring buffer, byte for
    byte the JAX package's ``native/ring_buffer.cpp``."""
    assert ((ROOT / "empower_srslte_tpu_torch" / "csrc" / "ring_buffer.cpp")
            .read_bytes() == (ROOT / "native" / "ring_buffer.cpp")
            .read_bytes())


@pytest.mark.parametrize("app", ["pdsch_enodeb", "pdsch_ue", "cell_search",
                                 "cell_measurement"])
def test_phy_apps_refuse_to_fall_back(app, monkeypatch, tmp_path):
    """Each PHY app runs on the card unless given ``--cpu``, and raises
    without one before it reads or writes a capture."""
    mod = importlib.import_module(f"empower_srslte_tpu_torch.apps.{app}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = tmp_path / "iq.bin"
    io_flag = ["-o", str(path)] if app == "pdsch_enodeb" else ["-i", str(path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([*io_flag, "-p", "6"])
    assert not path.exists()
    if app == "pdsch_enodeb":
        assert mod.main([*io_flag, "-p", "6", "-f", "1", "--cpu"]) == 0
        assert path.stat().st_size == 10 * 1920 * 8


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
