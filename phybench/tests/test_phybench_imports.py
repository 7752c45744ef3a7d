"""What phybench imports: never JAX or the JAX package, and, in the
transmitters and the reference, nothing of the port."""

from __future__ import annotations

import ast
import json
import pathlib
import subprocess
import sys

import pytest

PHYBENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = PHYBENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "empower_srslte_tpu"}
PORT = "empower_srslte_tpu_torch"
#: folders and files whose modules must not import the port, and the
#: phybench modules each may import: the reference nothing but itself,
#: the transmitters the frozen copy
PLAIN = {"references": ("phybench.references",),
         "inputs": ("phybench.frozen",),
         "frozen": ("phybench.frozen",),
         "compare.py": (), "roofline.py": (), "stats.py": (),
         "observe.py": ()}


def plain_part(path: pathlib.Path) -> str | None:
    rel = path.relative_to(PHYBENCH).parts
    return rel[0] if rel[0] in PLAIN else None


def modules():
    return sorted(p for p in PHYBENCH.rglob("*.py")
                  if "tests" not in p.relative_to(PHYBENCH).parts)


def top_names(path: pathlib.Path) -> set:
    """Top-level names of every absolute import in ``path``, and the
    phybench module each relative import resolves to."""
    rel = path.relative_to(ROOT).with_suffix("").parts
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                names.add(node.module.split(".")[0])
            else:
                base = rel[:len(rel) - node.level]
                names.add(".".join(base + ((node.module,)
                                           if node.module else ())))
    return names


@pytest.mark.parametrize("path", modules(), ids=lambda p: str(
    p.relative_to(PHYBENCH)))
def test_no_jax(path):
    bad = {n for n in top_names(path) if n.split(".")[0] in FORBIDDEN}
    assert not bad, bad


def test_whole_name_comparison():
    """The port's name begins with the JAX package's: only a whole
    top-level name counts."""
    assert PORT.split(".")[0] not in FORBIDDEN
    assert any(PORT in top_names(p) for p in modules())


@pytest.mark.parametrize("path", [p for p in modules() if plain_part(p)],
                         ids=lambda p: str(p.relative_to(PHYBENCH)))
def test_reference_and_transmitter_import_nothing_of_the_port(path):
    """The reference imports nothing of the port and nothing of the
    frozen copy of it; the transmitters nothing of the port."""
    names = top_names(path)
    assert PORT not in names
    inside = {n for n in names if n.startswith("phybench")}
    allowed = PLAIN[plain_part(path)]
    assert all(n.startswith(allowed) for n in inside), inside


def test_no_jax_loaded_after_a_run(tmp_path):
    """A tiny run on the CPU, in a process of its own, loads none of
    the forbidden modules."""
    code = f"""
import json, sys, time, pathlib
sys.path.insert(0, {str(ROOT)!r})
from phybench.tests.conftest import TINY
from phybench.harness import Spec, run_cell
from phybench.run import forbidden_modules
import shutil
data = pathlib.Path({str(tmp_path)!r})
here = pathlib.Path({str(PHYBENCH / 'tests')!r})
for d in ('configs', 'traffic', 'limits'):
    (data / d).mkdir(exist_ok=True)
shutil.copy(here / 'data' / 'tiny_dl.json', data / 'configs')
shutil.copy(here / 'data' / 'tiny_b2.json', data / 'traffic')
(data / 'limits' / 't.json').write_text('{{}}')
bench = {{"workloads": [{{"name": "t", "config": "tiny_dl",
          "traffic": "tiny_b2", "chips": 1}}],
          "end_to_end": [], "per_layer": []}}
run_cell(Spec(bench, data=data), 't', 1, 0.1, False, 'cpu',
         time.perf_counter())
print(json.dumps(forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
