"""Port vs JAX reference: the recursion-rate probe of
tools/microbench_vpu.py.

The JAX side runs the tool's Pallas kernel in interpret mode on the CPU;
the port side runs the kernel's plain twin ``recursion_plain``. Adds,
maxes and subtractions of the same values in the same order round the
same way in every type, so the results must be bit-identical.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from empower_srslte_tpu_torch.runtime import trace
from empower_srslte_tpu_torch.tools import microbench_recursion as mr

ROOT = pathlib.Path(__file__).resolve().parent.parent
STEPS = 64


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "microbench_vpu", ROOT / "tools" / "microbench_vpu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["f32", "bf16", "int8"])
def test_recursion_plain_matches_pallas(name):
    tool = _jax_tool()
    x = mr.probe_input(name, 128, device="cpu", seed=3)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16, "int8": jnp.int8}[name]
    xj = jnp.asarray(x.to(torch.float32).numpy()).astype(jdt)
    fn = pl.pallas_call(tool.make_kernel(STEPS, 8),
                        out_shape=jax.ShapeDtypeStruct(xj.shape, jdt),
                        interpret=True)
    want = np.asarray(jax.jit(fn)(xj).astype(jnp.float32))
    got = mr.recursion_probe(x, STEPS)
    assert got.dtype == x.dtype and got.shape == x.shape
    np.testing.assert_array_equal(got.to(torch.float32).numpy(), want)


def test_probe_wrapper_on_cpu_counts_no_launch():
    x = mr.probe_input("f32", 16, device="cpu")
    before = trace.launch_counts()
    assert torch.equal(mr.recursion_probe(x, 4), mr.recursion_plain(x, 4))
    assert trace.launch_counts() == before
    out = mr.run(steps=2, lanes=4, device="cpu")
    assert [r["type"] for r in out] == ["f32", "bf16", "int8"]
    assert all(r["ms"] is None and r["ops"] == 2 * 39 * r["sub"] * 4
               for r in out)
