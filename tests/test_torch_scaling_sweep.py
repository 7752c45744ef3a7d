"""The port's weak-scaling sweep (``empower_srslte_tpu_torch/tools/
scaling_sweep.py``) on the CPU: ``--cpu --max-devices 2 --reps 1`` at 25
PRB. At n = 1 and 2 the sharded step's CRC flags equal those of the JAX
tool's step (``tools/scaling_sweep.py``: ``jax.jit`` over TBs placed by
a ``NamedSharding`` on ``make_mesh(n)`` of the JAX package's virtual CPU
devices) on the same TBs; the mesh has n shards; the table and JSON
line are the tool's. Without a card and without ``--cpu`` the tool
raises."""

import ast
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from empower_srslte_tpu.models import ra as jra
from empower_srslte_tpu.models.pdsch import PdschConfig as JCfg
from empower_srslte_tpu.models.pdsch import pdsch_decode as jdecode
from empower_srslte_tpu.models.pdsch import pdsch_encode as jencode
from empower_srslte_tpu.ops.equalizer import MimoType as JMimo
from empower_srslte_tpu.parallel import make_mesh as jmake_mesh
from empower_srslte_tpu.utils.cell import Cell as JCell

from empower_srslte_tpu_torch.tools import scaling_sweep

PRB = 25


def _jax_crc(tbs_per_n):
    """The JAX tool's step at each n on its (carrier, sf) mesh of n CPU
    devices: -> [ok [carrier, sf]] per n."""
    cell = JCell(nof_prb=PRB, nof_ports=2, id=1)
    mod, tbs = jra.mcs_to_tbs(scaling_sweep.MCS, PRB)
    cfg = JCfg(cell=cell, sf_idx=1, cfi=1, mod=mod,
               mimo=JMimo.SPATIAL_MUX, nof_layers=2, nof_codewords=2, pmi=0)
    plan = cfg.plan(tbs, decoder_impl="xla")

    @jax.jit
    def step(tb_bits, tb2_bits):
        ports = jencode(tb_bits, cfg, plan, tb2_bits, plan)
        hm = jnp.asarray(scaling_sweep.HM, jnp.complex64)
        rx = jnp.einsum("rp,...psk->...rsk", hm, ports)
        h = jnp.broadcast_to(
            hm[:, :, None, None],
            (*tb_bits.shape[:-1], 2, 2, cell.nsymb_sf, cell.nof_re))
        _, (ok1, ok2), _ = jdecode(rx, h, cfg, plan,
                                   noise_est=scaling_sweep.NOISE_EST,
                                   plan2=plan)
        return jnp.logical_and(ok1, ok2)

    out = []
    for tb, tb2 in tbs_per_n:
        mesh = jmake_mesh(tb.shape[0] * tb.shape[1])
        shard = NamedSharding(mesh, P("carrier", "sf"))
        out.append(np.asarray(step(jax.device_put(jnp.asarray(tb), shard),
                                   jax.device_put(jnp.asarray(tb2), shard))))
    return out


def test_sweep_matches_the_jax_step(capsys):
    assert scaling_sweep.main(["--cpu", "--max-devices", "2", "--reps", "1",
                               "--prb", str(PRB)]) == 0
    lines = capsys.readouterr().out.splitlines()
    res = json.loads(lines[-1])
    assert lines[0].split() == ["devices", "mesh", "sf/step", "ms/step",
                                "sf/s", "Mbps"]
    rows = res["rows"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert [r["mesh"] for r in rows] == [[1, 1], [1, 2]]
    assert [r["shards"] for r in rows] == [1, 2]
    assert rows[1]["device_list"] == ["cpu", "cpu"]
    assert [ln.split()[:3] for ln in lines[1:3]] == [["1", "1x1", "1"],
                                                    ["2", "1x2", "2"]]
    _, tbs = jra.mcs_to_tbs(scaling_sweep.MCS, PRB)
    assert res["tbs"] == tbs and res["prb"] == PRB
    # the same TBs, drawn in the tool's order
    rng = np.random.default_rng(0)
    draws = [tuple(rng.integers(0, 2, size=(*r["mesh"], tbs))
                   .astype(np.int8) for _ in range(2)) for r in rows]
    for r, want in zip(rows, _jax_crc(draws)):
        np.testing.assert_array_equal(np.asarray(r["crc_ok"]), want)
        assert want.all()


def test_sweep_raises_on_a_failed_crc(monkeypatch):
    real = scaling_sweep.build_step

    def failing(prb):
        step, tbs = real(prb)
        return (lambda tb, tb2: step(tb, tb2) & False), tbs

    monkeypatch.setattr(scaling_sweep, "build_step", failing)
    with pytest.raises(RuntimeError, match="CRC failed at n=1"):
        scaling_sweep.sweep([torch.device("cpu")], max_devices=1, reps=1,
                            prb=6)


def test_tool_refuses_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        scaling_sweep.main(["--max-devices", "1", "--prb", "6"])


def test_tool_imports_nothing_of_jax():
    tree = ast.parse(pathlib.Path(scaling_sweep.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names
                if m.split(".")[0] in ("jax", "empower_srslte_tpu")]
