"""Port vs JAX reference: the host axis, across processes.

Mirrors ``tests/test_multihost.py``: the (host, carrier, sf) mesh shape
against JAX's ``make_mesh(hosts=)``, and the port's multi-process dry run
(``empower_srslte_tpu_torch/tools/multihost_dryrun.py``) with 2 OS
processes joined over gloo, the shards on the CPU: the no-genie chain
over all three axes with a cross-process sum, and the trellis-sharded NII
decode whose boundary exchange crosses the processes. Besides: a
one-process group (the host axis of size 1, JAX's ppermute to self), and
the rules that nothing falls back to the CPU unasked and that a backend
takes only its own tensors.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from empower_srslte_tpu.parallel import make_mesh as jax_make_mesh

from empower_srslte_tpu_torch.ops.fec.turbo_decoder import TurboDecoder
from empower_srslte_tpu_torch.ops.fec.turbo_encoder import turbo_encode
from empower_srslte_tpu_torch.parallel import (init_distributed,
                                               make_global_mesh, make_mesh,
                                               sp_turbo_decode_nii)
from empower_srslte_tpu_torch.parallel.turbo_sp import _pick_window
from empower_srslte_tpu_torch.tools import multihost_dryrun


def test_make_mesh_host_axis():
    m = make_mesh(8, hosts=2, devices=["cpu"] * 8)
    ref = jax_make_mesh(8, hosts=2)
    assert m.axis_names == ("host", "carrier", "sf") == ref.axis_names
    assert m.shape == dict(ref.shape) == {"host": 2, "carrier": 1, "sf": 4}


def test_multihost_dryrun_two_processes():
    # the tool's own deadline sits inside the outer one, so a slow box
    # ends with the tool killing its workers, not pytest killing the
    # launcher
    assert multihost_dryrun.DEADLINE_S < 300
    out = subprocess.run(
        [sys.executable, "-m", multihost_dryrun.MODULE, "2", "--cpu"],
        cwd=multihost_dryrun.ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert "MULTIHOST_OK" in out.stdout


def test_tool_needs_a_card_unless_told_cpu(monkeypatch):
    with pytest.raises(ValueError, match="NCCL"):
        multihost_dryrun.main(["2", "--cpu", "--backend", "nccl"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost_dryrun.main(["2"])


def test_init_distributed_needs_a_backend():
    with pytest.raises(ValueError, match="backend"):
        init_distributed("localhost:1", 1, 0)


def test_one_process_group(tmp_path):
    """A gloo group of one process: the host axis has size 1, so the ring
    shift, the gather and the sum return the shard's own tensors, and the
    sharded NII decode over it equals the one-device decode. A backend
    that cannot take a shard's tensors raises."""
    init_distributed(f"file://{tmp_path / 'store'}", 1, 0, backend="gloo")
    try:
        mesh = make_global_mesh(carriers=1, devices=["cpu"] * 2)
        assert mesh.shape == {"host": 1, "carrier": 1, "sf": 2}
        assert mesh.local() == [(0, 0, 0), (0, 0, 1)]
        comm = mesh.comm("host")
        xs = {c: torch.full((3,), float(c[2])) for c in mesh.local()}
        for out in (comm.shift(xs, 1), comm.all_gather(xs), comm.psum(xs)):
            assert all(torch.equal(out[c], xs[c]) for c in xs)

        k = 256
        u = torch.as_tensor(np.random.default_rng(3).integers(
            0, 2, (4, k)).astype(np.int8))
        llr = (1.0 - 2.0 * turbo_encode(u).to(torch.float32)) * 2.0 \
            + torch.randn((4, 3, k + 4), generator=torch.Generator()
                          .manual_seed(3))
        bits, soft = sp_turbo_decode_nii(llr, k, mesh, axis="host",
                                         iterations=2)
        ref_bits, ref_soft = TurboDecoder(
            k=k, iterations=2, window=_pick_window(k, 16), impl="nii",
            dtype="float32").decode(llr)
        assert torch.equal(bits, ref_bits) and torch.equal(soft, ref_soft)

        comm.backend = "nccl"
        with pytest.raises(ValueError, match="NCCL takes CUDA tensors"):
            comm._wire(torch.zeros(3))
    finally:
        dist.destroy_process_group()
