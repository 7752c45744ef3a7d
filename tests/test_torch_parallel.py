"""Port vs JAX reference: the multi-device layer (``parallel/``) on CPU
meshes, case by case as ``tests/test_parallel.py`` holds the JAX package.

The port's meshes here are lists of the CPU device (``["cpu"] * n``: a
mesh of more shards than devices is built only from such a list); the
JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``, its
NII kernel in interpret mode. The trellis-sharded NII decode runs the
kernel's plain twin per shard: bits must equal JAX's exactly and its
LLRs within rtol = atol = 1e-4 (JAX's interpret-mode kernel and the torch
twin round a few float32 adds differently over 3 iterations), and the
decode must be bit-identical to the port's own one-device NII decode at
the same window, whose per-window arithmetic the shards repeat. The plain
windowed sweep with halos is held to JAX's at 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

from empower_srslte_tpu.ops.fec.turbo_decoder import (
    _windowed_map_decode as jax_windowed_map_decode)
from empower_srslte_tpu.ops.fec.turbo_encoder import turbo_encode_np
from empower_srslte_tpu.parallel import make_mesh as jax_make_mesh
from empower_srslte_tpu.parallel import shard_batch as jax_shard_batch
from empower_srslte_tpu.parallel import sp_turbo_decode as jax_sp_decode
from empower_srslte_tpu.parallel.turbo_sp import (
    sp_turbo_decode_nii as jax_sp_decode_nii)
from empower_srslte_tpu.parallel.validate import (
    build_uedl_mini as jax_build_uedl_mini)

from empower_srslte_tpu_torch.ops.fec.convcoder import (conv_encode,
                                                         viterbi_decode)
from empower_srslte_tpu_torch.ops.fec.turbo_decoder import (
    TurboDecoder, _windowed_map_decode)
from empower_srslte_tpu_torch.parallel import (make_mesh, shard_batch,
                                               sp_turbo_decode,
                                               sp_turbo_decode_nii)
from empower_srslte_tpu_torch.parallel.mesh import (Mesh, Sharded, Sharding,
                                                    smap)
from empower_srslte_tpu_torch.parallel.turbo_sp import _pick_window
from empower_srslte_tpu_torch.parallel.validate import build_uedl_mini

CPU8 = ["cpu"] * 8


def _cpu_mesh(n: int) -> Mesh:
    return Mesh(["cpu"] * n, ("sf",))


def _jax_mesh(n: int) -> JaxMesh:
    return JaxMesh(np.asarray(jax.devices()[:n]), axis_names=("sf",))


class TestMesh:
    def test_make_mesh_shapes(self):
        for kw in ({}, {"carriers": 4}, {"carriers": 1}):
            m = make_mesh(8, devices=CPU8, **kw)
            ref = jax_make_mesh(8, **kw)
            assert m.axis_names == ref.axis_names
            assert m.shape == dict(ref.shape)
        assert make_mesh(8, devices=CPU8).shape == {"carrier": 2, "sf": 4}
        assert make_mesh(8, carriers=4, devices=CPU8).shape == {
            "carrier": 4, "sf": 2}

    def test_make_mesh_never_pads_or_falls_back(self, monkeypatch):
        with pytest.raises(ValueError, match="devices list"):
            make_mesh(8, devices=["cpu"] * 4)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(2)

    def test_shard_batch_placement(self, rng):
        """Each shard holds the block JAX puts on the device at the same
        mesh coordinate, on its own device."""
        x = rng.normal(size=(2, 4, 64)).astype(np.float32)
        m = make_mesh(8, carriers=2, devices=CPU8)
        xs = shard_batch(m, torch.as_tensor(x))
        assert len(xs.shards) == 8
        assert all(s.shape == (1, 1, 64) and s.device.type == "cpu"
                   for s in xs.shards.values())
        ref_mesh = jax_make_mesh(8, carriers=2)
        ref = jax_shard_batch(ref_mesh, jnp.asarray(x))
        assert len(ref.sharding.device_set) == 8
        for shard in ref.addressable_shards:
            coord = tuple(int(v[0]) for v in np.nonzero(
                ref_mesh.devices == shard.device))
            np.testing.assert_array_equal(xs.shards[coord].numpy(),
                                          np.asarray(shard.data))
        torch.testing.assert_close(xs.gather(), torch.as_tensor(x),
                                   rtol=0, atol=0)

    def test_sharded_computation_correct(self, rng):
        x = rng.normal(size=(2, 4, 128)).astype(np.float32)
        m = make_mesh(8, carriers=2, devices=CPU8)
        out = smap(lambda v: torch.sum(v * 2, dim=-1),
                   shard_batch(m, torch.as_tensor(x)),
                   out_specs=("carrier", "sf"))
        np.testing.assert_allclose(out.gather().numpy(), (x * 2).sum(-1),
                                   rtol=1e-5)

    def test_smap_makes_each_shards_card_current(self, monkeypatch):
        """Each shard's body runs with its own card current (what the body
        allocates on "cuda" lands there); a CPU shard enters no CUDA
        context. The blocks here are host tensors standing in for the
        cards' (no card on this box)."""
        current = []

        class Recorder:
            def __init__(self, device):
                self.device = device

            def __enter__(self):
                current.append(self.device)

            def __exit__(self, *exc):
                current.pop()

        monkeypatch.setattr(torch.cuda, "device", Recorder)
        cards = [torch.device("cuda", i) for i in range(4)]
        mesh = make_mesh(4, carriers=2, devices=cards)
        sharding = Sharding(mesh, ("carrier", "sf"))
        blocks = {c: torch.zeros(1, 1) for c in mesh.local()}
        seen = smap(lambda blk: current[-1], Sharded(sharding, blocks,
                                                     (2, 2)))
        assert seen == {c: mesh.devices[c] for c in mesh.local()}
        assert sorted(d.index for d in seen.values()) == [0, 1, 2, 3]
        assert current == []
        cpu = smap(lambda blk: list(current), shard_batch(
            make_mesh(4, carriers=2, devices=["cpu"] * 4),
            torch.zeros(2, 2)))
        assert all(v == [] for v in cpu.values())


def _noisy(rng, nb: int, k: int, ebn0_db: float):
    u = rng.integers(0, 2, size=(nb, k)).astype(np.int8)
    d = turbo_encode_np(u)
    n0 = 1.0 / (10 ** (ebn0_db / 10) / 3)
    sig = np.sqrt(n0 / 2)
    llr = (4 / n0 * (1 - 2 * d.astype(np.float64)
                     + sig * rng.normal(size=d.shape))).astype(np.float32)
    return u, llr


class TestSequenceParallelTurbo:
    @pytest.mark.parametrize("n_sp", [2, 4])
    def test_sp_decode_matches_quality(self, n_sp, rng):
        """The halo-exchange sweep decodes every bit at 1.6 dB; at n 2 its
        bits equal JAX's sp_turbo_decode's."""
        k = 1024
        u, llr = _noisy(rng, 4, k, 1.6)
        bits, _ = sp_turbo_decode(torch.as_tensor(llr), k, _cpu_mesh(n_sp),
                                  axis="sf", iterations=6)
        errs = int((bits.numpy() != u).sum())
        assert errs == 0, f"{errs} errors with {n_sp}-way trellis sharding"
        if n_sp == 2:
            ref, _ = jax_sp_decode(jnp.asarray(llr), k, _jax_mesh(2),
                                   axis="sf", iterations=6)
            np.testing.assert_array_equal(bits.numpy(), np.asarray(ref))

    @pytest.mark.parametrize("n_sp", [2, 4])
    def test_sp_nii_bit_identical_to_single_device(self, n_sp, rng):
        """The NII decode, trellis-sharded: equal to JAX's sharded decode
        (bits exact, LLRs within 1e-4) and bit-identical, LLRs included,
        to the port's one-device NII decode at the same window."""
        k = 1024
        u = rng.integers(0, 2, size=(8, k)).astype(np.int8)
        d = turbo_encode_np(u)
        llr = ((1 - 2 * d.astype(np.float32)) * 4.0
               + rng.normal(size=d.shape).astype(np.float32))
        bits, soft = sp_turbo_decode_nii(torch.as_tensor(llr), k,
                                         _cpu_mesh(n_sp), axis="sf",
                                         iterations=3)
        l = _pick_window(k // n_sp, 16)
        ref_bits, ref_soft = TurboDecoder(
            k=k, iterations=3, window=l, impl="nii",
            dtype="float32").decode(torch.as_tensor(llr))
        np.testing.assert_array_equal(bits.numpy(), ref_bits.numpy())
        np.testing.assert_array_equal(soft.numpy(), ref_soft.numpy())
        assert np.array_equal(bits.numpy(), u)

        jbits, jsoft = jax_sp_decode_nii(jnp.asarray(llr), k,
                                         _jax_mesh(n_sp), axis="sf",
                                         iterations=3, sub=8, lanes=1,
                                         interpret=True)
        np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
        np.testing.assert_allclose(soft.numpy(), np.asarray(jsoft),
                                   rtol=1e-4, atol=1e-4)

    def test_sp_matches_single_device_windowed(self, rng):
        """With aligned windows the halo decode trains its boundaries on
        the same rows as the one-device windowed sweep: equal bits."""
        k = 512
        u = rng.integers(0, 2, size=(2, k)).astype(np.int8)
        d = turbo_encode_np(u)
        llr = torch.as_tensor((1 - 2 * d.astype(np.float32)) * 4.0
                              + rng.normal(size=d.shape).astype(np.float32))
        bits, _ = sp_turbo_decode(llr, k, _cpu_mesh(2), axis="sf",
                                  iterations=3)
        ref, _ = TurboDecoder(k=k, iterations=3, window=64,
                              impl="xla").decode(llr)
        np.testing.assert_array_equal(bits.numpy(), ref.numpy())

    @pytest.mark.parametrize("boundary", [(False, False), (True, False),
                                          (False, True)])
    def test_windowed_sweep_with_halo_matches_jax(self, boundary, rng):
        """``_windowed_map_decode`` on a trellis slice with real halo rows
        and uniform starts at the slice edges that are not trellis
        edges."""
        chunk, o, window, b = 256, 40, 128, 3
        g = lambda *s: rng.normal(size=s).astype(np.float32) * 3.0
        lsa, lp = g(chunk, b), g(chunk, b)
        halo = tuple(g(o + 3, b) for _ in range(4))
        a0 = np.asarray([0.0] + [-1e30] * 7, np.float32)
        b0 = g(8)
        got = _windowed_map_decode(
            torch.as_tensor(lsa), torch.as_tensor(lp), chunk, o, window,
            torch.as_tensor(a0), torch.as_tensor(b0),
            halo=tuple(map(torch.as_tensor, halo)), boundary=boundary)
        ref = jax_windowed_map_decode(
            jnp.asarray(lsa), jnp.asarray(lp), chunk, o, window,
            jnp.asarray(a0), jnp.asarray(b0),
            halo=tuple(map(jnp.asarray, halo)), boundary=boundary)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)


class TestKernelsBatchSharded:
    def test_nii_decode_batch_sharded(self):
        """The NII decoder (its plain twin) per shard with the code block
        batch split over 8 shards: each shard decodes only its own block,
        and the gathered bits equal the unsharded decode's and the sent
        ones."""
        mesh = make_mesh(8, devices=CPU8)
        k = 320
        dec = TurboDecoder(k=k, iterations=2, window=80, impl="nii")
        rng = np.random.default_rng(5)
        u = rng.integers(0, 2, size=(8, 1, k)).astype(np.int8)
        d = turbo_encode_np(u.reshape(-1, k)).reshape(8, 1, 3, k + 4)
        llr = torch.as_tensor((1.0 - 2.0 * d.astype(np.float32)) * 8.0)
        spec = (("carrier", "sf"),)
        xs = Sharding(mesh, spec).place(llr)
        assert all(s.shape[0] == 1 for s in xs.shards.values())
        bits = smap(lambda x: dec.decode(x)[0], xs, out_specs=spec).gather()
        np.testing.assert_array_equal(bits.numpy(), u)
        np.testing.assert_array_equal(bits.numpy(), dec.decode(llr)[0])

    def test_viterbi_decode_batch_sharded(self):
        """The Viterbi decode (its plain twin) per shard over 8 shards:
        equal to the unsharded decode and the sent bits."""
        mesh = make_mesh(8, devices=CPU8)
        k = 44
        g = torch.Generator().manual_seed(6)
        u = torch.randint(0, 2, (8, 8, k), generator=g)
        llr = (1.0 - 2.0 * conv_encode(u).to(torch.float32)) * 4.0
        spec = (("carrier", "sf"),)
        bits = smap(viterbi_decode, Sharding(mesh, spec).place(llr),
                    out_specs=spec).gather()
        np.testing.assert_array_equal(bits.numpy(), u.numpy())
        np.testing.assert_array_equal(bits.numpy(), viterbi_decode(llr))


def test_build_uedl_mini_matches_jax():
    """The no-genie 6-PRB chain per shard of a (2, 2) mesh: every shard's
    bits and ok flag equal the JAX chain's on the same transport blocks
    (JAX runs the whole batch at once; its per-shard map is the same
    per-subframe computation)."""
    step, tbs = build_uedl_mini(seed=7, device="cpu")
    jstep, jtbs = jax_build_uedl_mini(seed=7)
    assert tbs == jtbs
    tb = np.random.default_rng(7).integers(0, 2, (2, 2, tbs)).astype(np.int8)
    mesh = make_mesh(4, devices=["cpu"] * 4)
    out = smap(step, shard_batch(mesh, torch.as_tensor(tb)))
    jbits, jok = jax.jit(jstep)(jnp.asarray(tb))
    jbits, jok = np.asarray(jbits), np.asarray(jok)
    assert jok.all()
    for (i, j), (bits, ok) in out.items():
        np.testing.assert_array_equal(bits[0, 0].numpy(), jbits[i, j])
        assert bool(ok[0, 0]) == bool(jok[i, j])
        np.testing.assert_array_equal(bits[0, 0].numpy(), tb[i, j])
