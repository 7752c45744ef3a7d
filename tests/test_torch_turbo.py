"""Port vs JAX reference: NII turbo constituent kernel, full turbo decodes
and the turbo encoder.

The JAX side runs the Pallas NII kernel in interpret mode with a tiny
tile (TURBO_SUB=8, TURBO_LANES=1), as the reference's own tests do; the
port side runs the kernel's plain twin on the CPU. Both execute the same
float32 operations in the same order, so the tolerance is the float32
rounding of a handful of adds (rtol = atol = 1e-5). The full decodes run
at float32 (pinned on both sides) and at bfloat16, the precision both
packages' ``dtype="auto"`` gives a windowed NII decode; in bfloat16 every
op rounds to bfloat16 on both sides, and bits, LLRs and the early stop's
iteration count are equal exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from empower_srslte_tpu.ops.fec.derm_tiles import parity_rows_interleaved
from empower_srslte_tpu.ops.fec.turbo_decoder import TurboDecoder as JaxTurbo
from empower_srslte_tpu.ops.fec.turbo_decoder_pallas2 import (
    map_decode_nii as jax_map_decode_nii, to_tiles)
from empower_srslte_tpu.ops.fec.turbo_encoder import turbo_encode_np
from empower_srslte_tpu.utils.crc import CRC24B as JAX_CRC24B

from empower_srslte_tpu_torch.models.sch import _pick_window
from empower_srslte_tpu_torch.ops.fec.turbo_decoder import TurboDecoder
from empower_srslte_tpu_torch.ops.fec.turbo_encoder import turbo_encode
from empower_srslte_tpu_torch.ops.fec.turbo_nii import (
    map_decode_nii, map_decode_nii_plain)
from empower_srslte_tpu_torch.runtime import trace
from empower_srslte_tpu_torch.utils.crc import CRC24B

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _tiny_tiles(monkeypatch):
    monkeypatch.setenv("TURBO_SUB", "8")
    monkeypatch.setenv("TURBO_LANES", "1")


def _rows_to_jax(x):
    """port [R, B] -> JAX tiles [T, R, 8, 1]."""
    return jnp.asarray(to_tiles(x, 1, 8))


def _state_to_jax(x):
    """port [W+1, 8, B] -> JAX [T, W+1, 8, 8, 1]."""
    w1, _, b = x.shape
    return jnp.asarray(x.reshape(w1, 8, b // 8, 8, 1).transpose(2, 0, 1, 3, 4))


def _rows_from_jax(x):
    x = np.asarray(x)
    t, r, s, l = x.shape
    return x.transpose(1, 0, 2, 3).reshape(r, t * s * l)


def _state_from_jax(x):
    x = np.asarray(x)
    t, w1, _, s, l = x.shape
    return x.transpose(1, 2, 0, 3, 4).reshape(w1, 8, t * s * l)


@pytest.mark.parametrize("bounds", [None, (-1, -1)])
def test_nii_kernel_plain_twin_matches_pallas(rng, bounds):
    k, l, b = 256, 64, 16
    w = k // l
    f = lambda *s: (2.0 * rng.normal(size=s)).astype(np.float32)
    u, p, apr = f(k, b), f(k, b), f(k, b)
    tu, tp = f(3, b), f(3, b)
    a_st, b_st = f(w + 1, 8, b), f(w + 1, 8, b)

    pad8 = lambda x: np.concatenate([x, np.zeros((5, b), np.float32)])
    jb = None if bounds is None else jnp.asarray(bounds, jnp.int32)
    ext_j, a_j, b_j = jax_map_decode_nii(
        _rows_to_jax(u), _rows_to_jax(p), _rows_to_jax(pad8(tu)),
        _rows_to_jax(pad8(tp)), _state_to_jax(a_st), _state_to_jax(b_st),
        l=l, lanes=1, interpret=True, apr=_rows_to_jax(apr), bounds=jb)

    t = lambda x: torch.as_tensor(x)
    ext, a_n, b_n = map_decode_nii(t(u), t(p), t(tu), t(tp), t(a_st),
                                   t(b_st), l=l, apr=t(apr), bounds=bounds)
    np.testing.assert_allclose(ext.numpy(), _rows_from_jax(ext_j), **TOL)
    np.testing.assert_allclose(a_n.numpy(), _state_from_jax(a_j), **TOL)
    np.testing.assert_allclose(b_n.numpy(), _state_from_jax(b_j), **TOL)


def test_nii_wrapper_is_plain_twin_on_cpu(rng):
    """On a CPU tensor the wrapper runs the plain twin and counts no
    kernel launch."""
    k, l, b = 128, 64, 4
    x = lambda *s: torch.as_tensor(rng.normal(size=s).astype(np.float32))
    args = (x(k, b), x(k, b), x(3, b), x(3, b), x(3, 8, b), x(3, 8, b))
    before = trace.launch_counts()
    got = map_decode_nii(*args, l=l)
    ref = map_decode_nii_plain(*args, l=l)
    assert trace.launch_counts() == before
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _crc_blocks(rng, k, batch):
    payload = rng.integers(0, 2, size=(batch, k - 24)).astype(np.int8)
    return np.stack([JAX_CRC24B.attach(p) for p in payload])


def _awgn_llr(rng, d, ebn0_db):
    ebn0 = 10 ** (ebn0_db / 10)
    n0 = 1.0 / (ebn0 / 3)
    y = 1 - 2 * d.astype(np.float64) + np.sqrt(n0 / 2) * rng.normal(size=d.shape)
    return (4 / n0 * y).astype(np.float32)


def _jax_nii_decode(llr, k, iterations, dtype="float32"):
    """The JAX NII path (TurboDecoder._decode_nii) with the early-stop
    iteration count surfaced: -> (bits [B, K], natural-order LLRs [B, K]
    as float32, iterations)."""
    import jax

    dec = JaxTurbo(k=k, iterations=iterations, window=_pick_window(k),
                   impl="pallas2_interpret", dtype=dtype)
    sys1, par1, sys2_tail, par2 = dec._split_streams(
        jnp.asarray(llr).astype(dtype))
    tm = lambda x: jnp.moveaxis(x, -1, 0)
    pad8 = lambda x: jnp.pad(x, ((0, 8 - x.shape[0]), (0, 0)))
    tiles = lambda x: to_tiles(x, 1, 8)
    p_int = jnp.asarray(parity_rows_interleaved(JAX_CRC24B.poly, 24, k))

    def crc_check(llr_int):
        bits = (llr_int < 0).astype(jnp.float32)
        snd = jnp.einsum("tksl,kc->tcsl", bits, p_int)
        return jnp.all(jnp.mod(snd, 2.0) == 0.0)

    s1, p1, p2 = tm(sys1), tm(par1), tm(par2)
    run = jax.jit(lambda *a: dec.decode_tiles(*a, crc_check=crc_check,
                                               interpret=True))
    llr_int, n_it = run(tiles(s1[:k]), tiles(p1[:k]), tiles(p2[:k]),
                        tiles(pad8(s1[k:])), tiles(pad8(p1[k:])),
                        tiles(pad8(tm(sys2_tail))), tiles(pad8(p2[k:])))
    from empower_srslte_tpu.ops.fec.tables import qpp_deinterleaver

    llr_nat = _rows_from_jax(llr_int.astype(jnp.float32))[
        qpp_deinterleaver(k)]
    return (llr_nat.T < 0).astype(np.int8), llr_nat.T, int(n_it)


@pytest.mark.parametrize("k,ebn0_db,dtype", [
    pytest.param(512, 1.2, "float32", id="512-1.2"),
    pytest.param(1024, 1.0, "float32", id="1024-1.0"),
    pytest.param(512, 1.2, "bfloat16", id="512-1.2-bfloat16"),
    pytest.param(1024, 1.0, "bfloat16", id="1024-1.0-bfloat16")])
def test_full_decode_matches_jax(rng, k, ebn0_db, dtype):
    """Near the waterfall the early stop iterates. In float32 the bits
    equal JAX's and the sent ones; in bfloat16 (both packages' default
    here) bits, LLRs and the iteration count equal JAX's exactly (its
    bits need not all be the sent ones at this SNR)."""
    u = _crc_blocks(rng, k, 8)
    llr = _awgn_llr(rng, turbo_encode_np(u), ebn0_db)
    bits_j, llr_j, it_j = _jax_nii_decode(llr, k, iterations=6, dtype=dtype)

    dec = TurboDecoder(k=k, iterations=6, window=_pick_window(k),
                       dtype=dtype)
    assert dec.metric_dtype == getattr(torch, dtype)
    its = []
    bits, out = dec.decode(torch.as_tensor(llr), crc=CRC24B, iters_out=its)
    assert out.dtype == getattr(torch, dtype)
    assert its == [it_j]
    assert it_j > 1, "the operating point should exercise the early stop"
    np.testing.assert_array_equal(bits.numpy(), bits_j)
    if dtype == "float32":
        np.testing.assert_array_equal(bits.numpy(), u)
    else:
        np.testing.assert_array_equal(out.float().numpy(), llr_j)


@pytest.mark.parametrize("k", [40, 56])
def test_no_window_decode_matches_jax_full_sweep(rng, k):
    """A K without a turbo window: the port decodes it as one NII window
    of l = K, the JAX package with its XLA full-trellis sweep
    (``_map_decode``). Hard bits must be equal; LLRs agree within 0.1,
    since the two renormalize at different points (every step in the
    JAX sweep, every 16 rows in the NII recursion) in float32."""
    assert _pick_window(k) is None
    u = rng.integers(0, 2, size=(16, k)).astype(np.int8)
    coded = _awgn_llr(rng, turbo_encode_np(u), 0.5)
    noise = (3.0 * rng.normal(size=coded.shape)).astype(np.float32)
    llr = np.concatenate([coded, noise])
    bits_j, llr_j = JaxTurbo(k=k, iterations=4, window=None, impl="xla",
                             dtype="float32").decode(jnp.asarray(llr))
    bits, llr_p = TurboDecoder(k=k, iterations=4, window=None).decode(
        torch.as_tensor(llr))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(bits_j))
    np.testing.assert_allclose(llr_p.numpy(), np.asarray(llr_j), rtol=0,
                               atol=0.1)


@pytest.mark.parametrize("k", [40, 512, 6144])
def test_turbo_encoder_matches_numpy(rng, k):
    u = rng.integers(0, 2, size=(3, k)).astype(np.int8)
    got = turbo_encode(torch.as_tensor(u))
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), turbo_encode_np(u))
