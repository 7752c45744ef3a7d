"""Port vs JAX reference: the windowed-overlap turbo constituent kernel and
the full decodes that drive it.

The JAX side runs the Pallas kernel ``map_decode_fused`` in interpret
mode on the CPU (narrow lanes, so the interpreter stays cheap); the port
side runs the kernel's plain twin. Both execute the same float32
operations in the same order, so the tolerance is float32 rounding:
rtol = atol = 1e-5 for one constituent decode, 1e-4 for LLRs after
several iterations. The float32 decodes are pinned to float32 on both
sides; the bfloat16 case (both packages' ``dtype="auto"`` on this
kernel path) rounds every op to bfloat16 on both sides, and its LLRs are
equal exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from empower_srslte_tpu.ops.fec.turbo_decoder import (
    PAD_LLR, TurboDecoder as JaxTurbo)
from empower_srslte_tpu.ops.fec.turbo_decoder_pallas import (
    fold_lanes, map_decode_fused, pad_trellis_rows, unfold_lanes)
from empower_srslte_tpu.ops.fec.turbo_encoder import turbo_encode_np
from empower_srslte_tpu.utils.crc import CRC24B as JAX_CRC24B

from empower_srslte_tpu_torch.models.sch import DlschPlan, _pick_window
from empower_srslte_tpu_torch.ops.fec.turbo_decoder import TurboDecoder
from empower_srslte_tpu_torch.ops.fec.turbo_win import (
    map_decode_win, map_decode_win_plain)
from empower_srslte_tpu_torch.runtime import trace
from empower_srslte_tpu_torch.utils.crc import CRC24B

TOL = dict(rtol=1e-5, atol=1e-5)
O = 40


def _jax_fused(lsa, lp, k, l):
    """The JAX decoder's kernel call (turbo_decoder.py:569-583) on one
    constituent: halve, pad, fold to 8 x B/8 lanes, decode, unfold."""
    prep = lambda x, pad: fold_lanes(pad_trellis_rows(
        jnp.asarray(x) * 0.5, O, pad))
    b = lsa.shape[1]
    out = map_decode_fused(prep(lsa, PAD_LLR), prep(lp, 0.0), k, l, O,
                           lanes=b // 8, interpret=True)
    return np.asarray(unfold_lanes(out))


@pytest.mark.parametrize("k", [192, 1024])
def test_win_kernel_plain_twin_matches_pallas(rng, k):
    l = _pick_window(k)
    b = 8
    lsa = (4.0 * rng.normal(size=(k + 3, b))).astype(np.float32)
    lp = (4.0 * rng.normal(size=(k + 3, b))).astype(np.float32)
    want = _jax_fused(lsa, lp, k, l)
    got = map_decode_win(torch.as_tensor(lsa), torch.as_tensor(lp), k=k,
                         l=l, o=O)
    assert got.shape == (k, b)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_win_wrapper_is_plain_twin_on_cpu(rng):
    """On a CPU tensor the wrapper runs the plain twin and counts no
    kernel launch; bad geometry is refused."""
    k, l, b = 192, 96, 4
    x = lambda: torch.as_tensor(rng.normal(size=(k + 3, b)).astype(
        np.float32))
    lsa, lp = x(), x()
    before = trace.launch_counts()
    got = map_decode_win(lsa, lp, k=k, l=l, o=O)
    assert trace.launch_counts() == before
    assert torch.equal(got, map_decode_win_plain(lsa, lp, k=k, l=l, o=O))
    with pytest.raises(ValueError):
        map_decode_win(lsa, lp, k=k, l=100, o=O)
    with pytest.raises(ValueError):
        map_decode_win(lsa[:-1], lp[:-1], k=k, l=l, o=O)


def _crc_blocks(rng, k, batch):
    payload = rng.integers(0, 2, size=(batch, k - 24)).astype(np.int8)
    return np.stack([JAX_CRC24B.attach(p) for p in payload])


def _awgn_llr(rng, d, ebn0_db):
    ebn0 = 10 ** (ebn0_db / 10)
    n0 = 1.0 / (ebn0 / 3)
    y = (1 - 2 * d.astype(np.float64)
         + np.sqrt(n0 / 2) * rng.normal(size=d.shape))
    return (4 / n0 * y).astype(np.float32)


def _jax_v1(llr, k, iterations, crc, impl="pallas_interpret", overlap=O,
            dtype="float32"):
    dec = JaxTurbo(k=k, iterations=iterations, window=_pick_window(k),
                   overlap=overlap, impl=impl, dtype=dtype)
    run = jax.jit(lambda x: dec.decode(x, crc=crc))
    bits, out = run(jnp.asarray(llr))
    return np.asarray(bits), np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("early_stop,dtype", [
    pytest.param(False, "float32", id="False"),
    pytest.param(True, "float32", id="True"),
    pytest.param(True, "bfloat16", id="True-bfloat16")])
def test_windowed_decoder_matches_jax_v1(rng, early_stop, dtype):
    """At 2 dB the early stop ends after 2 of 4 iterations; equal LLRs
    show the JAX while-loop stopped at the same iteration. In bfloat16
    the LLRs are equal exactly."""
    k, batch = 192, 8
    u = _crc_blocks(rng, k, batch)
    llr = _awgn_llr(rng, turbo_encode_np(u), 2.0)
    bits_j, llr_j = _jax_v1(llr, k, 4, JAX_CRC24B if early_stop else None,
                            dtype=dtype)

    dec = TurboDecoder(k=k, iterations=4, window=_pick_window(k),
                       impl="windowed", dtype=dtype)
    its = []
    bits, out = dec.decode(torch.as_tensor(llr),
                           crc=CRC24B if early_stop else None,
                           iters_out=its)
    assert out.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(out.numpy(), llr_j, rtol=1e-4, atol=1e-4)
    else:
        np.testing.assert_array_equal(out.float().numpy(), llr_j)
    np.testing.assert_array_equal(bits.numpy(), bits_j)
    np.testing.assert_array_equal(bits.numpy(), u)
    assert its == [2 if early_stop else 4]


def test_windowed_decoder_overlap_matches_jax_v1(rng):
    """A training length other than the default reaches the kernel: both
    decoders at overlap 24 agree, and differ from overlap 40."""
    k, batch = 192, 8
    llr = _awgn_llr(rng, turbo_encode_np(_crc_blocks(rng, k, batch)), 0.0)
    _, llr_j = _jax_v1(llr, k, 2, None, overlap=24)
    dec = lambda o: TurboDecoder(k=k, iterations=2, window=_pick_window(k),
                                 impl="windowed", overlap=o,
                                 dtype="float32")
    _, out = dec(24).decode(torch.as_tensor(llr))
    np.testing.assert_allclose(out.numpy(), llr_j, rtol=1e-4, atol=1e-4)
    _, out40 = dec(O).decode(torch.as_tensor(llr))
    assert np.abs(out40.numpy() - llr_j).max() > 1e-2


def test_xla_windowed_scan_is_not_the_reference(rng):
    """On random LLRs the JAX package's XLA windowed scan
    (``impl="xla"``) differs from its own v1 kernel: the kernel's padding
    rows carry offsets near 1e6 between renormalizations, so its
    boundary windows round differently. The port follows the kernel."""
    k = 192
    llr = (2.0 * rng.normal(size=(16, 3, k + 4))).astype(np.float32)
    _, llr_kernel = _jax_v1(llr, k, 3, None)
    _, llr_xla = _jax_v1(llr, k, 3, None, impl="xla")
    _, out = TurboDecoder(k=k, iterations=3, window=_pick_window(k),
                          impl="windowed", dtype="float32").decode(
                              torch.as_tensor(llr))
    np.testing.assert_allclose(out.numpy(), llr_kernel, rtol=1e-4,
                               atol=1e-4)
    assert np.abs(llr_kernel - llr_xla).max() > 1e-2


def test_windowed_without_window_raises(rng):
    """Without a window the windowed decoder decodes the whole trellis as
    one NII window, exactly as ``"nii"`` does (it used to raise here); an
    unknown impl still raises."""
    llr = torch.as_tensor((2.0 * rng.normal(size=(4, 3, 44)))
                          .astype(np.float32))
    bits, out = TurboDecoder(k=40, iterations=2, window=None,
                             impl="windowed").decode(llr)
    bits_n, out_n = TurboDecoder(k=40, iterations=2, window=None,
                                 impl="nii").decode(llr)
    assert torch.equal(bits, bits_n) and torch.equal(out, out_n)
    with pytest.raises(ValueError):
        TurboDecoder(k=40, impl="scan")


def test_plan_passes_decoder_impl():
    plan = DlschPlan(tbs=1000, g=3000, qm=2, decoder_impl="windowed")
    dec = plan.decoder(plan.segm.cb_sizes[0])
    assert dec.impl == "windowed" and dec.window == _pick_window(dec.k)
    assert DlschPlan(tbs=1000, g=3000, qm=2).decoder(1024).impl == "nii"
