"""Port vs JAX reference: the XLA turbo sweeps (``_map_decode``, the full
trellis with every beta stored, and ``_windowed_map_decode``, overlap
training with ``PAD_LLR`` padding) and ``TurboDecoder(impl="xla")``.

Inputs are N(0, 4) LLRs (numpy draws handed to both) at K 40 and 192,
1-3 iterations. Hard bits are equal, LLRs within 1e-3 x max|LLR| (both
do the same float32 adds and maxes in the same order; XLA may fuse them
differently). ``decoder_impl_from_jax("xla")`` maps a JAX plan's XLA
decoder onto these sweeps, and a DL-SCH decode with such a plan equals
JAX's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from empower_srslte_tpu.models.sch import DlschPlan as JPlan
from empower_srslte_tpu.models.sch import dlsch_decode as jdlsch_decode
from empower_srslte_tpu.models.sch import dlsch_encode as jdlsch_encode
from empower_srslte_tpu.ops.fec import turbo_decoder as jtd

from empower_srslte_tpu_torch import convert
from empower_srslte_tpu_torch.models.sch import _pick_window, dlsch_decode
from empower_srslte_tpu_torch.ops.fec import turbo_decoder as td


def _llrs(rng, b, k):
    return (2.0 * rng.normal(size=(b, 3, k + 4))).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-3 * np.abs(want).max())


def _edges():
    init = np.full(8, td.NEG_INF, np.float32)
    init[0] = 0.0
    return torch.as_tensor(init), jnp.asarray(init)


@pytest.mark.parametrize("k", [40, 192])
def test_map_decode_matches_jax(k, rng):
    lsa = (2.0 * rng.normal(size=(k + 3, 16))).astype(np.float32)
    lp = (2.0 * rng.normal(size=(k + 3, 16))).astype(np.float32)
    edge, jedge = _edges()
    got = td._map_decode(torch.as_tensor(lsa), torch.as_tensor(lp), 3,
                         edge, edge)
    want = jtd._map_decode(jnp.asarray(lsa), jnp.asarray(lp), 3, jedge,
                           jedge)
    assert got.shape == (k, 16)
    _close(got.numpy(), want)


@pytest.mark.parametrize("k,window,overlap", [(192, 96, 40), (192, 48, 24),
                                              (1024, 256, 40)])
def test_windowed_map_decode_matches_jax(k, window, overlap, rng):
    lsa = (2.0 * rng.normal(size=(k + 3, 8))).astype(np.float32)
    lp = (2.0 * rng.normal(size=(k + 3, 8))).astype(np.float32)
    edge, jedge = _edges()
    got = td._windowed_map_decode(torch.as_tensor(lsa), torch.as_tensor(lp),
                                  k, overlap, window, edge, edge)
    want = jtd._windowed_map_decode(jnp.asarray(lsa), jnp.asarray(lp), k,
                                    overlap, window, jedge, jedge)
    assert got.shape == (k, 8)
    _close(got.numpy(), want)


@pytest.mark.parametrize("k,window", [(40, None), (192, None),
                                      (192, _pick_window(192))])
@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_xla_decoder_matches_jax(k, window, iterations, rng):
    llr = _llrs(rng, 16, k)
    bits, out = td.TurboDecoder(k=k, iterations=iterations, window=window,
                                impl="xla").decode(torch.as_tensor(llr))
    jbits, jout = jtd.TurboDecoder(k=k, iterations=iterations, window=window,
                                   impl="xla").decode(jnp.asarray(llr))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    _close(out.numpy(), jout)


@pytest.mark.parametrize("k,window", [(40, None), (192, None),
                                      (192, _pick_window(192))])
@pytest.mark.parametrize("iterations", [1, 3])
def test_xla_decoder_bfloat16_matches_jax(k, window, iterations, rng):
    """``impl="xla"`` with ``dtype="bfloat16"`` on both sides: every
    sweep op rounds to bfloat16 in both packages, so bits and LLRs are
    equal exactly (``"auto"`` keeps the XLA decoder in float32, as JAX)."""
    llr = _llrs(rng, 16, k)
    assert td.TurboDecoder(k=k, window=window,
                           impl="xla").metric_dtype == torch.float32
    bits, out = td.TurboDecoder(k=k, iterations=iterations, window=window,
                                impl="xla", dtype="bfloat16").decode(
                                    torch.as_tensor(llr))
    jbits, jout = jtd.TurboDecoder(k=k, iterations=iterations, window=window,
                                   impl="xla", dtype="bfloat16").decode(
                                       jnp.asarray(llr))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(jout.astype(jnp.float32)))


def test_windowed_decoder_without_window_is_the_full_sweep(rng):
    """JAX's ``run_map`` takes the full sweep whenever the window is None,
    whatever the impl; the port's windowed decoder runs one NII window
    over the whole trellis there, and agrees with it."""
    llr = _llrs(rng, 8, 40)
    bits, out = td.TurboDecoder(k=40, iterations=3, window=None,
                                impl="windowed").decode(torch.as_tensor(llr))
    jbits, jout = jtd.TurboDecoder(k=40, iterations=3, window=None,
                                   impl="pallas").decode(jnp.asarray(llr))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    _close(out.numpy(), jout)


def test_decoder_impl_mapping():
    assert convert.decoder_impl_from_jax("xla") == "xla"
    assert convert.decoder_impl_from_jax("auto") == "nii"
    assert convert.decoder_impl_from_jax("pallas2_interpret") == "nii"
    assert convert.decoder_impl_from_jax("pallas") == "windowed"
    with pytest.raises(ValueError):
        convert.decoder_impl_from_jax("scan")
    with pytest.raises(ValueError):
        td.TurboDecoder(k=40, impl="scan")


def test_dlsch_decode_with_xla_plan_matches_jax(rng):
    """A JAX plan naming the XLA decoder, carried over by ``convert``:
    CRC flags and bits equal JAX's on two noisy TBs of 2 code blocks, with
    the CRC early stop."""
    jplan = JPlan(tbs=6200, g=19200, qm=2, max_iterations=4,
                  decoder_impl="xla")
    plan = convert.dlsch_plan_from_fields(vars(jplan))
    assert plan.decoder_impl == "xla"
    assert JPlan(**convert.plan_fields(plan)) == jplan
    tb = rng.integers(0, 2, size=(2, jplan.tbs)).astype(np.int8)
    coded = np.asarray(jdlsch_encode(jnp.asarray(tb), jplan))
    llr = ((1.0 - 2.0 * coded) * 1.2
           + rng.normal(size=coded.shape)).astype(np.float32)
    bits, ok, _ = dlsch_decode(torch.as_tensor(llr), plan)
    jbits, jok, _ = jdlsch_decode(jnp.asarray(llr), jplan)
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert ok.all()
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))
    np.testing.assert_array_equal(bits.numpy(), tb)
