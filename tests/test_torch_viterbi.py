"""Port vs JAX reference: the tail-biting Viterbi decoder.

The port's plain twin of the CUDA Viterbi kernel
(convcoder.viterbi_decode_plain) must take bit-identical decisions to
the JAX package's three-segment scan and to its Pallas kernel (run in
interpret mode) on the same soft inputs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from empower_srslte_tpu.ops.fec.convcoder import (conv_encode_np,
                                                  viterbi_decode as jax_vit)
from empower_srslte_tpu.ops.fec.viterbi_pallas import viterbi_decode_pallas

from empower_srslte_tpu_torch.ops.fec import viterbi37
from empower_srslte_tpu_torch.ops.fec.convcoder import (
    conv_encode, viterbi_decode, viterbi_decode_plain)
from empower_srslte_tpu_torch.runtime import trace


@pytest.mark.parametrize("k", [55, 44, 40, 20])
def test_plain_twin_matches_scan_and_kernel(rng, k):
    u = rng.integers(0, 2, size=(48, k)).astype(np.int8)
    d = conv_encode_np(u)
    llr = (1.0 - 2.0 * d + 0.45 * rng.normal(size=d.shape)).astype(np.float32)
    ref = np.asarray(jax_vit(jnp.asarray(llr), impl="scan"))
    kern = np.asarray(viterbi_decode_pallas(jnp.asarray(llr), interpret=True,
                                            sub=8, lanes=8))
    got = viterbi_decode_plain(torch.as_tensor(llr)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, kern)
    assert np.mean(got != u) < 0.01


def test_wrapper_runs_plain_twin_on_cpu(rng):
    llr = torch.as_tensor(rng.normal(size=(2, 5, 3, 44)).astype(np.float32))
    before = trace.launch_counts()
    got = viterbi_decode(llr)
    assert trace.launch_counts() == before
    assert got.shape == (2, 5, 44)
    assert torch.equal(got, viterbi_decode_plain(llr))


def test_cuda_entry_refuses_cpu_tensor():
    with pytest.raises(ValueError):
        viterbi37.viterbi_regs_cuda(torch.zeros(4, 3, 44), 40)


def test_conv_encoder_matches_numpy(rng):
    u = rng.integers(0, 2, size=(6, 55)).astype(np.int8)
    np.testing.assert_array_equal(conv_encode(torch.as_tensor(u)).numpy(),
                                  conv_encode_np(u))
