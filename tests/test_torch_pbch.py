"""Port vs JAX reference: the PBCH (MIB pack/unpack, RE map, the 40 ms
coded period, the per-frame quarter on 1, 2 and 4 ports, the blind
decode) and the MIB receivers ``ue_mib_decode`` (1.92 Msps) and
``ue_mib_acquire`` (a 25-PRB geometry), on grids and samples made by the
JAX package's transmitter.

Tolerances: bits, RE indices, frame phases, port counts, CRC flags and
MIB dicts are equal; grids agree to 1e-6 (both packages place the same
complex64 QPSK and SFBC values).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from empower_srslte_tpu.models import pbch as jpbch
from empower_srslte_tpu.models import ue_dl as jue_dl
from empower_srslte_tpu.models.enb_dl import (enb_dl_base_grid,
                                              enb_dl_gen_signal,
                                              put_sync_signals)
from empower_srslte_tpu.utils.cell import CP as JCP
from empower_srslte_tpu.utils.cell import Cell as JCell

from empower_srslte_tpu_torch import convert
from empower_srslte_tpu_torch.models import enb_dl, pbch, ue_dl
from empower_srslte_tpu_torch.models.ue_dl import estimate_channel

#: flat per-port gains of the one rx antenna's channel
GAINS = np.array([0.8 - 0.2j, -0.3 + 0.7j, 0.6 + 0.5j, -0.5 - 0.4j],
                 np.complex64)


def _cplx(rng, *shape):
    return (rng.normal(size=shape) + 1j * rng.normal(size=shape)).astype(
        np.complex64) / np.float32(np.sqrt(2))


def _cells(jcell):
    return jcell, convert.cell_from_fields(vars(jcell))


def test_mib_pack_unpack_and_re_indices():
    for args in [(6, 0, 0, 0), (50, 0, 1, 444), (100, 1, 3, 1023),
                 (15, 1, 2, 37)]:
        bits = pbch.mib_pack(*args)
        np.testing.assert_array_equal(bits, jpbch.mib_pack(*args))
        assert pbch.mib_unpack(bits) == jpbch.mib_unpack(bits)
        assert pbch.mib_unpack(bits)["sfn_msb"] == args[3] >> 2
    for prb, cid, cp in [(6, 3, "normal"), (25, 301, "normal"),
                         (100, 5, "normal"), (15, 8, "extended")]:
        jcell, cell = _cells(JCell(nof_prb=prb, id=cid, cp=JCP(cp)))
        idx = pbch.pbch_re_indices(cell)
        assert len(idx) == 240
        np.testing.assert_array_equal(idx, jpbch.pbch_re_indices(jcell))


@pytest.mark.parametrize("ports", [1, 2, 4])
def test_pbch_encode_period_matches_jax(ports):
    jcell, cell = _cells(JCell(nof_prb=6, nof_ports=ports, id=211))
    mib = np.stack([pbch.mib_pack(6, 0, 1, 400), pbch.mib_pack(100, 1, 2, 9)])
    got = pbch.pbch_encode_period(torch.as_tensor(mib), cell)
    want = jpbch.pbch_encode_period(jnp.asarray(mib), jcell)
    assert got.shape == (2, pbch.PBCH_BITS)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.fixture
def spec_pbch(ports):
    """On 4 ports the JAX package's PBCH held to TS 36.211 6.6.3
    (SFBC-FSTD, where JAX sends SFBC on ports 0 and 1):
    ``tests/jax_dl_spec.py``; on 1 and 2 ports JAX's own."""
    if ports != 4:
        yield
        return
    from tests.jax_dl_spec import spec_downlink

    with spec_downlink():
        yield


@pytest.mark.parametrize("ports", [1, 2, 4])
def test_pbch_put_matches_jax(rng, ports, spec_pbch):
    """Every frame phase q of the 40 ms period, on grids that already hold
    other values (the quarter overwrites only the PBCH REs)."""
    jcell, cell = _cells(JCell(nof_prb=15, nof_ports=ports, id=67))
    base = _cplx(rng, 2, ports, 14, jcell.nof_re)
    mib = pbch.mib_pack(15, 1, 2, 612)
    for q in range(4):
        got = pbch.pbch_put(torch.as_tensor(base), torch.as_tensor(mib),
                            cell, 612 + q)
        want = jpbch.pbch_put(jnp.asarray(base), jnp.asarray(mib), jcell,
                              612 + q)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("ports", [1, 2, 4])
def test_pbch_decode_matches_jax(rng, ports, spec_pbch):
    """Five subframe-0 grids at one rx antenna: SFNs of every frame phase
    at two noise levels, and one grid of noise alone (no hypothesis
    passes; both packages then report the first)."""
    jcell, cell = _cells(JCell(nof_prb=6, nof_ports=ports, id=13))
    sfns = [100, 201, 302, 403, 504]
    grids = []
    for i, sfn in enumerate(sfns):
        g = jpbch.pbch_put(jnp.zeros((ports, 14, 72), jnp.complex64),
                           jnp.asarray(jpbch.mib_pack(6, i % 2, 1, sfn)),
                           jcell, sfn)
        grids.append(np.asarray(g))
    grids = np.stack(grids)                                # [5, P, 14, 72]
    y = np.einsum("p,bpsk->bsk", GAINS[:ports], grids)
    amp = np.array([0.05, 0.3, 0.05, 0.3, 1.0], np.float32)[:, None, None]
    y = (y + amp * _cplx(rng, *y.shape)).astype(np.complex64)
    y[-1] = (amp[-1] * _cplx(rng, 14, 72)).astype(np.complex64)
    h = np.broadcast_to(GAINS[:ports, None, None],
                        (5, ports, 14, 72)).astype(np.complex64)
    if ports == 1:
        h = h[:, 0]
    got = pbch.pbch_decode(torch.as_tensor(y), torch.as_tensor(h), cell,
                           noise_est=0.01)
    want = jpbch.pbch_decode(jnp.asarray(y), jnp.asarray(h), jcell,
                             noise_est=0.01)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    bits, q, nports, ok = got
    assert ok.tolist() == [True] * 4 + [False]
    assert q[:4].tolist() == [s % 4 for s in sfns[:4]]
    assert nports[:4].tolist() == [ports] * 4
    for i in range(4):
        np.testing.assert_array_equal(
            bits[i].numpy(), jpbch.mib_pack(6, i % 2, 1, sfns[i]))


def _subframe0(jcell, sfn, rng, snr_db=15.0):
    """Subframe 0 of ``jcell`` (CRS, PSS/SSS, the PBCH quarter of ``sfn``)
    at one rx antenna through GAINS, AWGN at ``snr_db``."""
    grid = put_sync_signals(enb_dl_base_grid(jcell, 0, ()), jcell, 0)
    grid = jpbch.pbch_put(grid, jnp.asarray(jpbch.mib_pack(
        jcell.nof_prb, 1, 2, sfn)), jcell, sfn)
    x = np.einsum("p,pt->t", GAINS[:jcell.nof_ports],
                  np.asarray(enb_dl_gen_signal(grid, jcell)))
    sigma = np.sqrt(np.mean(np.abs(x) ** 2) * 10 ** (-snr_db / 10))
    return (x + sigma * _cplx(rng, x.size)).astype(np.complex64)


@pytest.mark.parametrize("ports", [1, 2])
def test_ue_mib_decode_matches_jax(rng, ports):
    """The 1.92 Msps receiver decodes with the port-0 channel of a 1-port
    cell, as JAX's does: a 2-port cell's SFBC PBCH then reads as noise in
    both packages."""
    jcell = JCell(nof_prb=6, nof_ports=ports, id=97)
    y = _subframe0(jcell, 518, rng)
    got = ue_dl.ue_mib_decode(y, 97, device="cpu")
    want = jue_dl.ue_mib_decode(y, 97)
    assert got == want
    if ports == 1:
        assert got == dict(nof_prb=6, phich_dur=1, phich_res=2,
                           sfn_msb=518 >> 2, sfn_mod4=2, nof_ports=1)


def test_ue_mib_acquire_matches_jax(rng):
    jcell = JCell(nof_prb=25, id=301)
    y = _subframe0(jcell, 37, rng)
    geom = convert.cell_from_fields(vars(JCell(nof_prb=25, id=0)))
    got = ue_dl.ue_mib_acquire(torch.as_tensor(y), geom, 301)
    want = jue_dl.ue_mib_acquire(y, JCell(nof_prb=25, id=0), 301)
    assert got == want == dict(nof_prb=25, phich_dur=1, phich_res=2,
                               sfn_msb=9, sfn_mod4=1, nof_ports=1, sfn=37)
    # a wrong cell ID scrambles the PBCH: no hypothesis passes
    assert ue_dl.ue_mib_acquire(y, geom, 302, device="cpu") is None


def test_pbch_batch_stimulus_decodes():
    """A slice of the batch that chip_smoke.py's ``pbch_batch`` phase
    decodes on the card (2-port SFBC PBCH at 100 PRB), with the plain
    Viterbi twin: every MIB, frame phase and port count is right."""
    st = enb_dl.pbch_batch_stimulus(8, device="cpu")
    assert st.y.shape == (8, 14, 1200) and st.cell.nof_ports == 2
    h, n0 = estimate_channel(st.y, st.cell, 0)
    bits, q, ports, ok = pbch.pbch_decode(st.y, h, st.cell, noise_est=n0)
    assert bool(ok.all())
    assert torch.equal(bits, st.mib)
    assert torch.equal(q, st.sfn % 4)
    assert bool((ports == 2).all())


def test_mib_entry_points_refuse_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    y = np.zeros(1920, np.complex64)
    with pytest.raises(RuntimeError, match="CUDA"):
        ue_dl.ue_mib_decode(y, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        ue_dl.ue_mib_acquire(y, convert.cell_from_fields(
            vars(JCell(nof_prb=6, id=0))), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        enb_dl.pbch_batch_stimulus(4)
