"""The CRS channel and pilot noise estimate kernel (csrc/chest_dl.cu) on
the CPU: the batched entry ``chest_dl_ports`` against the per-port
estimates, the kernel's own index arithmetic (the time weights' rows,
the comb offsets, the edge extrapolation) in NumPy on the tables the
wrapper uploads, and the wrapper's refusals. The kernel itself runs only
on a CUDA card, where ``chip_smoke.py --phases chest_dl`` holds it to the
plain twin at every shape the receive paths give it.
"""

import numpy as np
import pytest
import torch

from empower_srslte_tpu_torch.models import ue_dl
from empower_srslte_tpu_torch.ops import chest
from empower_srslte_tpu_torch.utils.cell import CP, Cell

PRBS = (6, 25, 100)
SFS = (0, 1, 5)
CPS = (CP.NORM, CP.EXT)
#: the estimate's FIRs: the 3-tap default, a Gaussian, none
TAPS = {"3tap": dict(smooth=True, gauss_std=None),
        "gauss": dict(smooth=True, gauss_std=0.8),
        "none": dict(smooth=False, gauss_std=None)}
PORTS = (0, 1, 2, 3)


def _cell(prb, cp):
    return Cell(nof_prb=prb, id=prb + 7, nof_ports=4, cp=cp)


def _grid(cell, lead=(2, 3), seed=0):
    rng = np.random.default_rng(seed)
    shape = (*lead, cell.nsymb_sf, cell.nof_re)
    return torch.as_tensor((rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape))
                           .astype(np.complex64))


def emulate(grid, cell, sf_idx, ports, taps):
    """The kernel's arithmetic in NumPy float32, one (grid, port) block
    at a time, fed ``kernel_tables`` and the FIR ``taps`` as the wrapper
    uploads them: -> (h [N, P, S, K], noise [N, P])."""
    f32 = np.float32
    cv, meta, tw = chest.kernel_tables(cell, sf_idx, tuple(ports))
    nsymb, nre, m_ = cell.nsymb_sf, cell.nof_re, 2 * cell.nof_prb
    rows0 = 1 + 2 * chest.MAX_ROWS
    g = grid.numpy().reshape(-1, nsymb, nre)
    taps = np.asarray(taps, f32)
    half = (len(taps) - 1) // 2
    m = np.arange(m_)
    k = np.arange(nre)
    h = np.zeros((g.shape[0], len(ports), nsymb, nre), np.complex64)
    noise = np.zeros((g.shape[0], len(ports)), np.float32)
    for pi in range(len(ports)):
        r_ = meta[pi, 0]
        syms = meta[pi, 1:1 + r_]
        offs = meta[pi, 1 + chest.MAX_ROWS:1 + chest.MAX_ROWS + r_]
        ra = meta[pi, rows0:rows0 + nsymb]
        rb = meta[pi, rows0 + nsymb:rows0 + 2 * nsymb]
        c = cv[pi, :r_]
        for n in range(g.shape[0]):
            y = g[n, syms[:, None], offs[:, None] + 6 * m]
            ls = [y.real * c.real - y.imag * c.imag,
                  y.real * c.imag + y.imag * c.real]
            hs = []
            for part in ls:
                acc = taps[0] * part[:, np.clip(m - half, 0, m_ - 1)]
                for t in range(1, len(taps)):
                    acc = acc + taps[t] * part[:, np.clip(m + t - half, 0,
                                                          m_ - 1)]
                hs.append(acc)
            s3 = chest.SMOOTH_3TAP
            resid = [part - ((s3[0] * part[:, np.maximum(m - 1, 0)]
                              + s3[1] * part)
                             + s3[2] * part[:, np.minimum(m + 1, m_ - 1)])
                     for part in ls]
            sq = resid[0] * resid[0] + resid[1] * resid[1]
            noise[n, pi] = f32(sq.astype(np.float64).sum()) / f32(r_ * m_) \
                * f32(1.5)

            def freq(r):
                j = k - offs[r]
                inner = (j >= 0) & (j < 6 * (m_ - 1))
                mm = np.where(j < 0, 0, np.where(inner, j // 6, m_ - 2))
                w = np.where(
                    j < 0, j.astype(f32) / f32(6),
                    np.where(inner, (j - 6 * (j // 6)).astype(f32) / f32(6),
                             j.astype(f32) / f32(6) - f32(m_ - 2)))
                u = f32(1) - w
                return [u * part[r, mm] + w * part[r, mm + 1] for part in hs]

            for s in range(nsymb):
                if ra[s] < 0:
                    continue
                fa = freq(ra[s])
                v = [tw[pi, s, 0] * x for x in fa]
                if rb[s] >= 0:
                    fb = freq(rb[s])
                    v = [a + tw[pi, s, 1] * b for a, b in zip(v, fb)]
                h[n, pi, s] = v[0] + 1j * v[1]
    return h, noise


@pytest.mark.parametrize("taps", sorted(TAPS))
@pytest.mark.parametrize("cp", CPS, ids=lambda c: c.value)
@pytest.mark.parametrize("prb", PRBS)
def test_ports_entry_equals_per_port_estimates(prb, cp, taps):
    """On the CPU ``chest_dl_ports`` is the per-port ``chest_dl`` and
    ``noise_est_pilots`` stacked, at every subframe of the list."""
    cell = _cell(prb, cp)
    for sf in SFS:
        grid = _grid(cell, seed=sf)
        h, noise = chest.chest_dl_ports(grid, cell, sf, PORTS, **TAPS[taps])
        assert h.shape == (2, 3, 4, cell.nsymb_sf, cell.nof_re)
        assert noise.shape == (2, 3, 4) and noise.dtype == torch.float32
        for i, p in enumerate(PORTS):
            torch.testing.assert_close(
                h[..., i, :, :],
                chest.chest_dl(grid, cell, sf, port=p, **TAPS[taps]),
                rtol=0, atol=0)
            torch.testing.assert_close(
                noise[..., i], chest.noise_est_pilots(grid, cell, sf, port=p),
                rtol=0, atol=0)


@pytest.mark.parametrize("sf", SFS)
@pytest.mark.parametrize("taps", sorted(TAPS))
@pytest.mark.parametrize("cp", CPS, ids=lambda c: c.value)
@pytest.mark.parametrize("prb", PRBS)
def test_kernel_arithmetic_reproduces_chest(prb, cp, taps, sf):
    """The kernel's index arithmetic and operation order, in NumPy on the
    uploaded tables, give ``chest_dl`` to float32 rounding (the complex
    products may round once differently on the CPU's vector units) and
    the noise to the rounding of a sum taken in another order."""
    cell = _cell(prb, cp)
    grid = _grid(cell, lead=(2,), seed=prb + sf)
    fir = chest.fir_taps(**TAPS[taps])
    h, noise = emulate(grid, cell, sf, PORTS, fir)
    for i, p in enumerate(PORTS):
        want = chest.chest_dl(grid, cell, sf, port=p, **TAPS[taps]).numpy()
        err = np.abs(h[:, i] - want).max() / np.abs(want).max()
        assert err <= 2e-6, (p, err)
        n_want = chest.noise_est_pilots(grid, cell, sf, port=p).numpy()
        np.testing.assert_allclose(noise[:, i], n_want, rtol=2e-6)


def test_tables_hold_each_plan():
    """Each port's rows, symbols, offsets and time weights are its plan's;
    rows past a port's own are empty, and each symbol's weights sum to 1
    over at most two rows."""
    cell = _cell(100, CP.NORM)
    cv, meta, tw = chest.kernel_tables(cell, 1, PORTS)
    nsymb = cell.nsymb_sf
    rows0 = 1 + 2 * chest.MAX_ROWS
    for pi, p in enumerate(PORTS):
        plan = chest._interp_plan(cell, 1, p)
        r_ = len(plan["syms"])
        assert meta[pi, 0] == r_ == (4 if p < 2 else 2)
        np.testing.assert_array_equal(meta[pi, 1:1 + r_], plan["syms"])
        np.testing.assert_array_equal(
            meta[pi, 1 + chest.MAX_ROWS:1 + chest.MAX_ROWS + r_],
            plan["comb_offsets"])
        np.testing.assert_array_equal(cv[pi, :r_], plan["conj_vals"])
        assert not cv[pi, r_:].any()
        dense = np.zeros((nsymb, r_), np.float32)
        for s in range(nsymb):
            for j in range(2):
                row = meta[pi, rows0 + j * nsymb + s]
                if row >= 0:
                    dense[s, row] = tw[pi, s, j]
        np.testing.assert_array_equal(dense, plan["tw"])
        np.testing.assert_allclose(tw[pi].sum(-1), 1.0, atol=1e-6)


def test_fir_taps():
    np.testing.assert_array_equal(chest.fir_taps(), chest.SMOOTH_3TAP)
    np.testing.assert_array_equal(chest.fir_taps(smooth=False), [1.0])
    assert len(chest.fir_taps(gauss_std=0.5)) == chest.MAX_TAPS


def test_no_launch_without_a_card(monkeypatch):
    """The receive paths on the CPU take the plain twins: not one launch,
    and no launch counted in the tracing registry."""
    from empower_srslte_tpu_torch.runtime import trace

    cell = _cell(6, CP.NORM)
    grid = _grid(cell, lead=(2, 2))
    trace.reset()
    trace.enable()
    try:
        h, n0 = ue_dl.estimate_channel(grid, cell, 1)
        chest.chest_dl_ports(grid, cell, 0, (0, 1))
        chest.noise_est_pilots(grid, cell, 5)
    finally:
        trace.disable()
    assert h.shape == (2, 2, 4, cell.nsymb_sf, cell.nof_re)
    torch.testing.assert_close(
        n0, chest.noise_est_pilots(grid, cell, 1), rtol=0, atol=0)
    assert not trace.launch_shapes("chest_dl")
    assert trace.launch_counts() == {}


def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch):
    from empower_srslte_tpu_torch.runtime import trace

    before = trace.launch_counts()
    cell = _cell(6, CP.NORM)
    grid = _grid(cell)
    with pytest.raises(ValueError, match="contiguous complex64"):
        chest.chest_dl_cuda(grid.to(torch.complex128), cell, 0, (0,),
                            chest.SMOOTH_3TAP)
    with pytest.raises(ValueError, match="contiguous complex64"):
        chest.chest_dl_cuda(grid.transpose(0, 1), cell, 0, (0,),
                            chest.SMOOTH_3TAP)
    with pytest.raises(ValueError, match="CUDA tensor"):
        chest.chest_dl_cuda(grid, cell, 0, (0,), chest.SMOOTH_3TAP)
    assert trace.launch_counts() == before
