"""The port's end-to-end receiver BLER sweep (``empower_srslte_tpu_torch/
tools/rx_bler_sweep.py``) on the CPU.

The chain of the JAX tool (``tools/rx_bler_sweep.py:58-78``: compose +
CRS -> iFFT -> AWGN scaled by each subframe's power -> FFT -> LS chest
off the CRS -> pilot noise estimate, its batch mean -> equalize ->
decode) is rebuilt here from the JAX package's functions under one
``jax.jit`` per MCS, and fed the same numpy inputs as the port's
``receive``: 8 subframes of 6 PRB (where every code block of the three
MCS has a turbo window), one SNR below and one above that width's
waterfall. Both packages decode in float32 on their XLA sweeps
(``decoder_impl="xla"``), the classic path: the CRC flags must be equal,
and the bits where the CRC passes. Also: the tool's table and JSON, the
gate's two rules on synthetic curves, and that the tool imports nothing
of JAX. The BLER gate itself runs on the card (``chip_smoke.py`` phase
``rx_bler_gate``).
"""

import ast
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from empower_srslte_tpu.models import ra as jra
from empower_srslte_tpu.models.enb_dl import enb_dl_base_grid as jbase
from empower_srslte_tpu.models.enb_dl import enb_dl_gen_signal as jgen
from empower_srslte_tpu.models.pdsch import PdschConfig as JCfg
from empower_srslte_tpu.models.pdsch import pdsch_decode as jdecode
from empower_srslte_tpu.models.pdsch import pdsch_encode as jencode
from empower_srslte_tpu.ops.chest import chest_dl as jchest
from empower_srslte_tpu.ops.chest import noise_est_pilots as jnoise
from empower_srslte_tpu.ops.ofdm import ofdm_rx_sf as jofdm_rx
from empower_srslte_tpu.utils.cell import Cell as JCell

from empower_srslte_tpu_torch import convert
from empower_srslte_tpu_torch.models.sch import _pick_window
from empower_srslte_tpu_torch.tools import bler_sweep, rx_bler_sweep

PRB, BATCH = 6, 8
#: per MCS one SNR (dB) below and one above the 6-PRB waterfall
POINTS = {4: (-5.0, -2.0), 12: (1.5, 4.5), 22: (9.5, 12.5)}


def _jax_chain(cell, cfg, plan):
    """``tools/rx_bler_sweep.py``'s ``chain``, returning the bits too."""

    @jax.jit
    def chain(tb_bits, nz_re, nz_im, inv_snr):
        base = jbase(cell, 1, (1,))
        grid = base + jencode(tb_bits, cfg, plan)
        samples = jax.vmap(lambda g: jgen(g, cell).reshape(-1))(grid)
        p = jnp.mean(jnp.abs(samples) ** 2, axis=-1, keepdims=True)
        sigma = jnp.sqrt(p * inv_snr / 2.0)
        noisy = samples + sigma * jax.lax.complex(nz_re, nz_im)
        rx = jax.vmap(lambda s: jofdm_rx(s, cell))(noisy)
        rx = rx.reshape(rx.shape[0], cell.nsymb_sf, -1)
        h = jchest(rx, cell, 1)
        n0 = jnoise(rx, cell, 1)
        bits, ok, _ = jdecode(rx[:, None], h[:, None, None], cfg, plan,
                              noise_est=jnp.mean(n0))
        return bits, ok

    return chain


@pytest.mark.parametrize("mcs", sorted(POINTS))
def test_receiver_chain_matches_jax(mcs):
    rng = np.random.default_rng(mcs)
    jcell = JCell(nof_prb=PRB, id=rx_bler_sweep.CELL_ID)
    mod, tbs = jra.mcs_to_tbs(mcs, PRB)
    jcfg = JCfg(cell=jcell, sf_idx=rx_bler_sweep.SF_IDX,
                cfi=rx_bler_sweep.CFI, mod=mod)
    jplan = jcfg.plan(tbs, decoder_impl="xla")
    cfg = convert.pdsch_config_from_fields(vars(jcfg))
    plan = cfg.plan(tbs, decoder_impl="xla")
    assert plan == convert.dlsch_plan_from_fields(vars(jplan))
    assert all(_pick_window(k) for k in plan.segm.cb_sizes)
    chain = _jax_chain(jcell, jcfg, jplan)
    tb = rng.integers(0, 2, size=(BATCH, tbs)).astype(np.int8)
    passed = []
    for snr in POINTS[mcs]:
        nz, nz2 = (rng.normal(size=(BATCH, jcell.sf_sample_len))
                   .astype(np.float32) for _ in range(2))
        inv = np.float32(10 ** (-snr / 10))
        jbits, jok = (np.asarray(x) for x in chain(
            jnp.asarray(tb), jnp.asarray(nz), jnp.asarray(nz2), inv))
        bits, ok = rx_bler_sweep.receive(
            torch.as_tensor(tb), torch.as_tensor(nz), torch.as_tensor(nz2),
            float(inv), cfg, {"xla": plan})["xla"]
        np.testing.assert_array_equal(ok.numpy(), jok)
        np.testing.assert_array_equal(bits.numpy()[jok], jbits[jok])
        np.testing.assert_array_equal(bits.numpy()[jok], tb[jok])
        passed.append(int(jok.sum()))
    # one point on each side of the waterfall
    assert passed[0] < BATCH // 2 < passed[1], passed


def test_tool_prints_the_jax_table_and_a_json_line(capsys):
    assert rx_bler_sweep.main(["--cpu", "2", "6", "--seed", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    res = json.loads(lines[-1])
    assert (res["batch"], res["prb"], res["seed"], res["device"]) == (
        2, 6, 3, "cpu")
    assert lines[0] == ("# full receiver (chest off CRS), 6 PRB SISO, "
                        "batch 2 subframes per point")
    assert lines[2].split() == ["mcs", "snr_db", "bler", "tbs"]
    rows = [ln.split() for ln in lines[3:-1]]
    grid = [(m, x) for m, xs in rx_bler_sweep.SWEEPS for x in xs]
    assert [(int(r[0]), float(r[1])) for r in rows] == grid
    assert [c["mcs"] for c in res["curves"]] == [4, 12, 22]
    for c, (mcs, snrs) in zip(res["curves"], rx_bler_sweep.SWEEPS):
        assert c["dtype"] == "auto" and c["snr_db"] == list(snrs)
        assert c["bler"] == [f / 2 for f in c["failed"]]
        assert c["tbs"] == int(rows[grid.index((mcs, snrs[0]))][3])


def _curves(grid, blers, n):
    return {"batch": n, "curves": [
        {"mcs": mcs, "dtype": dt, "snr_db": list(grid[mcs]),
         "bler": list(blers[mcs][dt]),
         "crossing_10pct_db": rx_bler_sweep.crossing_db(grid[mcs],
                                                       blers[mcs][dt])}
        for mcs in grid for dt in rx_bler_sweep.DTYPES]}


def _erfc_curve(x0, grid, slope=4.0):
    from math import erfc
    return [0.5 * erfc(slope * (x - x0)) for x in grid]


@pytest.mark.parametrize("shift,ok", [(0.05, True), (0.3, False)])
def test_gate_rules_on_synthetic_curves(shift, ok):
    """(a) the float32 parity curves at ``JAX_RX_BLER`` pass, one 5/64 off
    fails; (b) an "auto" curve shifted 0.05 dB right of its float32
    curve passes the 0.1 dB rule, one shifted 0.3 dB fails it."""
    jax_bler = {m: [f / 64 for f in v]
                for m, v in rx_bler_sweep.JAX_RX_BLER.items()}
    par_grid = dict(rx_bler_sweep.SWEEPS)
    parity = _curves(par_grid,
                     {m: {dt: jax_bler[m] for dt in rx_bler_sweep.DTYPES}
                      for m in par_grid}, 64)
    w_grid = dict(rx_bler_sweep.waterfall_sweeps())
    mid = {m: (lo + hi) / 2 for m, (lo, hi) in
           rx_bler_sweep.WATERFALL.items()}
    water = _curves(w_grid, {m: {
        "float32": _erfc_curve(mid[m], w_grid[m]),
        "auto": _erfc_curve(mid[m] + shift, w_grid[m])} for m in w_grid},
        4096)
    verdict = rx_bler_sweep.gate(parity, water)
    assert verdict["ok"] is ok, verdict["checks"]
    assert all(v for k, v in verdict["checks"].items() if "jax" in k)
    assert len(verdict["parity"]) == 18
    assert {c["mcs"] for c in verdict["comparisons"]} == {4, 12, 22}
    assert set(verdict["crossings_10pct_db"]) == {4, 12, 22}
    if not ok:
        assert [k for k, v in verdict["checks"].items() if not v] == [
            f"mcs{m}_auto_within_0.1db" for m in (4, 12, 22)]
    # the same rule as the turbo BLER gate
    f32, auto = water["curves"][0], water["curves"][1]
    assert [r[3] for r in bler_sweep.within_shift(
        f32["snr_db"], f32["bler"], auto["bler"], 4096)] == [
        c["limit"] for c in verdict["comparisons"] if c["mcs"] == 4]
    off = json.loads(json.dumps(parity))
    off["curves"][0]["bler"][1] += 5 / 64
    assert not rx_bler_sweep.gate(off, water)["checks"][
        "mcs4_float32_matches_jax"]


def test_float32_plan_pins_the_decoders():
    plan = rx_bler_sweep.PdschConfig(
        cell=rx_bler_sweep.Cell(nof_prb=PRB)).plan(408)
    pinned = rx_bler_sweep.float32_plan(plan)
    k = plan.segm.cb_sizes[0]
    assert plan.decoder(k).metric_dtype == torch.bfloat16
    assert pinned.decoder(k).metric_dtype == torch.float32
    assert pinned.cb_plans == plan.cb_plans


def test_tool_refuses_to_fall_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rx_bler_sweep.main(["2", "6"])


def test_tool_imports_nothing_of_jax():
    tree = ast.parse(pathlib.Path(rx_bler_sweep.__file__).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names
                if m.split(".")[0] in ("jax", "empower_srslte_tpu")]
