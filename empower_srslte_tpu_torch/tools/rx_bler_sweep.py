"""End-to-end receiver BLER vs SNR over AWGN on the port.

    python3 -m empower_srslte_tpu_torch.tools.rx_bler_sweep [batch=64]
        [prb=50] [--seed S] [--dtype {auto,float32}] [--gate] [--cpu]

Counterpart of the JAX package's ``tools/rx_bler_sweep.py``: the whole
downlink chain per subframe (compose grid + CRS -> iFFT -> AWGN at sample
level, scaled by each subframe's mean power -> FFT -> LS channel
estimation off the CRS -> pilot noise estimate, its batch mean ->
equalize -> decode) on a cell of ``prb`` PRB, 1 port, id 1, sf 1, cfi 1,
swept over SNR for the JAX tool's three MCS (``SWEEPS``). The inputs come
from one ``np.random.default_rng(seed)`` in the JAX tool's order (per MCS
the TB bits, then per SNR the real and imaginary noise), so with the
same ``batch``, ``prb`` and seed the receiver gets the JAX tool's
numbers. It prints the JAX tool's table (one per turbo metric
precision), then one JSON object.

``--dtype`` picks the turbo metric precision: ``"auto"`` (the default:
bfloat16 on the NII kernel wherever the code block has a window) or
``"float32"`` (``float32_plan``). ``--gate`` runs ``gate_passes`` and
``gate`` instead: both precisions on the same noise, at the JAX tool's
own inputs (64 subframes, 50 PRB, seed 0) and across each waterfall in
0.1 dB steps (``WATERFALL``, ``WATERFALL_N`` subframes a point, seed
1); the gate holds the float32 curves to ``JAX_RX_BLER`` and each
``"auto"`` curve within 0.1 dB of its float32 curve, and the tool exits
1 when it fails.

Runs on the CUDA card unless given ``--cpu`` (there the kernels' plain
twins decode, slowly: use a small batch and width).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import sys

import numpy as np
import torch

from ..models import ra
from ..models.enb_dl import enb_dl_base_grid, enb_dl_gen_signal
from ..models.pdsch import PdschConfig, pdsch_decode, pdsch_encode
from ..models.sch import DlschPlan
from ..ops.chest import chest_dl_ports
from ..ops.ofdm import ofdm_rx_sf
from ..utils.cell import Cell
from ..utils.device import resolve_device
from .bler_sweep import SHIFT_DB, within_shift

#: MCS and the SNR grids bracketing each waterfall (QPSK r~1/3, 16QAM
#: r~1/2, 64QAM r~3/4 operating points): tools/rx_bler_sweep.py:36-40
SWEEPS = [
    (4, (-4.0, -3.0, -2.0, -1.0, 0.0, 1.0)),
    (12, (2.0, 3.0, 4.0, 5.0, 6.0, 7.0)),
    (22, (10.0, 11.0, 12.0, 13.0, 14.0, 15.0)),
]
#: the JAX package's BLERs on ``SWEEPS`` at batch 64, 50 PRB, seed 0, as
#: failed subframes of 64 per point: ``JAX_PLATFORMS=cpu python
#: tools/rx_bler_sweep.py 64 50`` on the CPU (its classic path, float32
#: XLA turbo decode), the JAX package as of commit 0d9f11c
JAX_RX_BLER = {4: (64, 2, 0, 0, 0, 0), 12: (64, 41, 0, 0, 0, 0),
               22: (63, 3, 0, 0, 0, 0)}
JAX_BATCH, JAX_PRB, JAX_SEED = 64, 50, 0
#: per MCS the gate's waterfall pass: first and last SNR (dB), 0.1 dB
#: steps, around where ``JAX_RX_BLER`` puts each edge
WATERFALL = {4: (-4.0, -2.6), 12: (2.6, 4.0), 22: (10.0, 11.6)}
WATERFALL_STEP_DB = 0.1
#: subframes per waterfall point, and the waterfall pass's seed
WATERFALL_N, WATERFALL_SEED = 4096, 1
#: the precisions: ``"auto"`` (bfloat16 on the NII kernel where the code
#: block has a window) and ``"float32"``
DTYPES = ("float32", "auto")
#: cell id, subframe and CFI of every subframe (the JAX tool's)
CELL_ID, SF_IDX, CFI = 1, 1, 1


class Float32Plan(DlschPlan):
    """A ``DlschPlan`` whose turbo decoders are pinned to
    ``TurboDecoder.dtype = "float32"`` (the JAX plan has no dtype field,
    so the port's plan gains none)."""

    def decoder(self, k):
        return dataclasses.replace(super().decoder(k), dtype="float32")


def float32_plan(plan: DlschPlan) -> Float32Plan:
    """``plan`` with its turbo decoders pinned to float32."""
    return Float32Plan(**{f.name: getattr(plan, f.name)
                          for f in dataclasses.fields(plan)})


def _plan(cfg: PdschConfig, tbs: int, dtype: str) -> DlschPlan:
    plan = cfg.plan(tbs)
    return float32_plan(plan) if dtype == "float32" else plan


def receive(tb, nz_re, nz_im, inv_snr: float, cfg: PdschConfig,
            plans: dict) -> dict:
    """One batch through the chain of ``tools/rx_bler_sweep.py:58-78``:
    tb [B, tbs] int8, nz_re / nz_im [B, sf_sample_len] float32 unit
    normals, ``inv_snr`` the noise power over each subframe's mean power.
    The front end runs once; each plan of ``plans`` (name -> plan)
    decodes the same received grids. -> {name: (bits [B, tbs], crc_ok
    [B])}."""
    cell = cfg.cell
    b = tb.shape[0]
    base = enb_dl_base_grid(cell, cfg.sf_idx, (1,), device=tb.device)
    grid = base + pdsch_encode(tb, cfg, next(iter(plans.values())))
    samples = enb_dl_gen_signal(grid, cell).reshape(b, -1)
    p = torch.mean(samples.abs() ** 2, dim=-1, keepdim=True)
    sigma = torch.sqrt(p * inv_snr / 2.0)
    noisy = samples + sigma * torch.complex(nz_re, nz_im)
    rx = ofdm_rx_sf(noisy, cell).reshape(b, cell.nsymb_sf, -1)
    h, noise = chest_dl_ports(rx, cell, cfg.sf_idx, (0,))
    h = h[..., 0, :, :]
    noise = torch.mean(noise[..., 0])
    out = {}
    for name, plan in plans.items():
        bits, ok, _ = pdsch_decode(rx[:, None], h[:, None, None], cfg, plan,
                                   noise_est=noise)
        out[name] = (bits, ok)
    return out


def crossing_db(snrs, bler, level: float = 0.1):
    """The SNR (dB) where a falling BLER curve first reaches ``level``,
    linear between the grid points around it; None if it never crosses
    from above."""
    for i in range(1, len(snrs)):
        if bler[i - 1] > level >= bler[i]:
            x0, x1, y0, y1 = snrs[i - 1], snrs[i], bler[i - 1], bler[i]
            return x0 + (y0 - level) / (y0 - y1) * (x1 - x0)
    return None


def sweep(batch: int = JAX_BATCH, prb: int = JAX_PRB, seed: int = JAX_SEED,
          dtypes=("auto",), sweeps=SWEEPS, device=None,
          host_draws: bool = True) -> dict:
    """BLER per MCS and SNR of ``sweeps`` ([(mcs, snrs)]) at each
    precision of ``dtypes``, ``batch`` subframes a point, all precisions
    on the same noise. ``host_draws``: the inputs from
    ``np.random.default_rng(seed)`` in the JAX tool's order (so that they
    equal the JAX tool's); else from a ``torch.Generator`` seeded with
    ``seed`` on the device (the same chain, drawn where it runs).
    -> {"batch", "prb", "seed", "device", "curves": [{"mcs", "tbs",
    "dtype", "snr_db", "failed", "bler", "crossing_10pct_db"}]}."""
    dev = resolve_device(device)
    cell = Cell(nof_prb=prb, id=CELL_ID)
    rng = np.random.default_rng(seed)
    gen = None if host_draws else torch.Generator(device=dev).manual_seed(
        seed)

    def draw(shape, bits: bool):
        if gen is not None:
            if bits:
                return torch.randint(0, 2, shape, generator=gen, device=dev,
                                     dtype=torch.int8)
            return torch.randn(shape, generator=gen, device=dev)
        x = (rng.integers(0, 2, size=shape).astype(np.int8) if bits
             else rng.normal(size=shape).astype(np.float32))
        return torch.as_tensor(x, device=dev)

    curves = []
    for mcs, snrs in sweeps:
        mod, tbs = ra.mcs_to_tbs(mcs, prb)
        cfg = PdschConfig(cell=cell, sf_idx=SF_IDX, cfi=CFI, mod=mod)
        plans = {dt: _plan(cfg, tbs, dt) for dt in dtypes}
        tb = draw((batch, tbs), bits=True)
        failed = {dt: [] for dt in dtypes}
        for snr in snrs:
            nz = draw((batch, cell.sf_sample_len), bits=False)
            nz2 = draw((batch, cell.sf_sample_len), bits=False)
            inv = float(np.float32(10 ** (-snr / 10)))
            for dt, (_bits, ok) in receive(tb, nz, nz2, inv, cfg,
                                           plans).items():
                failed[dt].append(int(batch - ok.sum()))
        for dt in dtypes:
            bler = [f / batch for f in failed[dt]]
            curves.append({"mcs": mcs, "tbs": tbs, "dtype": dt,
                           "snr_db": [float(x) for x in snrs],
                           "failed": failed[dt], "bler": bler,
                           "crossing_10pct_db": crossing_db(snrs, bler)})
    return {"batch": batch, "prb": prb, "seed": seed, "device": str(dev),
            "curves": curves}


def waterfall_sweeps(step: float = WATERFALL_STEP_DB) -> list:
    """``WATERFALL``'s grids as ``sweep``'s ``sweeps``."""
    return [(mcs, tuple(round(lo + i * step, 1) for i in
                        range(int(round((hi - lo) / step)) + 1)))
            for mcs, (lo, hi) in WATERFALL.items()]


def gate_passes(device=None) -> tuple:
    """The gate's two passes, both precisions on the same noise each:
    the JAX tool's own inputs (``JAX_BATCH`` subframes at ``JAX_PRB``
    PRB, seed ``JAX_SEED``, ``SWEEPS``), then ``WATERFALL`` in 0.1 dB
    steps at ``WATERFALL_N`` subframes a point (seed ``WATERFALL_SEED``,
    drawn on the device). -> (parity, waterfall) ``sweep`` results."""
    parity = sweep(JAX_BATCH, JAX_PRB, JAX_SEED, DTYPES, SWEEPS, device)
    water = sweep(WATERFALL_N, JAX_PRB, WATERFALL_SEED, DTYPES,
                  waterfall_sweeps(), device, host_draws=False)
    return parity, water


def gate(parity: dict, water: dict) -> dict:
    """The receiver's gate on ``gate_passes``' results.

    (a) Per MCS, the float32 curve of the parity pass lies within
        max(3 sigma, 2/64) of ``JAX_RX_BLER`` at every point, sigma the
        binomial sigma of the JAX value at 64 subframes.
    (b) Per MCS, the ``"auto"`` curve of the waterfall pass lies within
        ``SHIFT_DB`` of its float32 curve by ``bler_sweep.within_shift``'s
        rule, and that rule compared at least one point.
    -> {"ok", "checks", "parity": [...], "comparisons": [...],
    "crossings_10pct_db": {mcs: {pass: {dtype: dB}}}}."""
    checks, par, comps = {}, [], []
    by = {(p, c["mcs"], c["dtype"]): c
          for p, res in (("parity", parity), ("waterfall", water))
          for c in res["curves"]}
    for mcs, jax_failed in JAX_RX_BLER.items():
        c = by[("parity", mcs, "float32")]
        ok = True
        for x, got, f in zip(c["snr_db"], c["bler"], jax_failed):
            want = f / JAX_BATCH
            tol = max(3.0 * math.sqrt(want * (1.0 - want) / JAX_BATCH),
                      2.0 / JAX_BATCH)
            par.append({"mcs": mcs, "snr_db": x, "bler_float32": got,
                        "bler_jax": want, "tol": tol,
                        "ok": abs(got - want) <= tol})
            ok &= abs(got - want) <= tol
        checks[f"mcs{mcs}_float32_matches_jax"] = bool(ok)
        f32, auto = by[("waterfall", mcs, "float32")], \
            by[("waterfall", mcs, "auto")]
        rows = within_shift(f32["snr_db"], f32["bler"], auto["bler"],
                            water["batch"])
        for x, got, p, limit in rows:
            comps.append({"mcs": mcs, "snr_db": x, "bler_auto": got,
                          "bler_f32_minus_shift": p, "limit": limit,
                          "ok": got <= limit})
        checks[f"mcs{mcs}_auto_within_{SHIFT_DB}db"] = bool(
            rows and all(got <= limit for _x, got, _p, limit in rows))
    crossings = {mcs: {p: {dt: by[(p, mcs, dt)]["crossing_10pct_db"]
                           for dt in DTYPES}
                       for p in ("parity", "waterfall")}
                 for mcs in JAX_RX_BLER}
    return {"ok": all(checks.values()), "checks": checks, "parity": par,
            "comparisons": comps, "crossings_10pct_db": crossings}


def print_table(res: dict, dtype: str) -> None:
    """The JAX tool's table for one precision of a ``sweep`` result."""
    print(f"# full receiver (chest off CRS), {res['prb']} PRB SISO, "
          f"batch {res['batch']} subframes per point")
    print(f"# turbo metrics {dtype}, seed {res['seed']}, {res['device']}")
    print(f"{'mcs':>4} {'snr_db':>7} {'bler':>8} {'tbs':>7}")
    for c in res["curves"]:
        if c["dtype"] != dtype:
            continue
        for snr, bler in zip(c["snr_db"], c["bler"]):
            print(f"{c['mcs']:>4} {snr:>7.1f} {bler:>8.3f} {c['tbs']:>7}",
                  flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("batch", nargs="?", type=int, default=JAX_BATCH)
    ap.add_argument("prb", nargs="?", type=int, default=JAX_PRB)
    ap.add_argument("--seed", type=int, default=JAX_SEED)
    ap.add_argument("--dtype", choices=("auto", "float32"), default="auto")
    ap.add_argument("--gate", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    if not args.gate:
        res = sweep(args.batch, args.prb, args.seed, (args.dtype,),
                    device=device)
        print_table(res, args.dtype)
        print(json.dumps(res))
        return 0
    if (args.batch, args.prb, args.seed) != (JAX_BATCH, JAX_PRB, JAX_SEED):
        ap.error(f"--gate holds the port to JAX_RX_BLER, taken at batch "
                 f"{JAX_BATCH}, {JAX_PRB} PRB, seed {JAX_SEED}")
    parity, water = gate_passes(device)
    for res in (parity, water):
        for dt in DTYPES:
            print_table(res, dt)
    verdict = gate(parity, water)
    print(json.dumps({"parity": parity, "waterfall": water,
                      "gate": verdict}))
    return 0 if verdict["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
