"""Weak-scaling sweep of the sharded 20 MHz TM4 step on the port.

    python3 -m empower_srslte_tpu_torch.tools.scaling_sweep
        [--max-devices 8] [--reps 3] [--virtual N] [--prb 100] [--cpu]

Counterpart of the JAX package's ``tools/scaling_sweep.py``: the TM4
two-codeword encode -> flat 2x2 channel -> decode step of the multi-chip
dry run (Cell(``prb`` PRB, 2 ports, id 1), MCS 18, 2 layers, PMI 0, the
fixed channel ``HM``, noise estimate 1e-4, the plan's decoder ``"xla"``
as the JAX tool pins it) at 1, 2, 4 and 8 devices up to
``--max-devices``, one subframe per device on a (carrier, sf) mesh
(``parallel/mesh.py make_mesh``), its TBs placed by ``shard_batch`` and
the step run per shard by ``smap``. Every CRC must pass at every n. It
prints the JAX tool's table (devices, mesh, subframes per step, ms per
step, subframes/s, Mbps) and then one JSON object.

The devices are the visible CUDA cards (raising without one), as the JAX
tool takes ``jax.devices()``; ``--virtual N`` builds the mesh from the
first of them repeated N times (the counterpart of JAX's
``xla_force_host_platform_device_count``), and ``--cpu`` from the CPU
(``--max-devices`` times unless ``--virtual`` says). The shards of a
mesh run in turn in this process (ROADMAP difference 20), and the
``"xla"`` plan decodes on the plain sweeps, so the times are host-bound.
``--prb`` narrows the cell for a quick run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..models import ra
from ..models.pdsch import PdschConfig, pdsch_decode, pdsch_encode
from ..ops.equalizer import MimoType
from ..parallel import make_mesh, shard_batch
from ..parallel.mesh import smap, visible_devices
from ..utils.cell import Cell

#: the flat 2x2 channel of the JAX tool's step (rx x port)
HM = ((0.9 + 0.1j, 0.2 - 0.1j), (-0.15 + 0.2j, 0.85 - 0.05j))
MCS, NOISE_EST = 18, 1e-4
#: the mesh sizes of the JAX tool
SIZES = (1, 2, 4, 8)


def build_step(prb: int = 100):
    """-> (step, tbs): ``step(tb [..., tbs], tb2 [..., tbs]) -> crc_ok
    [...]``, both codewords' CRCs passed, on the inputs' device."""
    cell = Cell(nof_prb=prb, nof_ports=2, id=1)
    mod, tbs = ra.mcs_to_tbs(MCS, prb)
    cfg = PdschConfig(cell=cell, sf_idx=1, cfi=1, mod=mod,
                      mimo=MimoType.SPATIAL_MUX, nof_layers=2,
                      nof_codewords=2, pmi=0)
    plan = cfg.plan(tbs, decoder_impl="xla")

    def step(tb, tb2):
        ports = pdsch_encode(tb, cfg, plan, tb2, plan)
        hm = torch.tensor(HM, dtype=torch.complex64, device=tb.device)
        rx = torch.einsum("rp,...psk->...rsk", hm, ports)
        h = hm[:, :, None, None].expand(*tb.shape[:-1], 2, 2, cell.nsymb_sf,
                                        cell.nof_re)
        _bits, (ok1, ok2), _ = pdsch_decode(rx, h, cfg, plan,
                                            noise_est=NOISE_EST, plan2=plan)
        return ok1 & ok2

    return step, tbs


def _sync(devices) -> None:
    for d in {torch.device(x) for x in devices}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def sweep(devices, max_devices: int = 8, reps: int = 3,
          prb: int = 100) -> dict:
    """The step at each n of ``SIZES`` up to ``max_devices`` and
    ``len(devices)``, on ``make_mesh(n, devices=devices)``, one subframe
    per shard; TBs from ``np.random.default_rng(0)`` in the JAX tool's
    order (per n, both codewords' [carrier, sf, tbs]). Raises if a CRC
    fails. -> {"prb", "tbs", "reps", "rows": [{"devices", "mesh",
    "shards", "device_list", "sf_per_step", "ms_per_step", "sf_per_s",
    "mbps", "crc_ok"}]}."""
    step, tbs = build_step(prb)
    rng = np.random.default_rng(0)
    rows = []
    for n in SIZES:
        if n > min(len(devices), max_devices):
            break
        mesh = make_mesh(n, devices=devices)
        n_car, n_sf = mesh.shape["carrier"], mesh.shape["sf"]
        tb = rng.integers(0, 2, size=(n_car, n_sf, tbs)).astype(np.int8)
        tb2 = rng.integers(0, 2, size=(n_car, n_sf, tbs)).astype(np.int8)
        tb_s = shard_batch(mesh, torch.as_tensor(tb))
        tb2_s = shard_batch(mesh, torch.as_tensor(tb2))
        out = smap(step, tb_s, tb2_s)
        ok = np.zeros((n_car, n_sf), dtype=bool)
        for (c, s), flags in out.items():
            ok[c, s] = bool(flags.all())
        if not ok.all():
            raise RuntimeError(f"CRC failed at n={n}: {ok.tolist()}")
        used = [str(mesh.devices[c]) for c in mesh.local()]
        _sync(used)
        t0 = time.perf_counter()
        for _ in range(reps):
            smap(step, tb_s, tb2_s)
        _sync(used)
        dt = (time.perf_counter() - t0) / reps
        sfs = n_car * n_sf
        rows.append({"devices": n, "mesh": [n_car, n_sf],
                     "shards": len(out), "device_list": used,
                     "sf_per_step": sfs, "ms_per_step": dt * 1e3,
                     "sf_per_s": sfs / dt, "mbps": sfs * 2 * tbs / dt / 1e6,
                     "crc_ok": ok.tolist()})
    return {"prb": prb, "tbs": tbs, "reps": reps, "rows": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-devices", type=int, default=8)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--virtual", type=int, default=None, metavar="N",
                    help="the first device, N times")
    ap.add_argument("--prb", type=int, default=100)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    devices = ([torch.device("cpu")] * args.max_devices if args.cpu
               else visible_devices())
    if args.virtual:
        devices = [devices[0]] * args.virtual
    res = sweep(devices, args.max_devices, args.reps, args.prb)
    print(f"{'devices':>8} {'mesh':>8} {'sf/step':>8} {'ms/step':>9} "
          f"{'sf/s':>9} {'Mbps':>8}")
    for r in res["rows"]:
        mesh = f"{r['mesh'][0]}x{r['mesh'][1]}"
        print(f"{r['devices']:>8} {mesh:>8} {r['sf_per_step']:>8} "
              f"{r['ms_per_step']:>9.1f} {r['sf_per_s']:>9.1f} "
              f"{r['mbps']:>8.1f}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
