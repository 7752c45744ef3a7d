"""Cell measurement over a capture (lib/examples/cell_measurement.c
analog): sync to the cell, then report RSRP / RSRQ / RSSI / SNR averaged
over the capture's subframes, the way the reference's example prints its
running averages (cell_measurement.c main loop). Runs on the CUDA card
unless ``--cpu`` is given (and raises without a card).

  python -m empower_srslte_tpu_torch.apps.cell_measurement -i /tmp/enb.bin
      [-p 25] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..models.ue_sync import sync_and_align
from ..ops.chest import noise_est_pilots, rsrp, rsrq, rssi
from ..ops.ofdm import ofdm_rx_sf
from ..runtime.io import FileSource
from ..runtime.logging import get_logger
from ..utils.cell import Cell
from ..utils.device import resolve_device


def measure(subframes, cell_prb: int, cell_id: int) -> dict:
    """Batched per-subframe measurements -> capture averages (linear).

    ``subframes`` [n, sf_sample_len] complex64 on the device to measure
    on, aligned so that row 0 is subframe 0; the whole frames are kept and
    measured one batch per subframe index (each index has its own pilot
    sequence)."""
    cell = Cell(nof_prb=cell_prb, id=cell_id)
    n = subframes.shape[0] - subframes.shape[0] % 10
    subframes = subframes[:n]

    acc = {"rsrp": [], "rsrq": [], "rssi": [], "snr": []}
    for sf_idx in range(10):
        grid = ofdm_rx_sf(subframes[sf_idx::10], cell)
        p = rsrp(grid, cell, sf_idx)
        noise = noise_est_pilots(grid, cell, sf_idx)
        acc["rsrp"].append(p)
        acc["rsrq"].append(rsrq(grid, cell, sf_idx))
        acc["rssi"].append(rssi(grid))
        acc["snr"].append(p / torch.clamp(noise, min=1e-20))
    return {k: float(torch.cat(v).double().mean()) for k, v in acc.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-p", "--nof-prb", type=int, default=25)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    log = get_logger("MEAS", "info")
    samples = FileSource(args.input).read_all()
    res = sync_and_align(samples, cell_prb=args.nof_prb, device=device)
    log.info("camped on cell %d, CFO %+.1f Hz, %d subframes",
             res.cell_id, res.cfo * 15e3, res.subframes.shape[0])

    m = measure(res.subframes, args.nof_prb, res.cell_id)
    db = lambda x: 10 * np.log10(max(x, 1e-20))
    log.info("RSRP %6.2f dBfs | RSRQ %6.2f dB | RSSI %6.2f dBfs | SNR %5.2f dB",
             db(m["rsrp"]), db(m["rsrq"]), db(m["rssi"]), db(m["snr"]))
    print({k: round(db(v), 2) for k, v in m.items()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
