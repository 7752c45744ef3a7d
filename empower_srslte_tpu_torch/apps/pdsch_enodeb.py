"""eNB downlink signal generator (lib/examples/pdsch_enodeb.c analog).

Composes frames with CRS + PSS/SSS + PBCH(MIB) + PCFICH + PDCCH(DCI 1A) +
PDSCH for one RNTI and writes the IQ samples to a file or UDP sink. The
grids are built on the CUDA card unless ``--cpu`` is given (and the run
raises without a card); the transport blocks are numpy draws from
``default_rng(0)``, one per subframe in order, so a run writes the same
TBs as the JAX package's ``apps/pdsch_enodeb.py`` with the same flags.

  python -m empower_srslte_tpu_torch.apps.pdsch_enodeb -o /tmp/enb.bin
      [-p 25] [-c 1] [-m 10] [-r 0x1234] [-f 10] [--cfi 2] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..models import dci as dci_mod
from ..models import ra
from ..models.enb_dl import (enb_dl_base_grid, enb_dl_gen_signal,
                             put_sync_signals)
from ..models.pbch import mib_pack, pbch_put
from ..models.pcfich import pcfich_put
from ..models.pdcch import pdcch_encode
from ..models.pdsch import PdschConfig, pdsch_encode
from ..runtime.io import FileSink, NetSink
from ..runtime.logging import get_logger
from ..utils.cell import Cell
from ..utils.device import resolve_device


def grant(nof_prb: int, mcs: int):
    """The generator's downlink grant: (modulation, TBS, PRB mask) of PRBs
    0 .. nof_prb - 3 at ``mcs``."""
    prb_len = nof_prb - 2
    mod, tbs = ra.mcs_to_tbs(mcs, prb_len)
    return mod, tbs, ra.prb_mask_type2(nof_prb, 0, prb_len)


def tb_draws(tbs: int):
    """The transport blocks a run sends, one per subframe in order:
    [1, tbs] int8 each, from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    while True:
        yield rng.integers(0, 2, size=(1, tbs)).astype(np.int8)


def generate(output: str, nof_prb: int = 25, cell_id: int = 1,
             mcs: int = 10, rnti: int = 0x1234, nof_frames: int = 10,
             cfi: int = 2, *, device=None, log=None) -> dict:
    """Write ``nof_frames`` frames to ``output`` (a file, or
    ``udp:host:port``). -> dict(tbs, nof_subframes, nof_samples)."""
    device = resolve_device(device)
    cell = Cell(nof_prb=nof_prb, id=cell_id)
    mod, tbs, mask = grant(nof_prb, mcs)
    draws = tb_draws(tbs)

    if output.startswith("udp:"):
        _, host, port = output.split(":")
        sink = NetSink(host, int(port))
    else:
        sink = FileSink(output)

    if log is not None:
        log.info("cell: %d PRB, id %d; PDSCH mcs=%d tbs=%d rnti=0x%x",
                 cell.nof_prb, cell.id, mcs, tbs, rnti)
    dci_payload = torch.as_tensor(
        dci_mod.pack_format1a(cell.nof_prb, 0, nof_prb - 2, mcs),
        device=device)
    nof_samples = 0
    try:
        for sfn in range(nof_frames):
            for sf_idx in range(10):
                if log is not None:
                    log.step(10 * sfn + sf_idx)
                grid = enb_dl_base_grid(cell, sf_idx, (), device=device)
                grid = put_sync_signals(grid, cell, sf_idx)
                grid = pcfich_put(grid, cfi, cell, sf_idx)
                if sf_idx == 0:
                    grid = pbch_put(grid, torch.as_tensor(mib_pack(
                        cell.nof_prb, 0, 1, sfn), device=device), cell,
                        sfn=sfn)
                cfg = PdschConfig(cell=cell, sf_idx=sf_idx, cfi=cfi,
                                  rnti=rnti, mod=mod, prb_mask=mask)
                plan = cfg.plan(tbs)
                tb = torch.as_tensor(next(draws), device=device)
                grid = grid + pdcch_encode(dci_payload, rnti, 0, 4, cell,
                                           cfi, sf_idx)
                grid = grid + pdsch_encode(tb, cfg, plan)[0]
                iq = enb_dl_gen_signal(grid, cell)[0].cpu().numpy()
                sink.write(iq)
                nof_samples += len(iq)
    finally:
        sink.close()
    return dict(tbs=tbs, nof_subframes=10 * nof_frames,
                nof_samples=nof_samples)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", required=True,
                    help="IQ file or udp:host:port")
    ap.add_argument("-p", "--nof-prb", type=int, default=25)
    ap.add_argument("-c", "--cell-id", type=int, default=1)
    ap.add_argument("-m", "--mcs", type=int, default=10)
    ap.add_argument("-r", "--rnti", type=lambda x: int(x, 0), default=0x1234)
    ap.add_argument("-f", "--nof-frames", type=int, default=10)
    ap.add_argument("--cfi", type=int, default=2)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    log = get_logger("ENB", "info")
    generate(args.output, args.nof_prb, args.cell_id, args.mcs, args.rnti,
             args.nof_frames, args.cfi, device=device, log=log)
    log.info("wrote %d frames to %s", args.nof_frames, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
