"""File-driven UE receiver (lib/examples/pdsch_ue.c analog).

Synchronizes to a capture, then decodes every subframe for one RNTI and
reports rates like pdsch_ue.c:786-827 (net/processing Mbps, BLER). The
receiver runs on the CUDA card unless ``--cpu`` is given (and raises
without a card).

  python -m empower_srslte_tpu_torch.apps.pdsch_ue -i /tmp/enb.bin
      [-p 25] [-r 0x1234] [-n 100] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time
from dataclasses import dataclass, field

import torch

from ..models.ue_dl import ue_dl_decode
from ..models.ue_sync import sync_and_align
from ..runtime.io import FileSource
from ..runtime.logging import get_logger
from ..runtime.metrics import MetricsHub, MetricsStdout
from ..utils.cell import Cell
from ..utils.device import resolve_device


@dataclass
class SubframeDecode:
    """One aligned subframe's grants: a DCI, CRC flag and TB bits per
    decoded grant (``ue_dl_decode`` results that carry a DCI)."""

    sf_idx: int
    dci: list = field(default_factory=list)
    crc_ok: list = field(default_factory=list)
    tb_bits: list = field(default_factory=list)
    #: host-clock ms of the ``ue_dl_decode`` call, up to a synchronize
    ms: float = 0.0


@dataclass
class UeRun:
    """What ``receive`` found and decoded on a capture."""

    cell_id: int
    cfo: float
    sf0_offset: int
    metric: float
    subframes: list[SubframeDecode]
    blocks: int
    errors: int
    bits_ok: int
    #: the metrics reported every 10 subframes (sf, net_mbps, proc_mbps,
    #: bler)
    reports: list[dict]


def receive(samples, nof_prb: int = 25, rnti: int = 0x1234,
            max_subframes: int = 100, *, device=None, hub=None,
            log=None) -> UeRun:
    """Sync to ``samples`` (numpy complex64 at the rate of ``nof_prb``),
    then one ``ue_dl_decode`` per aligned subframe, ``sf_idx = i % 10``
    from the first; metrics go to ``hub`` every 10 subframes."""
    device = resolve_device(device)
    res = sync_and_align(samples, cell_prb=nof_prb, device=device)
    if log is not None:
        log.info("found cell id=%d cfo=%.3f sf0@%d (metric %.2f)",
                 res.cell_id, res.cfo, res.sf0_offset, res.metric)
    cell = Cell(nof_prb=nof_prb, id=res.cell_id)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    out, reports = [], []
    bits_ok = blocks = errors = 0
    t0 = time.time()
    nof = min(len(res.subframes), max_subframes)
    for i in range(nof):
        sf_idx = i % 10
        if log is not None:
            log.step(i)
        t_sf = time.perf_counter()
        decoded = ue_dl_decode(res.subframes[i], cell, sf_idx, rnti)
        sync()
        sf = SubframeDecode(sf_idx=sf_idx,
                            ms=(time.perf_counter() - t_sf) * 1e3)
        for r in decoded:
            if r.dci is None:
                continue
            blocks += 1
            sf.dci.append(r.dci)
            sf.crc_ok.append(r.crc_ok)
            sf.tb_bits.append(r.tb_bits)
            if r.crc_ok:
                bits_ok += len(r.tb_bits)
            else:
                errors += 1
        out.append(sf)
        if (i + 1) % 10 == 0:
            dt = time.time() - t0
            reports.append({
                "sf": i + 1,
                "net_mbps": bits_ok / (i + 1) / 1e3,   # per 1ms subframe
                "proc_mbps": bits_ok / dt / 1e6,
                "bler": errors / max(blocks, 1),
            })
            if hub is not None:
                hub.report(reports[-1])
    return UeRun(cell_id=res.cell_id, cfo=res.cfo, sf0_offset=res.sf0_offset,
                 metric=res.metric, subframes=out, blocks=blocks,
                 errors=errors, bits_ok=bits_ok, reports=reports)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-p", "--nof-prb", type=int, default=25)
    ap.add_argument("-r", "--rnti", type=lambda x: int(x, 0), default=0x1234)
    ap.add_argument("-n", "--max-subframes", type=int, default=100)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    log = get_logger("UE", "info")
    hub = MetricsHub()
    hub.add_listener(MetricsStdout())

    samples = FileSource(args.input).read_all()
    log.info("capture: %d samples", len(samples))
    run = receive(samples, args.nof_prb, args.rnti, args.max_subframes,
                  device=device, hub=hub, log=log)
    log.info("done: %d subframes, %d TBs, BLER %.3f",
             len(run.subframes), run.blocks,
             run.errors / max(run.blocks, 1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
