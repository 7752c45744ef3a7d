"""Cell scanner over a capture (lib/examples/cell_search.c analog):
PSS/SSS scan for all N_id_2 + MIB decode. Runs on the CUDA card unless
``--cpu`` is given (and raises without a card).

  python -m empower_srslte_tpu_torch.apps.cell_search -i /tmp/enb.bin
      [-p 6] [--cpu]
"""

from __future__ import annotations

import argparse
import sys

from ..models.ue_dl import ue_mib_decode
from ..models.ue_sync import sync_and_align
from ..runtime.io import FileSource
from ..runtime.logging import get_logger
from ..utils.device import resolve_device


def search(samples, nof_prb: int = 6, *, device=None) -> dict:
    """The cell in ``samples`` (numpy complex64 at the rate of
    ``nof_prb``): dict(cell_id, n_id_1, n_id_2, cfo, metric, mib). The MIB
    is decoded at 6 PRB only (the MIB acquisition rate); ``mib`` is None
    otherwise, or when the PBCH decode fails."""
    res = sync_and_align(samples, cell_prb=nof_prb,
                         device=resolve_device(device))
    mib = None
    if nof_prb == 6 and len(res.subframes) > 0:
        mib = ue_mib_decode(res.subframes[0], res.cell_id)
    return dict(cell_id=res.cell_id, n_id_1=res.cell_id // 3,
                n_id_2=res.n_id_2, cfo=res.cfo, metric=res.metric, mib=mib)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-i", "--input", required=True)
    ap.add_argument("-p", "--nof-prb", type=int, default=6,
                    help="search bandwidth (6 = MIB acquisition rate)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)

    log = get_logger("SRCH", "info")
    samples = FileSource(args.input).read_all()
    found = search(samples, args.nof_prb, device=device)
    log.info("cell id %d (N_id_1=%d, N_id_2=%d), CFO %.1f Hz, metric %.2f",
             found["cell_id"], found["n_id_1"], found["n_id_2"],
             found["cfo"] * 15e3, found["metric"])
    mib = found["mib"]
    if mib:
        log.info("MIB: %d PRB, %d ports, SFN %d",
                 mib["nof_prb"], mib["nof_ports"], mib["sfn_msb"] * 4
                 + mib["sfn_mod4"])
    elif args.nof_prb == 6:
        log.warning("PBCH decode failed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
