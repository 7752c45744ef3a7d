"""Inputs of the eNB downlink's before/after comparison.

``tests/data/enb_dl_before.npz`` holds what the port gave on these inputs
at commit ffb6975, before its PHICH followed TS 36.211 6.9 and before the
DL-SCH encoded one K at a time: each subframe's grid from
``enb_dl_subframe``, two-codeword ``pdsch_encode`` grids, and
``ue_dl_tm4_batch``'s answers and de-rate-matched LLRs on the
benchmark's tiny downlink waveform. ``tests/test_torch_enb_dl_spec.py``
holds the port to them. Everything here uses only what the port had
then as it has now.
"""

from __future__ import annotations

import numpy as np
import torch

from empower_srslte_tpu_torch.models import dci, ra
from empower_srslte_tpu_torch.models.pdcch import ue_search_candidates
from empower_srslte_tpu_torch.models.pdsch import PdschConfig
from empower_srslte_tpu_torch.models.phich import phich_resource
from empower_srslte_tpu_torch.models.regs import pdcch_nof_cces
from empower_srslte_tpu_torch.ops.equalizer import MimoType
from empower_srslte_tpu_torch.utils.cell import Cell

RNTI = 0x1234

#: (name, nof_prb, ports, cell id, sf_idx, cfi, mimo, mcs, ack, UL PRB)
SUBFRAMES = (
    ("p6_single", 6, 1, 1, 1, 2, MimoType.SINGLE, 9, 1, 1),
    ("p15_sfbc_fstd", 15, 4, 7, 3, 3, MimoType.DIVERSITY, 12, 0, 4),
    ("p25_sfbc", 25, 2, 301, 6, 1, MimoType.DIVERSITY, 17, 1, 9),
)

#: (name, nof_prb, cell id, sf_idx, cfi, mcs, batch): two-codeword TM4
#: ``pdsch_encode`` grids; 25 PRB at MCS 27 segments into K+ and K-
#: blocks with filler bits
TM4 = (("tm4_p6", 6, 1, 1, 2, 25, 2), ("tm4_p25", 25, 1, 1, 1, 27, 2))


def subframe(name: str):
    """-> (cell, sf_idx, cfi, dcis, phichs, pdschs): a format-1 grant on
    the UE's L 4 search space, a format-0 grant and one PHICH."""
    (_n, prb, ports, cid, sf, cfi, mimo, mcs, ack,
     ul_prb) = next(c for c in SUBFRAMES if c[0] == name)
    rng = np.random.default_rng(prb * 100 + sf)
    cell = Cell(nof_prb=prb, nof_ports=ports, id=cid)
    n_rbg = -(-prb // ra.rbg_size(prb))
    mod, tbs = ra.mcs_to_tbs(mcs, prb)
    cfg = PdschConfig(cell=cell, sf_idx=sf, cfi=cfi, rnti=RNTI, mod=mod,
                      mimo=mimo,
                      nof_layers=ports if mimo is MimoType.DIVERSITY else 1,
                      prb_mask=(True,) * prb)
    cands = ue_search_candidates(RNTI, sf, pdcch_nof_cces(cell, cfi))
    dl = next(c for c in cands if c[0] == 2)
    ul = next(c for c in cands if c[0] <= 2
              and (c[1] + c[0] <= dl[1] or c[1] >= dl[1] + dl[0]))
    dcis = [(dci.pack_format1(prb, (1 << n_rbg) - 1, mcs), RNTI, dl[1],
             dl[0]),
            (dci.pack_format0(prb, ul_prb, 2, 5), RNTI, ul[1], ul[0])]
    phichs = [(ack, *phich_resource(cell, ul_prb))]
    tb = torch.as_tensor(rng.integers(0, 2, tbs).astype(np.int8))
    return cell, sf, cfi, dcis, phichs, [(tb, cfg, cfg.plan(tbs))]


def tm4(name: str):
    """-> (cfg, plan, tb, tb2): ``batch`` subframes of both codewords."""
    _n, prb, cid, sf, cfi, mcs, batch = next(c for c in TM4 if c[0] == name)
    rng = np.random.default_rng(prb * 1000 + mcs)
    cell = Cell(nof_prb=prb, nof_ports=2, id=cid)
    mod, tbs = ra.mcs_to_tbs(mcs, prb)
    cfg = PdschConfig(cell=cell, sf_idx=sf, cfi=cfi, rnti=RNTI, mod=mod,
                      mimo=MimoType.SPATIAL_MUX, nof_layers=2,
                      nof_codewords=2)
    plan = cfg.plan(tbs)
    tb, tb2 = (torch.as_tensor(rng.integers(0, 2, (batch, tbs))
                               .astype(np.int8)) for _ in range(2))
    return cfg, plan, tb, tb2


#: the tiny downlink receiver cell's seed
RX_SEED = 2**31 + 41
