"""Carry the JAX package's static configuration and HARQ state into the port.

This system has no learned weights: its state is the cell/grant
configuration and the HARQ softbuffers. The converters take the JAX
package's ``Cell``, ``PdschConfig`` and ``DlschPlan`` as their field
values (``dataclasses.asdict`` or ``vars`` of those objects: plain
Python ints, bools, tuples and enum members whose ``.value`` is used),
and softbuffers as numpy arrays, so nothing of the JAX package is
imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.pdsch import PdschConfig
from .models.sch import DlschPlan
from .ops.equalizer import MimoType
from .ops.modem import Mod
from .utils.cell import CP, Cell
from .utils.device import resolve_device


def _value(x):
    """An enum member (of either package) -> its value; else x."""
    return getattr(x, "value", x)


def cell_from_fields(f: dict) -> Cell:
    return Cell(nof_prb=int(f["nof_prb"]), nof_ports=int(f["nof_ports"]),
                id=int(f["id"]), cp=CP(_value(f.get("cp", "normal"))),
                reduced_rates=bool(f.get("reduced_rates", False)))


def _mask(m):
    return None if m is None else tuple(bool(v) for v in m)


def pdsch_config_from_fields(f: dict) -> PdschConfig:
    cell = f["cell"]
    if not isinstance(cell, Cell):
        cell = cell_from_fields(cell if isinstance(cell, dict)
                                else vars(cell))
    return PdschConfig(
        cell=cell, sf_idx=int(f["sf_idx"]), cfi=int(f["cfi"]),
        rnti=int(f["rnti"]), mod=Mod(_value(f["mod"])),
        mimo=MimoType(_value(f["mimo"])), nof_layers=int(f["nof_layers"]),
        nof_codewords=int(f["nof_codewords"]), pmi=int(f["pmi"]),
        prb_mask=_mask(f.get("prb_mask")),
        prb_mask_slot1=_mask(f.get("prb_mask_slot1")),
        llr_int8=bool(f.get("llr_int8", False)))


def dlsch_plan_from_fields(f: dict) -> DlschPlan:
    """The JAX plan's ``decoder_impl`` names a TPU kernel variant and has
    no counterpart here; every other field carries over."""
    return DlschPlan(tbs=int(f["tbs"]), g=int(f["g"]), qm=int(f["qm"]),
                     rv=int(f.get("rv", 0)),
                     n_layers=int(f.get("n_layers", 1)),
                     max_iterations=int(f.get("max_iterations", 5)),
                     early_stop=bool(f.get("early_stop", True)))


def plan_fields(plan: DlschPlan) -> dict:
    """The port's plan as plain field values (the inverse direction)."""
    return dict(tbs=plan.tbs, g=plan.g, qm=plan.qm, rv=plan.rv,
                n_layers=plan.n_layers, max_iterations=plan.max_iterations,
                early_stop=plan.early_stop)


def softbuffers_from_numpy(softbuffers, device=None) -> list[torch.Tensor]:
    """Per-CB numpy softbuffers [..., 3*(K+4)] -> float32 tensors."""
    dev = resolve_device(device)
    return [torch.tensor(np.asarray(s, np.float32), device=dev)
            for s in softbuffers]


def softbuffers_to_numpy(softbuffers) -> list[np.ndarray]:
    return [s.detach().cpu().numpy() for s in softbuffers]
