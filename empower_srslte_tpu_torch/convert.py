"""Carry the JAX package's static configuration and HARQ state into the port.

This system has no learned weights: its state is the cell/grant
configuration and the HARQ softbuffers. The converters take the JAX
package's ``Cell``, ``PdschConfig``, ``PuschConfig``, ``DlschPlan`` and
``UciPlan`` as their field values (``dataclasses.asdict`` or ``vars`` of
those objects: plain Python ints, bools, tuples and enum members whose
``.value`` is used; nested objects are read through ``vars``), and
softbuffers as numpy arrays, so nothing of the JAX package is imported
here.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.pdsch import PdschConfig
from .models.pusch import PuschConfig, UciData, UciPlan
from .models.sch import DlschPlan
from .ops.equalizer import MimoType
from .ops.modem import Mod
from .utils.cell import CP, Cell
from .utils.device import resolve_device


def _value(x):
    """An enum member (of either package) -> its value; else x."""
    return getattr(x, "value", x)


def _fields(x) -> dict:
    return x if isinstance(x, dict) else vars(x)


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


def pusch_config_from_fields(f: dict) -> PuschConfig:
    cell = f["cell"]
    if not isinstance(cell, Cell):
        cell = cell_from_fields(_fields(cell))
    slot1 = f.get("prb_start_slot1")
    return PuschConfig(
        cell=cell, sf_idx=int(f["sf_idx"]), rnti=int(f["rnti"]),
        mod=Mod(_value(f["mod"])), prb_start=int(f["prb_start"]),
        n_prb=int(f["n_prb"]), cyclic_shift=int(f.get("cyclic_shift", 0)),
        prb_start_slot1=None if slot1 is None else int(slot1),
        delta_ss=int(f.get("delta_ss", 0)),
        group_hopping=bool(f.get("group_hopping", False)),
        sequence_hopping=bool(f.get("sequence_hopping", False)),
        llr_int8=bool(f.get("llr_int8", False)))


def decoder_impl_from_jax(impl: str) -> str:
    """The JAX plan's turbo decoder -> the port's: the NII kernel
    (``"auto"``, ``"pallas2*"``) -> ``"nii"``; the v1 windowed kernel
    (``"pallas*"``) -> ``"windowed"``; the XLA scans (``"xla"``) ->
    ``"xla"``, their plain PyTorch copies (their results differ from the
    v1 kernel's)."""
    if impl == "auto" or impl.startswith("pallas2"):
        return "nii"
    if impl.startswith("pallas"):
        return "windowed"
    if impl == "xla":
        return "xla"
    raise ValueError(f"unknown turbo decoder {impl!r}")


def dlsch_plan_from_fields(f: dict) -> DlschPlan:
    return DlschPlan(tbs=int(f["tbs"]), g=int(f["g"]), qm=int(f["qm"]),
                     rv=int(f.get("rv", 0)),
                     n_layers=int(f.get("n_layers", 1)),
                     max_iterations=int(f.get("max_iterations", 5)),
                     early_stop=bool(f.get("early_stop", True)),
                     decoder_impl=decoder_impl_from_jax(
                         f.get("decoder_impl", "auto")))


def plan_fields(plan: DlschPlan) -> dict:
    """The port's plan as plain field values (the inverse direction;
    ``"nii"`` maps to the JAX package's default ``"auto"``)."""
    return dict(tbs=plan.tbs, g=plan.g, qm=plan.qm, rv=plan.rv,
                n_layers=plan.n_layers, max_iterations=plan.max_iterations,
                early_stop=plan.early_stop,
                decoder_impl={"nii": "auto", "windowed": "pallas",
                              "xla": "xla"}[plan.decoder_impl])


def uci_plan_from_fields(f: dict) -> UciPlan:
    """A JAX ``UciPlan`` (its ``vars``: ``cfg``, ``uci``, ``tbs`` and
    ``data_plan``) -> the port's plan for the same grant and payload."""
    cfg = f["cfg"]
    if not isinstance(cfg, PuschConfig):
        cfg = pusch_config_from_fields(_fields(cfg))
    u = _fields(f["uci"])
    uci = UciData(cqi_bits=tuple(int(b) for b in u.get("cqi_bits", ())),
                  ri=None if u.get("ri") is None else int(u["ri"]),
                  ack=tuple(int(b) for b in u.get("ack", ())),
                  i_offset_cqi=int(u.get("i_offset_cqi", 7)),
                  i_offset_ri=int(u.get("i_offset_ri", 2)),
                  i_offset_ack=int(u.get("i_offset_ack", 2)))
    dp = f.get("data_plan")
    data = {} if dp is None else dlsch_plan_from_fields(_fields(dp))
    return UciPlan(cfg, int(f["tbs"]), uci,
                   rv=getattr(data, "rv", 0),
                   max_iterations=getattr(data, "max_iterations", 5),
                   decoder_impl=getattr(data, "decoder_impl", "nii"))


def softbuffers_from_numpy(softbuffers, device=None) -> list[torch.Tensor]:
    """Per-CB numpy softbuffers [..., 3*(K+4)] -> tensors: int8 HARQ state
    (the 8-bit LLR lane's) stays int8, any other float32."""
    dev = resolve_device(device)

    def one(s):
        s = np.asarray(s)
        return torch.tensor(s if s.dtype == np.int8 else s.astype(np.float32),
                            device=dev)

    return [one(s) for s in softbuffers]


def softbuffers_to_numpy(softbuffers) -> list[np.ndarray]:
    return [s.detach().cpu().numpy() for s in softbuffers]
