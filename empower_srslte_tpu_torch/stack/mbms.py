"""eMBMS for the stack nodes: MCCH/SIB13 builders and the MBSFN
subframe compose/decode helpers (srsenb PMCH scheduling + srsue MBSFN
reception; lib pmch.c + liblte mcch codecs).

One MBSFN subframe per frame (subframe 3); MCCH rides it every
MCCH_PERIOD_RF frames at the signalling MCS, MTCH (MCH lcid 1) carries
the M1 GTP-U payloads from the MBMS-GW on the other occasions at the
data MCS announced in the MCCH.
"""

from __future__ import annotations

import numpy as np

from ..utils.cell import CP, Cell

#: the MBSFN subframe of every radio frame (sf-AllocInfo bit 2 = sf 3).
MBSFN_SF = 3
#: MCCH occasion: subframe 3 of every sfn % MCCH_PERIOD_RF == 0 frame.
MCCH_PERIOD_RF = 8
#: MCS of the MCCH occasions (SIB13 signalling_mcs n2).
MCCH_MCS = 2
#: MCH logical channels.
LCID_MCCH = 0
LCID_MTCH = 1


def mbsfn_cell(cell: Cell) -> Cell:
    """The extended-CP twin of the serving cell (PMCH grids)."""
    return Cell(nof_prb=cell.nof_prb, id=cell.id, cp=CP.EXT,
                reduced_rates=cell.reduced_rates)


def build_sib13(area_id: int) -> bytes:
    from ..rrc import messages as M

    sib13 = {
        "mbsfn_area_info_list": [{
            "mbsfn_area_id": area_id,
            "non_mbsfn_region_length": "s2",
            "notification_indicator": 0,
            "mcch_config": {
                "mcch_repetition_period": "rf32",
                "mcch_offset": 3,
                "mcch_modification_period": "rf512",
                "sf_alloc_info": 0x08,      # subframe 3
                "signalling_mcs": "n2",
            },
        }],
        "notification_config": {
            "notification_repetition_coeff": "n2",
            "notification_offset": 0,
            "notification_sf_index": 1,
        },
    }
    si = {"critical_extensions": ("systemInformation_r8",
          {"sib_type_and_info": [("sib13_v920", sib13)]})}
    return M.pack_bcch_dlsch("systemInformation", si)


def build_mcch(data_mcs: int) -> bytes:
    """MBSFNAreaConfiguration announcing one PMCH / one session."""
    from ..rrc import messages as M

    cfg = {
        "commonsf_alloc": [{
            "radioframe_allocation_period": 0,     # n1: every frame
            "radioframe_allocation_offset": 0,
            "subframe_allocation": ("oneFrame", 0x08)}],   # sf 3
        "commonsf_alloc_period": 0,                # rf4
        "pmch_info_list": [{
            "pmch_config": {"sf_alloc_end": 0, "data_mcs": data_mcs,
                            "mch_scheduling_period": 0},
            "mbms_session_info_list": [{
                "tmgi": {"plmn_id": ("explicitValue",
                                     {"mcc": [0, 0, 1], "mnc": [0, 1]}),
                         "service_id": b"\x00\x00\x01"},
                "session_id": b"\x01",
                "logical_channel_identity": LCID_MTCH}]}],
    }
    return M.pack_mcch(cfg)


def parse_mcch(tb: bytes) -> dict:
    from ..rrc import messages as M

    v = M.unpack_mcch(tb)
    pmch = v["pmch_info_list"][0]["pmch_config"]
    return {"data_mcs": pmch["data_mcs"], "raw": v}


def is_mcch_occasion(tti: int) -> bool:
    return (tti // 10) % MCCH_PERIOD_RF == 0


def pmch_tbs(cell: Cell, mcs: int):
    """(Mod, tbs) for a full-band PMCH grant at this MCS."""
    from ..models import ra

    return ra.mcs_to_tbs(mcs, cell.nof_prb)
