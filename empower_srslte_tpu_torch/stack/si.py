"""System information for the stack nodes: MIB + SIB1/SIB2 builders and
the UE-side acquisition helpers (srsenb rrc.cc generate_sibs /
enb_cfg_parser.cc sib.conf values; srsue cold-boot acquisition).

The SIB2 carries the live radio-resource configuration the UE actually
needs before random access: the PRACH root sequence index and frequency
offset, and the PUCCH common config — mirroring how the reference's UE
reads rach/prach/pucch config out of SIB2 (rrc.cc handle_sib2 ->
apply_sib2_configs).
"""

from __future__ import annotations

import numpy as np

from ..utils.cell import Cell
from .params import PRACH_FREQ_OFFSET, PUCCH_N_RB_2


def build_mib_bits(cell: Cell, sfn: int) -> np.ndarray:
    from ..models.pbch import mib_pack

    return mib_pack(cell.nof_prb, 0, 1, sfn)


def build_sib1(cell: Cell, tac: int = 7, cell_identity: int = 0x1A2D001,
               si_periodicity: int = 1, mcc: tuple = (0, 0, 1),
               mnc: tuple = (0, 1)) -> bytes:
    """SystemInformationBlockType1; scheduling_info_list entry 0 maps
    the one SI message carrying SIB2 (si_periodicity 1 = rf16)."""
    from ..rrc import messages as M

    sib1 = {"cell_access_related_info": {
                "plmn_identity_list": [{
                    "plmn_identity": {"mcc": list(mcc), "mnc": list(mnc)},
                    "cell_reserved_for_operator_use": "notReserved"}],
                "tracking_area_code": tac,
                "cell_identity": cell_identity,
                "cell_barred": "notBarred",
                "intra_freq_reselection": "allowed",
                "csg_indication": False},
            "cell_selection_info": {"q_rx_lev_min": -65},
            "freq_band_indicator": 7,
            "scheduling_info_list": [{"si_periodicity": si_periodicity,
                                      "sib_mapping_info": []}],
            "si_window_length": 5,        # ws20
            "system_info_value_tag": 0}
    return M.pack_bcch_dlsch("systemInformationBlockType1", sib1)


def build_sib2(rsi: int, prach_freq_offset: int = PRACH_FREQ_OFFSET,
               n_rb_cqi: int = PUCCH_N_RB_2) -> bytes:
    """SIB2 (SystemInformation message) with the stack's live PRACH and
    PUCCH common configuration."""
    from ..rrc import messages as M

    sib2 = {"radio_resource_config_common": {
                "rach_config_common": {
                    "preamble_info": {"number_of_ra_preambles": 12},
                    "power_ramping_parameters": {
                        "power_ramping_step": 1,
                        "preamble_initial_received_target_power": 6},
                    "ra_supervision_info": {
                        "preamble_trans_max": 6,
                        "ra_response_window_size": 7,
                        "mac_contention_resolution_timer": 5},
                    "max_harq_msg3_tx": 4},
                "bcch_config": {"modification_period_coeff": 1},
                "pcch_config": {"default_paging_cycle": 2, "nb": 3},
                "prach_config": {
                    "root_sequence_index": rsi,
                    "prach_config_info": {
                        "prach_config_index": 3, "high_speed_flag": False,
                        "zero_correlation_zone_config": 11,
                        "prach_freq_offset": prach_freq_offset}},
                "pdsch_config_common": {"reference_signal_power": 18,
                                        "p_b": 0},
                "pusch_config_common": {
                    "pusch_config_basic": {
                        "n_sb": 1, "hopping_mode": 0,
                        "pusch_hopping_offset": 4,
                        "enable_64qam": False},
                    "ul_reference_signals_pusch": {
                        "group_hopping_enabled": False,
                        "group_assignment_pusch": 0,
                        "sequence_hopping_enabled": False,
                        "cyclic_shift": 0}},
                "pucch_config_common": {"delta_pucch_shift": 1,
                                        "n_rb_cqi": n_rb_cqi,
                                        "n_cs_an": 0,
                                        "n1_pucch_an": 12},
                "sounding_rs_ul_config_common": ("release", None),
                "uplink_power_control_common": {
                    "p0_nominal_pusch": -85, "alpha": 5,
                    "p0_nominal_pucch": -107,
                    "delta_flist_pucch": {
                        "delta_f_pucch_format1": 1,
                        "delta_f_pucch_format1b": 1,
                        "delta_f_pucch_format2": 1,
                        "delta_f_pucch_format2a": 1,
                        "delta_f_pucch_format2b": 1},
                    "delta_preamble_msg3": 4},
                "ul_cyclic_prefix_length": 0},
            "ue_timers_and_constants": {"t300": 5, "t301": 5, "t310": 4,
                                        "n310": 5, "t311": 3, "n311": 0},
            "freq_info": {"additional_spectrum_emission": 1},
            "time_alignment_timer_common": 7}
    si = {"critical_extensions": ("systemInformation_r8",
          {"sib_type_and_info": [("sib2", sib2)]})}
    return M.pack_bcch_dlsch("systemInformation", si)


#: q-Hyst enum values in dB (36.331 SIB3 q_hyst: dB0..dB24)
Q_HYST_DB = (0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 18, 20, 22, 24)
#: q-OffsetCell enum values in dB (36.331 Q-OffsetRange, index 15 = dB0)
Q_OFFSET_DB = (-24, -22, -20, -18, -16, -14, -12, -10, -8, -6, -5, -4,
               -3, -2, -1, 0, 1, 2, 3, 4, 5, 6, 8, 10, 12, 14, 16, 18,
               20, 22, 24)


def build_sib3(q_hyst_db: int = 2, q_rx_lev_min: int = -65,
               s_intra_search: int | None = 31,
               t_resel_s: int = 0) -> bytes:
    """SIB3: 36.304 cell-reselection parameters the idle UE applies
    (srsue rrc.cc handle_sib3 -> cell_resel_cfg: q_hyst, Qrxlevmin,
    s_intrasearchP, t_reselection)."""
    from ..rrc import messages as M

    sib3 = {"cell_reselection_info_common": {
                "q_hyst": Q_HYST_DB.index(q_hyst_db)},
            "cell_reselection_serving_freq_info": {
                "thresh_serving_low": 0,
                "cell_reselection_priority": 4},
            "intra_freq_cell_reselection_info": {
                "q_rx_lev_min": q_rx_lev_min,
                "presence_antenna_port1": False,
                "neigh_cell_config": 1,
                "t_reselection_eutra": t_resel_s}}
    if s_intra_search is not None:
        sib3["intra_freq_cell_reselection_info"][
            "s_intra_search"] = s_intra_search
    si = {"critical_extensions": ("systemInformation_r8",
          {"sib_type_and_info": [("sib3", sib3)]})}
    return M.pack_bcch_dlsch("systemInformation", si)


def build_sib4(neighbor_pcis: tuple[int, ...],
               q_offset_db: int = 0) -> bytes:
    """SIB4: intra-frequency neighbour cell list (srsue rrc.cc uses the
    detected set; broadcasting it gives the idle UE its measurement
    targets without a connected-mode measConfig)."""
    from ..rrc import messages as M

    sib4 = {}
    if neighbor_pcis:
        sib4["intra_freq_neigh_cell_list"] = [
            {"phys_cell_id": pci,
             "q_offset_cell": Q_OFFSET_DB.index(q_offset_db)}
            for pci in neighbor_pcis]
    si = {"critical_extensions": ("systemInformation_r8",
          {"sib_type_and_info": [("sib4", sib4)]})}
    return M.pack_bcch_dlsch("systemInformation", si)


def sib3_resel_config(sib3: dict) -> dict:
    """Extract the 36.304 reselection parameters the UE applies
    (srsue rrc.cc:938 cell_selection_criteria / :958 cell_reselection).
    Qrxlevmin is carried in 2 dB units (36.331: actual = IE * 2)."""
    intra = sib3["intra_freq_cell_reselection_info"]
    s_intra = intra.get("s_intra_search")
    return {
        "q_hyst_db": Q_HYST_DB[sib3["cell_reselection_info_common"]
                               ["q_hyst"]],
        "q_rx_lev_min_db": 2 * intra["q_rx_lev_min"],
        "s_intra_search_db": None if s_intra is None else 2 * s_intra,
        "t_resel_s": intra["t_reselection_eutra"],
    }


def sib4_neighbors(sib4: dict) -> list[tuple[int, int]]:
    """[(pci, q_offset_db)] from a SIB4."""
    return [(n["phys_cell_id"], Q_OFFSET_DB[n["q_offset_cell"]])
            for n in sib4.get("intra_freq_neigh_cell_list", [])]


def sib1_access_info(sib1: dict) -> dict:
    """PLMN list / TAC / cell identity / Qrxlevmin out of SIB1 — what
    plmn_search saves per found cell (srsue rrc.cc:379-398)."""
    acc = sib1["cell_access_related_info"]
    plmns = []
    for e in acc["plmn_identity_list"]:
        ident = e["plmn_identity"]
        mcc = "".join(str(d) for d in ident.get("mcc", []))
        mnc = "".join(str(d) for d in ident["mnc"])
        plmns.append(mcc + mnc)
    return {
        "plmns": plmns,
        "tac": acc["tracking_area_code"],
        "cell_identity": acc["cell_identity"],
        "barred": acc["cell_barred"] == "barred",
        "q_rx_lev_min_db": 2 * sib1["cell_selection_info"]["q_rx_lev_min"],
    }


def parse_si(tb: bytes) -> tuple[str, dict]:
    """Decode a BCCH-DL-SCH transport block (possibly zero-padded)."""
    from ..rrc import messages as M

    return M.unpack_bcch_dlsch(tb)


def sib2_radio_config(sib2: dict) -> dict:
    """Extract the fields the UE stack applies (apply_sib2_configs)."""
    rr = sib2["radio_resource_config_common"]
    prach = rr["prach_config"]
    return {
        "rsi": prach["root_sequence_index"],
        "prach_freq_offset":
            prach["prach_config_info"]["prach_freq_offset"],
        "n_rb_cqi": rr["pucch_config_common"]["n_rb_cqi"],
    }
