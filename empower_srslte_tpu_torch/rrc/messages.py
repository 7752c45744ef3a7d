"""36.331 (Rel-8/9) RRC message schemas over the UPER engine.

Capability parity with lib/src/asn1/liblte_rrc.cc: the logical channels
and messages the srsue/srsenb flows exercise — UL/DL-CCCH (connection
setup), UL/DL-DCCH (security, reconfiguration with measurement/DRB/
mobility config, NAS transfer, release), BCCH-DL-SCH (SIB1/SIB2) and
PCCH (paging). Validated bit-exactly against the captured messages in
lib/test/asn1/srslte_asn1_rrc_meas_test.cc and
srsue/test/upper/rrc_reconfig_test.cc.
"""

from __future__ import annotations

from .per import BitReader, BitWriter
from .schema import (BitString, Bool, Choice, Enum, Field, Int, Null,
                     OctetString, RawTail, Seq, SeqOf, f)

# --- common IEs --------------------------------------------------------------

Digit = Int(0, 9)
MCC = SeqOf(Digit, 3, 3)
MNC = SeqOf(Digit, 2, 3)
PLMN_Identity = Seq(f("mcc", MCC, optional=True), f("mnc", MNC))
CellIdentity = BitString(28)
TrackingAreaCode = BitString(16)
PhysCellId = Int(0, 503)
ARFCN_ValueEUTRA = Int(0, 65535)
RSRP_Range = Int(0, 97)
RSRQ_Range = Int(0, 34)
Q_OffsetRange = Enum(31)        # dB-24..dB24 table (31 values)
MMEC = BitString(8)
ShortMAC_I = BitString(16)

CellGlobalIdEUTRA = Seq(
    f("plmn_identity", PLMN_Identity),
    f("cell_identity", CellIdentity),
)

spare_null = [(f"spare{i}", Null()) for i in range(7, 0, -1)]


def crit_ext_c1(r8: Seq, n_spare: int = 7) -> Choice:
    """criticalExtensions CHOICE { c1 CHOICE {r8, spareN..}, future SEQ{} }"""
    opts = [("r8", r8)] + [(f"spare{i}", Null())
                           for i in range(n_spare, 0, -1)]
    return Choice([("c1", Choice(opts)),
                   ("criticalExtensionsFuture", Seq())])


# --- measurement IEs (36.331 6.3.5) ------------------------------------------

MeasId = Int(1, 32)
MeasObjectId = Int(1, 32)
ReportConfigId = Int(1, 32)

MeasResult = Seq(
    f("rsrp_result", RSRP_Range, optional=True),
    f("rsrq_result", RSRQ_Range, optional=True),
    ext=True,
)

PLMN_IdentityList2 = SeqOf(PLMN_Identity, 1, 5)

CgiInfo = Seq(
    f("cell_global_id", CellGlobalIdEUTRA),
    f("tracking_area_code", TrackingAreaCode),
    f("plmn_identity_list", PLMN_IdentityList2, optional=True),
)

MeasResultEUTRA = Seq(
    f("phys_cell_id", PhysCellId),
    f("cgi_info", CgiInfo, optional=True),
    f("meas_result", MeasResult),
)

MeasResultListEUTRA = SeqOf(MeasResultEUTRA, 1, 8)

MeasResultNeighCells = Choice([
    ("measResultListEUTRA", MeasResultListEUTRA),
    ("measResultListUTRA", Null()),      # not produced by the LTE-only flows
    ("measResultListGERAN", Null()),
    ("measResultsCDMA2000", Null()),
], ext=True)

MeasResults = Seq(
    f("meas_id", MeasId),
    f("meas_result_pcell", Seq(f("rsrp_result", RSRP_Range),
                               f("rsrq_result", RSRQ_Range))),
    f("meas_result_neigh_cells", MeasResultNeighCells, optional=True),
    ext=True,
)

MeasurementReport = Seq(
    f("critical_extensions", crit_ext_c1(
        Seq(f("meas_results", MeasResults),
            f("non_critical_extension", Seq(), optional=True)))),
)

# measurement configuration (DL direction)

Hysteresis = Int(0, 30)
TimeToTrigger = Enum(16)  # ms0..ms5120 table

ThresholdEUTRA = Choice([("threshold_rsrp", RSRP_Range),
                         ("threshold_rsrq", RSRQ_Range)])

_eventId = Choice([
    ("eventA1", Seq(f("a1_threshold", ThresholdEUTRA))),
    ("eventA2", Seq(f("a2_threshold", ThresholdEUTRA))),
    ("eventA3", Seq(f("a3_offset", Int(-30, 30)),
                    f("report_on_leave", Bool()))),
    ("eventA4", Seq(f("a4_threshold", ThresholdEUTRA))),
    ("eventA5", Seq(f("a5_threshold1", ThresholdEUTRA),
                    f("a5_threshold2", ThresholdEUTRA))),
], ext=True)

ReportConfigEUTRA = Seq(
    f("trigger_type", Choice([
        ("event", Seq(f("event_id", _eventId),
                      f("hysteresis", Hysteresis),
                      f("time_to_trigger", TimeToTrigger))),
        ("periodical", Seq(f("purpose", Enum(2)))),
    ])),
    f("trigger_quantity", Enum(2)),          # rsrp, rsrq
    f("report_quantity", Enum(2)),           # sameAsTriggerQuantity, both
    f("max_report_cells", Int(1, 8)),
    f("report_interval", Enum(16)),
    f("report_amount", Enum(8)),             # r1..r64, infinity
    ext=True,
)

ReportConfigToAddMod = Seq(
    f("report_config_id", ReportConfigId),
    f("report_config", Choice([
        ("reportConfigEUTRA", ReportConfigEUTRA),
        ("reportConfigInterRAT", Null()),
    ])),
)

CellsToAddMod = Seq(
    f("cell_index", Int(1, 32)),
    f("phys_cell_id", PhysCellId),
    f("cell_individual_offset", Q_OffsetRange),
)

MeasObjectEUTRA = Seq(
    f("carrier_freq", ARFCN_ValueEUTRA),
    f("allowed_meas_bandwidth", Enum(6)),    # mbw6..mbw100
    f("presence_antenna_port1", Bool()),
    f("neigh_cell_config", BitString(2)),
    f("offset_freq", Q_OffsetRange, optional=True, default="dB0"),
    f("cells_to_remove_list", SeqOf(Int(1, 32), 1, 32), optional=True),
    f("cells_to_add_mod_list", SeqOf(CellsToAddMod, 1, 32), optional=True),
    f("black_cells_to_remove_list", SeqOf(Int(1, 32), 1, 32),
      optional=True),
    f("black_cells_to_add_mod_list", Seq(), optional=True),
    f("cell_for_which_to_report_cgi", PhysCellId, optional=True),
    ext=True,
)

MeasObjectToAddMod = Seq(
    f("meas_object_id", MeasObjectId),
    f("meas_object", Choice([
        ("measObjectEUTRA", MeasObjectEUTRA),
        ("measObjectUTRA", Null()),
        ("measObjectGERAN", Null()),
        ("measObjectCDMA2000", Null()),
    ], ext=True)),
)

MeasIdToAddMod = Seq(
    f("meas_id", MeasId),
    f("meas_object_id", MeasObjectId),
    f("report_config_id", ReportConfigId),
)

QuantityConfig = Seq(
    f("quantity_config_eutra", Seq(
        f("filter_coefficient_rsrp", Enum(16, ext=True), optional=True),
        f("filter_coefficient_rsrq", Enum(16, ext=True), optional=True)),
      optional=True),
    f("quantity_config_utra", Null(), optional=True),
    f("quantity_config_geran", Null(), optional=True),
    f("quantity_config_cdma2000", Null(), optional=True),
    ext=True,
)

MeasGapConfig = Choice([
    ("release", Null()),
    ("setup", Seq(f("gap_offset", Choice([("gp0", Int(0, 39)),
                                          ("gp1", Int(0, 79))], ext=True)))),
])

MeasConfig = Seq(
    f("meas_object_to_remove_list", SeqOf(MeasObjectId, 1, 32),
      optional=True),
    f("meas_object_to_add_mod_list", SeqOf(MeasObjectToAddMod, 1, 32),
      optional=True),
    f("report_config_to_remove_list", SeqOf(ReportConfigId, 1, 32),
      optional=True),
    f("report_config_to_add_mod_list", SeqOf(ReportConfigToAddMod, 1, 32),
      optional=True),
    f("meas_id_to_remove_list", SeqOf(MeasId, 1, 32), optional=True),
    f("meas_id_to_add_mod_list", SeqOf(MeasIdToAddMod, 1, 32),
      optional=True),
    f("quantity_config", QuantityConfig, optional=True),
    f("meas_gap_config", MeasGapConfig, optional=True),
    f("s_measure", RSRP_Range, optional=True),
    f("pre_registration_info_hrpd", Null(), optional=True),
    f("speed_state_pars", Choice([("release", Null()),
                                  ("setup", Seq(
        f("mobility_state_parameters", Seq(
            f("t_evaluation", Enum(8)),
            f("t_hyst_normal", Enum(8)),
            f("n_cell_change_medium", Int(1, 16)),
            f("n_cell_change_high", Int(1, 16)))),
        f("time_to_trigger_sf", Seq(
            f("sf_medium", Enum(4)), f("sf_high", Enum(4))))))]),
      optional=True),
    ext=True,
)


# --- dedicated radio resource configuration (36.331 6.3.2) -------------------

# RLC
_PollRetransmit = Enum(64, ext=False)
_PollPDU = Enum(8)
_PollByte = Enum(16)
_MaxRetx = Enum(8)
_SN_FieldLength = Enum(2)        # size5, size10
_T_Reordering = Enum(32)
_T_StatusProhibit = Enum(64)

UL_AM_RLC = Seq(f("t_poll_retransmit", _PollRetransmit),
                f("poll_pdu", _PollPDU),
                f("poll_byte", _PollByte),
                f("max_retx_threshold", _MaxRetx))
DL_AM_RLC = Seq(f("t_reordering", _T_Reordering),
                f("t_status_prohibit", _T_StatusProhibit))
UL_UM_RLC = Seq(f("sn_field_length", _SN_FieldLength))
DL_UM_RLC = Seq(f("sn_field_length", _SN_FieldLength),
                f("t_reordering", _T_Reordering))

RLC_Config = Choice([
    ("am", Seq(f("ul_am_rlc", UL_AM_RLC), f("dl_am_rlc", DL_AM_RLC))),
    ("um_bi_directional", Seq(f("ul_um_rlc", UL_UM_RLC),
                              f("dl_um_rlc", DL_UM_RLC))),
    ("um_uni_directional_ul", Seq(f("ul_um_rlc", UL_UM_RLC))),
    ("um_uni_directional_dl", Seq(f("dl_um_rlc", DL_UM_RLC))),
], ext=True)

LogicalChannelConfig = Seq(
    f("ul_specific_parameters", Seq(
        f("priority", Int(1, 16)),
        f("prioritised_bit_rate", Enum(16)),
        f("bucket_size_duration", Enum(8)),
        f("logical_channel_group", Int(0, 3), optional=True)),
      optional=True),
    ext=True,
)

SRB_ToAddMod = Seq(
    f("srb_identity", Int(1, 2)),
    f("rlc_config", Choice([("explicitValue", RLC_Config),
                            ("defaultValue", Null())]), optional=True),
    f("logical_channel_config",
      Choice([("explicitValue", LogicalChannelConfig),
              ("defaultValue", Null())]), optional=True),
    ext=True,
)

# PDCP
PDCP_Config = Seq(
    f("discard_timer", Enum(8), optional=True),
    f("rlc_am", Seq(f("status_report_required", Bool())), optional=True),
    f("rlc_um", Seq(f("pdcp_sn_size", Enum(2))), optional=True),
    f("header_compression", Choice([
        ("notUsed", Null()),
        ("rohc", Seq(
            f("max_cid", Int(1, 16383), optional=True, default=15),
            f("profiles", Seq(*[f(p, Bool()) for p in (
                "profile0x0001", "profile0x0002", "profile0x0003",
                "profile0x0004", "profile0x0006", "profile0x0101",
                "profile0x0102", "profile0x0103", "profile0x0104")])),
            ext=True)),
    ])),
    ext=True,
)

DRB_ToAddMod = Seq(
    f("eps_bearer_identity", Int(0, 15), optional=True),
    f("drb_identity", Int(1, 32)),
    f("pdcp_config", PDCP_Config, optional=True),
    f("rlc_config", RLC_Config, optional=True),
    f("logical_channel_identity", Int(3, 10), optional=True),
    f("logical_channel_config", LogicalChannelConfig, optional=True),
    ext=True,
)

# MAC
PHR_Config = Choice([
    ("release", Null()),
    ("setup", Seq(f("periodic_phr_timer", Enum(8)),
                  f("prohibit_phr_timer", Enum(8)),
                  f("dl_pathloss_change", Enum(4)))),
])

_sf_sizes = (10, 20, 32, 40, 64, 80, 128, 160, 256, 320, 512, 640,
             1024, 1280, 2048, 2560)
LongDRX_CycleStartOffset = Choice(
    [(f"sf{n}", Int(0, n - 1)) for n in _sf_sizes])

DRX_Config = Choice([
    ("release", Null()),
    ("setup", Seq(
        f("on_duration_timer", Enum(16)),
        f("drx_inactivity_timer", Enum(32)),
        f("drx_retransmission_timer", Enum(8)),
        f("long_drx_cycle_start_offset", LongDRX_CycleStartOffset),
        f("short_drx", Seq(f("short_drx_cycle", Enum(16)),
                           f("drx_short_cycle_timer", Int(1, 16))),
          optional=True))),
])

MAC_MainConfig = Seq(
    f("ul_sch_config", Seq(
        f("max_harq_tx", Enum(16), optional=True),
        f("periodic_bsr_timer", Enum(16), optional=True),
        f("retx_bsr_timer", Enum(8)),
        f("tti_bundling", Bool())), optional=True),
    f("drx_config", DRX_Config, optional=True),
    f("time_alignment_timer_dedicated", Enum(8)),
    f("phr_config", PHR_Config, optional=True),
    ext=True,
)

# Physical layer dedicated
PDSCH_ConfigDedicated = Seq(f("p_a", Enum(8)))

PUCCH_ConfigDedicated = Seq(
    f("ack_nack_repetition", Choice([
        ("release", Null()),
        ("setup", Seq(f("repetition_factor", Enum(4, ext=True)),
                      f("n1_pucch_an_rep", Int(0, 2047)))),
    ])),
    f("tdd_ack_nack_feedback_mode", Enum(2), optional=True),
)

PUSCH_ConfigDedicated = Seq(
    f("beta_offset_ack_index", Int(0, 15)),
    f("beta_offset_ri_index", Int(0, 15)),
    f("beta_offset_cqi_index", Int(0, 15)),
)

UplinkPowerControlDedicated = Seq(
    f("p0_ue_pusch", Int(-8, 7)),
    f("delta_mcs_enabled", Enum(2)),
    f("accumulation_enabled", Bool()),
    f("p0_ue_pucch", Int(-8, 7)),
    f("p_srs_offset", Int(0, 15)),
    f("filter_coefficient", Enum(16, ext=True), optional=True,
      default="fc4"),
)

TPC_PDCCH_Config = Choice([
    ("release", Null()),
    ("setup", Seq(f("tpc_rnti", BitString(16)),
                  f("tpc_index", Choice([("indexOfFormat3", Int(1, 15)),
                                         ("indexOfFormat3A", Int(1, 31))])))),
])

CQI_ReportConfig = Seq(
    f("cqi_report_mode_aperiodic", Enum(8), optional=True),
    f("nom_pdsch_rs_epre_offset", Int(-1, 6)),
    f("cqi_report_periodic", Choice([
        ("release", Null()),
        ("setup", Seq(
            f("cqi_pucch_resource_index", Int(0, 1185)),
            f("cqi_pmi_config_index", Int(0, 1023)),
            f("cqi_format_indicator_periodic", Choice([
                ("widebandCQI", Null()),
                ("subbandCQI", Seq(f("k", Int(1, 4))))])),
            f("ri_config_index", Int(0, 1023), optional=True),
            f("simultaneous_ack_nack_and_cqi", Bool()))),
    ]), optional=True),
)

SoundingRS_UL_ConfigDedicated = Choice([
    ("release", Null()),
    ("setup", Seq(
        f("srs_bandwidth", Enum(4)),
        f("srs_hopping_bandwidth", Enum(4)),
        f("freq_domain_position", Int(0, 23)),
        f("duration", Bool()),
        f("srs_config_index", Int(0, 1023)),
        f("transmission_comb", Int(0, 1)),
        f("cyclic_shift", Enum(8)))),
])

AntennaInfoDedicated = Seq(
    f("transmission_mode", Enum(8, ext=True)),
    f("codebook_subset_restriction", Choice([
        ("n2TxAntenna-tm3", BitString(2)),
        ("n4TxAntenna-tm3", BitString(4)),
        ("n2TxAntenna-tm4", BitString(6)),
        ("n4TxAntenna-tm4", BitString(64)),
        ("n2TxAntenna-tm5", BitString(4)),
        ("n4TxAntenna-tm5", BitString(16)),
        ("n2TxAntenna-tm6", BitString(4)),
        ("n4TxAntenna-tm6", BitString(16)),
    ]), optional=True),
    f("ue_transmit_antenna_selection", Choice([
        ("release", Null()),
        ("setup", Enum(2)),
    ])),
)

SchedulingRequestConfig = Choice([
    ("release", Null()),
    ("setup", Seq(f("sr_pucch_resource_index", Int(0, 2047)),
                  f("sr_config_index", Int(0, 157)),
                  f("dsr_trans_max", Enum(8)))),
])

PhysicalConfigDedicated = Seq(
    f("pdsch_config_dedicated", PDSCH_ConfigDedicated, optional=True),
    f("pucch_config_dedicated", PUCCH_ConfigDedicated, optional=True),
    f("pusch_config_dedicated", PUSCH_ConfigDedicated, optional=True),
    f("uplink_power_control_dedicated", UplinkPowerControlDedicated,
      optional=True),
    f("tpc_pdcch_config_pucch", TPC_PDCCH_Config, optional=True),
    f("tpc_pdcch_config_pusch", TPC_PDCCH_Config, optional=True),
    f("cqi_report_config", CQI_ReportConfig, optional=True),
    f("sounding_rs_ul_config_dedicated", SoundingRS_UL_ConfigDedicated,
      optional=True),
    f("antenna_info", Choice([
        ("explicitValue", AntennaInfoDedicated),
        ("defaultValue", Null()),
    ]), optional=True),
    f("scheduling_request_config", SchedulingRequestConfig, optional=True),
    ext=True,
)

SPS_Config = Seq(
    f("semi_persist_sched_c_rnti", BitString(16), optional=True),
    f("sps_config_dl", Null(), optional=True),
    f("sps_config_ul", Null(), optional=True),
)

RadioResourceConfigDedicated = Seq(
    f("srb_to_add_mod_list", SeqOf(SRB_ToAddMod, 1, 2), optional=True),
    f("drb_to_add_mod_list", SeqOf(DRB_ToAddMod, 1, 11), optional=True),
    f("drb_to_release_list", SeqOf(Int(1, 32), 1, 11), optional=True),
    f("mac_main_config", Choice([("explicitValue", MAC_MainConfig),
                                 ("defaultValue", Null())]), optional=True),
    f("sps_config", SPS_Config, optional=True),
    f("physical_config_dedicated", PhysicalConfigDedicated, optional=True),
    ext=True,
)


# --- mobility control (handover; 36.331 6.3.4) -------------------------------

PRACH_ConfigInfo = Seq(
    f("prach_config_index", Int(0, 63)),
    f("high_speed_flag", Bool()),
    f("zero_correlation_zone_config", Int(0, 15)),
    f("prach_freq_offset", Int(0, 94)),
)

PRACH_Config = Seq(
    f("root_sequence_index", Int(0, 837)),
    f("prach_config_info", PRACH_ConfigInfo, optional=True),
)

PUSCH_ConfigCommon = Seq(
    f("pusch_config_basic", Seq(
        f("n_sb", Int(1, 4)),
        f("hopping_mode", Enum(2)),
        f("pusch_hopping_offset", Int(0, 98)),
        f("enable_64qam", Bool()))),
    f("ul_reference_signals_pusch", Seq(
        f("group_hopping_enabled", Bool()),
        f("group_assignment_pusch", Int(0, 29)),
        f("sequence_hopping_enabled", Bool()),
        f("cyclic_shift", Int(0, 7)))),
)

PHICH_Config = Seq(f("phich_duration", Enum(2)),
                   f("phich_resource", Enum(4)))

PDSCH_ConfigCommon = Seq(f("reference_signal_power", Int(-60, 50)),
                         f("p_b", Int(0, 3)))

PUCCH_ConfigCommon = Seq(
    f("delta_pucch_shift", Enum(3)),
    f("n_rb_cqi", Int(0, 98)),
    f("n_cs_an", Int(0, 7)),
    f("n1_pucch_an", Int(0, 2047)),
)

SoundingRS_UL_ConfigCommon = Choice([
    ("release", Null()),
    ("setup", Seq(
        f("srs_bandwidth_config", Enum(8)),
        f("srs_subframe_config", Enum(16)),
        f("ack_nack_srs_simultaneous_transmission", Bool()),
        f("srs_max_up_pts", Enum(1), optional=True))),
])

UplinkPowerControlCommon = Seq(
    f("p0_nominal_pusch", Int(-126, 24)),
    f("alpha", Enum(8)),
    f("p0_nominal_pucch", Int(-127, -96)),
    f("delta_flist_pucch", Seq(
        f("delta_f_pucch_format1", Enum(3)),
        f("delta_f_pucch_format1b", Enum(3)),
        f("delta_f_pucch_format2", Enum(4)),
        f("delta_f_pucch_format2a", Enum(3)),
        f("delta_f_pucch_format2b", Enum(3)))),
    f("delta_preamble_msg3", Int(-1, 6)),
)

AntennaInfoCommon = Seq(f("antenna_ports_count", Enum(3)))

RACH_ConfigCommon = Seq(
    f("preamble_info", Seq(
        f("number_of_ra_preambles", Enum(16)),
        f("preambles_group_a_config", Seq(
            f("size_of_ra_preambles_group_a", Enum(15)),
            f("message_size_group_a", Enum(4)),
            f("message_power_offset_group_b", Enum(8)),
            ext=True), optional=True))),
    f("power_ramping_parameters", Seq(
        f("power_ramping_step", Enum(4)),
        f("preamble_initial_received_target_power", Enum(16)))),
    f("ra_supervision_info", Seq(
        f("preamble_trans_max", Enum(11)),
        f("ra_response_window_size", Enum(8)),
        f("mac_contention_resolution_timer", Enum(8)))),
    f("max_harq_msg3_tx", Int(1, 8)),
    ext=True,
)

RadioResourceConfigCommon = Seq(
    f("rach_config_common", RACH_ConfigCommon, optional=True),
    f("prach_config", PRACH_Config),
    f("pdsch_config_common", PDSCH_ConfigCommon, optional=True),
    f("pusch_config_common", PUSCH_ConfigCommon),
    f("phich_config", PHICH_Config, optional=True),
    f("pucch_config_common", PUCCH_ConfigCommon, optional=True),
    f("sounding_rs_ul_config_common", SoundingRS_UL_ConfigCommon,
      optional=True),
    f("uplink_power_control_common", UplinkPowerControlCommon,
      optional=True),
    f("antenna_info_common", AntennaInfoCommon, optional=True),
    f("p_max", Int(-30, 33), optional=True),
    f("tdd_config", Null(), optional=True),
    f("ul_cyclic_prefix_length", Enum(2)),
    ext=True,
)

CarrierBandwidthEUTRA = Seq(
    f("dl_bandwidth", Enum(16)),
    f("ul_bandwidth", Enum(16), optional=True),
)

CarrierFreqEUTRA = Seq(
    f("dl_carrier_freq", ARFCN_ValueEUTRA),
    f("ul_carrier_freq", ARFCN_ValueEUTRA, optional=True),
)

MobilityControlInfo = Seq(
    f("target_pci", PhysCellId),
    f("carrier_freq", CarrierFreqEUTRA, optional=True),
    f("carrier_bandwidth", CarrierBandwidthEUTRA, optional=True),
    f("additional_spectrum_emission", Int(1, 32), optional=True),
    f("t304", Enum(8)),
    f("new_ue_identity", BitString(16)),
    f("radio_resource_config_common", RadioResourceConfigCommon),
    f("rach_config_dedicated", Seq(
        f("ra_preamble_index", Int(0, 63)),
        f("ra_prach_mask_index", Int(0, 15))), optional=True),
    ext=True,
)

# --- security (36.331 6.3.3) --------------------------------------------------

SecurityAlgorithmConfig = Seq(
    f("ciphering_algorithm", Enum(
        ["eea0", "eea1", "eea2", "spare5", "spare4", "spare3", "spare2",
         "spare1"], ext=True)),
    f("integrity_prot_algorithm", Enum(
        ["eia0_v920", "eia1", "eia2", "spare5", "spare4", "spare3",
         "spare2", "spare1"], ext=True)),
)

SecurityConfigSMC = Seq(
    f("security_algorithm_config", SecurityAlgorithmConfig),
    ext=True,
)

SecurityConfigHO = Seq(
    f("handover_type", Choice([
        ("intraLTE", Seq(
            f("security_algorithm_config", SecurityAlgorithmConfig,
              optional=True),
            f("key_change_indicator", Bool()),
            f("next_hop_chaining_count", Int(0, 7)))),
        ("interRAT", Seq(
            f("security_algorithm_config", SecurityAlgorithmConfig),
            f("nas_security_param_to_eutra", OctetString(6)))),
    ], ext=True)),
    ext=True,
)

# --- DL-DCCH messages ---------------------------------------------------------

DedicatedInfoNAS = OctetString()

RRCConnectionReconfiguration_r8 = Seq(
    f("meas_config", MeasConfig, optional=True),
    f("mobility_control_info", MobilityControlInfo, optional=True),
    f("dedicated_info_nas_list", SeqOf(DedicatedInfoNAS, 1, 11),
      optional=True),
    f("radio_resource_config_dedicated", RadioResourceConfigDedicated,
      optional=True),
    f("security_config_ho", SecurityConfigHO, optional=True),
    # v890/v920 late extensions round-trip opaquely
    f("non_critical_extension", RawTail(), optional=True),
)

RRCConnectionReconfiguration = Seq(
    f("rrc_transaction_identifier", Int(0, 3)),
    f("critical_extensions", crit_ext_c1(RRCConnectionReconfiguration_r8)),
)

SecurityModeCommand = Seq(
    f("rrc_transaction_identifier", Int(0, 3)),
    f("critical_extensions", crit_ext_c1(
        Seq(f("security_config_smc", SecurityConfigSMC),
            f("non_critical_extension", Seq(), optional=True)),
        n_spare=3)),
)

RRCConnectionRelease = Seq(
    f("rrc_transaction_identifier", Int(0, 3)),
    f("critical_extensions", crit_ext_c1(
        Seq(f("release_cause", Enum(4)),
            f("redirected_carrier_info", Choice([
                ("eutra", ARFCN_ValueEUTRA), ("geran", Null()),
                ("utra_fdd", Null()), ("utra_tdd", Null()),
                ("cdma2000_hrpd", Null()), ("cdma2000_1xrtt", Null()),
            ], ext=True), optional=True),
            f("idle_mode_mobility_control_info", Seq(ext=True),
              optional=True),
            f("non_critical_extension", Seq(), optional=True)),
        n_spare=3)),
)

DLInformationTransfer = Seq(
    f("rrc_transaction_identifier", Int(0, 3)),
    f("critical_extensions", crit_ext_c1(
        Seq(f("dedicated_info_type", Choice([
                ("dedicatedInfoNAS", DedicatedInfoNAS),
                ("dedicatedInfoCDMA2000-1XRTT", OctetString()),
                ("dedicatedInfoCDMA2000-HRPD", OctetString())])),
            f("non_critical_extension", Seq(), optional=True)),
        n_spare=3)),
)

UECapabilityEnquiry = Seq(
    f("rrc_transaction_identifier", Int(0, 3)),
    f("critical_extensions", crit_ext_c1(
        Seq(f("ue_capability_request", SeqOf(Enum(8, ext=True), 1, 8)),
            f("non_critical_extension", Seq(), optional=True)),
        n_spare=3)),
)

DL_DCCH_C1 = [
    ("csfbParametersResponseCDMA2000", Null()),
    ("dlInformationTransfer", DLInformationTransfer),
    ("handoverFromEUTRAPreparationRequest", Null()),
    ("mobilityFromEUTRACommand", Null()),
    ("rrcConnectionReconfiguration", RRCConnectionReconfiguration),
    ("rrcConnectionRelease", RRCConnectionRelease),
    ("securityModeCommand", SecurityModeCommand),
    ("ueCapabilityEnquiry", UECapabilityEnquiry),
    ("counterCheck", Null()),
    ("ueInformationRequest", Null()),
    ("loggedMeasurementConfiguration", Null()),
    ("rnReconfiguration", Null()),
    ("spare4", Null()), ("spare3", Null()), ("spare2", Null()),
    ("spare1", Null()),
]

DL_DCCH_Message = Choice([("c1", Choice(DL_DCCH_C1)),
                          ("messageClassExtension", Seq())])

# --- UL-DCCH messages ---------------------------------------------------------

RegisteredMME = Seq(
    f("plmn_identity", PLMN_Identity, optional=True),
    f("mmegi", BitString(16)),
    f("mmec", MMEC),
)

RRCConnectionSetupComplete = Seq(
    f("rrc_transaction_identifier", Int(0, 3)),
    f("critical_extensions", Choice([
        ("c1", Choice([("r8", Seq(
            f("selected_plmn_identity", Int(1, 6)),
            f("registered_mme", RegisteredMME, optional=True),
            f("dedicated_info_nas", DedicatedInfoNAS),
            f("non_critical_extension", Seq(), optional=True))),
            ("spare3", Null()), ("spare2", Null()), ("spare1", Null())])),
        ("criticalExtensionsFuture", Seq())])),
)

SecurityModeComplete = Seq(
    f("rrc_transaction_identifier", Int(0, 3)),
    f("critical_extensions", Choice([
        ("r8", Seq(f("non_critical_extension", Seq(), optional=True))),
        ("criticalExtensionsFuture", Seq())])),
)

SecurityModeFailure = SecurityModeComplete

RRCConnectionReconfigurationComplete = Seq(
    f("rrc_transaction_identifier", Int(0, 3)),
    f("critical_extensions", Choice([
        ("r8", Seq(f("non_critical_extension", Seq(), optional=True))),
        ("criticalExtensionsFuture", Seq())])),
)

ULInformationTransfer = Seq(
    f("critical_extensions", crit_ext_c1(
        Seq(f("dedicated_info_type", Choice([
                ("dedicatedInfoNAS", DedicatedInfoNAS),
                ("dedicatedInfoCDMA2000-1XRTT", OctetString()),
                ("dedicatedInfoCDMA2000-HRPD", OctetString())])),
            f("non_critical_extension", Seq(), optional=True)),
        n_spare=3)),
)

# UE capability transfer (36.331 5.6.3; srsue rrc.cc send_ue_cap_info)

PhyLayerParameters = Seq(
    f("ue_tx_antenna_selection_supported", Bool()),
    f("ue_specific_ref_sigs_supported", Bool()),
)

_rohc_profiles = Seq(*[f(p, Bool()) for p in (
    "profile0x0001", "profile0x0002", "profile0x0003", "profile0x0004",
    "profile0x0006", "profile0x0101", "profile0x0102", "profile0x0103",
    "profile0x0104")])

PDCP_Parameters = Seq(
    f("supported_rohc_profiles", _rohc_profiles),
    f("max_number_rohc_context_sessions", Enum(16), optional=True),
    ext=True,
)

SupportedBandEUTRA = Seq(f("band_eutra", Int(1, 64)),
                         f("half_duplex", Bool()))

RF_Parameters = Seq(f("supported_band_list_eutra",
                      SeqOf(SupportedBandEUTRA, 1, 64)))

MeasParameters = Seq(f("band_list_eutra", SeqOf(
    Seq(f("inter_freq_band_list",
          SeqOf(Seq(f("inter_freq_need_for_gaps", Bool())), 1, 64))),
    1, 64)))

InterRAT_Parameters = Seq(
    f("utra_fdd", Null(), optional=True),
    f("utra_tdd128", Null(), optional=True),
    f("utra_tdd384", Null(), optional=True),
    f("utra_tdd768", Null(), optional=True),
    f("geran", Null(), optional=True),
    f("cdma2000_hrpd", Null(), optional=True),
    f("cdma2000_1xrtt", Null(), optional=True),
)

UE_EUTRA_Capability = Seq(
    f("access_stratum_release", Enum(8, ext=True)),
    f("ue_category", Int(1, 5)),
    f("pdcp_parameters", PDCP_Parameters),
    f("phy_layer_parameters", PhyLayerParameters),
    f("rf_parameters", RF_Parameters),
    f("meas_parameters", MeasParameters),
    f("feature_group_indicators", BitString(32), optional=True),
    f("inter_rat_parameters", InterRAT_Parameters),
    f("non_critical_extension", Seq(), optional=True),
)

UE_CapabilityRAT_Container = Seq(
    f("rat_type", Enum(["eutra", "utra", "geran_cs", "geran_ps",
                        "cdma2000_1xrtt", "spare3", "spare2", "spare1"],
                       ext=True)),
    f("ue_capability_rat_container", OctetString()),
)

UECapabilityInformation = Seq(
    f("rrc_transaction_identifier", Int(0, 3)),
    f("critical_extensions", crit_ext_c1(
        Seq(f("ue_capability_rat_container_list",
              SeqOf(UE_CapabilityRAT_Container, 0, 8)),
            f("non_critical_extension", Seq(), optional=True)))),
)


def pack_eutra_capability(value) -> bytes:
    return _pack(UE_EUTRA_Capability, value)


def unpack_eutra_capability(data: bytes):
    return _unpack(UE_EUTRA_Capability, data)


UL_DCCH_C1 = [
    ("csfbParametersRequestCDMA2000", Null()),
    ("measurementReport", MeasurementReport),
    ("rrcConnectionReconfigurationComplete",
     RRCConnectionReconfigurationComplete),
    ("rrcConnectionReestablishmentComplete",
     RRCConnectionReconfigurationComplete),
    ("rrcConnectionSetupComplete", RRCConnectionSetupComplete),
    ("securityModeComplete", SecurityModeComplete),
    ("securityModeFailure", SecurityModeFailure),
    ("ueCapabilityInformation", UECapabilityInformation),
    ("ulHandoverPreparationTransfer", Null()),
    ("ulInformationTransfer", ULInformationTransfer),
    ("counterCheckResponse", Null()),
    ("ueInformationResponse", Null()),
    ("proximityIndication", Null()),
    ("rnReconfigurationComplete", Null()),
    ("mbmsCountingResponse", Null()),
    ("interFreqRSTDMeasurementIndication", Null()),
]

UL_DCCH_Message = Choice([("c1", Choice(UL_DCCH_C1)),
                          ("messageClassExtension", Seq())])

# --- CCCH messages ------------------------------------------------------------

S_TMSI = Seq(f("mmec", MMEC), f("m_tmsi", BitString(32)))

InitialUE_Identity = Choice([("s_tmsi", S_TMSI),
                             ("randomValue", BitString(40))])

EstablishmentCause = Enum(
    ["emergency", "highPriorityAccess", "mt_Access", "mo_Signalling",
     "mo_Data", "spare3", "spare2", "spare1"])

RRCConnectionRequest = Seq(
    f("critical_extensions", Choice([
        ("r8", Seq(f("ue_identity", InitialUE_Identity),
                   f("establishment_cause", EstablishmentCause),
                   f("spare", BitString(1), default=0))),
        ("criticalExtensionsFuture", Seq())])),
)

ReestabUE_Identity = Seq(f("c_rnti", BitString(16)),
                         f("phys_cell_id", PhysCellId),
                         f("short_mac_i", ShortMAC_I))

RRCConnectionReestablishmentRequest = Seq(
    f("critical_extensions", Choice([
        ("r8", Seq(f("ue_identity", ReestabUE_Identity),
                   f("reestablishment_cause", Enum(4)),
                   f("spare", BitString(2), default=0))),
        ("criticalExtensionsFuture", Seq())])),
)

UL_CCCH_Message = Choice([("c1", Choice([
    ("rrcConnectionReestablishmentRequest",
     RRCConnectionReestablishmentRequest),
    ("rrcConnectionRequest", RRCConnectionRequest)])),
    ("messageClassExtension", Seq())])

RRCConnectionSetup = Seq(
    f("rrc_transaction_identifier", Int(0, 3)),
    f("critical_extensions", crit_ext_c1(
        Seq(f("radio_resource_config_dedicated",
              RadioResourceConfigDedicated),
            f("non_critical_extension", Seq(), optional=True)))),
)

RRCConnectionReestablishment = Seq(
    f("rrc_transaction_identifier", Int(0, 3)),
    f("critical_extensions", crit_ext_c1(
        Seq(f("radio_resource_config_dedicated",
              RadioResourceConfigDedicated),
            f("next_hop_chaining_count", Int(0, 7)),
            f("non_critical_extension", Seq(), optional=True)))),
)

RRCConnectionReject = Seq(
    f("critical_extensions", crit_ext_c1(
        Seq(f("wait_time", Int(1, 16)),
            f("non_critical_extension", Seq(), optional=True)),
        n_spare=3)),
)

DL_CCCH_Message = Choice([("c1", Choice([
    ("rrcConnectionReestablishment", RRCConnectionReestablishment),
    ("rrcConnectionReestablishmentReject", Null()),
    ("rrcConnectionReject", RRCConnectionReject),
    ("rrcConnectionSetup", RRCConnectionSetup)])),
    ("messageClassExtension", Seq())])


# --- top-level pack/unpack API ------------------------------------------------


def _pack(schema, value) -> bytes:
    w = BitWriter()
    schema.pack(w, value)
    return w.to_bytes()


def _unpack(schema, data: bytes):
    return schema.unpack(BitReader(data))


def pack_ul_dcch(name: str, value) -> bytes:
    return _pack(UL_DCCH_Message, ("c1", (name, value)))


def unpack_ul_dcch(data: bytes):
    kind, inner = _unpack(UL_DCCH_Message, data)
    return inner  # (messageName, value)


def pack_dl_dcch(name: str, value) -> bytes:
    return _pack(DL_DCCH_Message, ("c1", (name, value)))


def unpack_dl_dcch(data: bytes):
    return _unpack(DL_DCCH_Message, data)[1]


def pack_ul_ccch(name: str, value) -> bytes:
    return _pack(UL_CCCH_Message, ("c1", (name, value)))


def unpack_ul_ccch(data: bytes):
    return _unpack(UL_CCCH_Message, data)[1]


def pack_dl_ccch(name: str, value) -> bytes:
    return _pack(DL_CCCH_Message, ("c1", (name, value)))


def unpack_dl_ccch(data: bytes):
    return _unpack(DL_CCCH_Message, data)[1]


# --- system information (BCCH-DL-SCH; 36.331 6.2.2/6.3.1) ---------------------

PLMN_IdentityInfo = Seq(
    f("plmn_identity", PLMN_Identity),
    f("cell_reserved_for_operator_use", Enum(["reserved", "notReserved"])),
)

SchedulingInfo = Seq(
    f("si_periodicity", Enum(7)),              # rf8..rf512
    f("sib_mapping_info", SeqOf(Enum(16, ext=True), 0, 31)),
)

SystemInformationBlockType1 = Seq(
    f("cell_access_related_info", Seq(
        f("plmn_identity_list", SeqOf(PLMN_IdentityInfo, 1, 6)),
        f("tracking_area_code", TrackingAreaCode),
        f("cell_identity", CellIdentity),
        f("cell_barred", Enum(["barred", "notBarred"])),
        f("intra_freq_reselection", Enum(["allowed", "notAllowed"])),
        f("csg_indication", Bool()),
        f("csg_identity", BitString(27), optional=True))),
    f("cell_selection_info", Seq(
        f("q_rx_lev_min", Int(-70, -22)),
        f("q_rx_lev_min_offset", Int(1, 8), optional=True))),
    f("p_max", Int(-30, 33), optional=True),
    f("freq_band_indicator", Int(1, 64)),
    f("scheduling_info_list", SeqOf(SchedulingInfo, 1, 32)),
    f("tdd_config", Null(), optional=True),
    f("si_window_length", Enum(7)),            # ms1..ms40
    f("system_info_value_tag", Int(0, 31)),
    f("non_critical_extension", RawTail(), optional=True),
)

BCCH_Config = Seq(f("modification_period_coeff", Enum(4)))
PCCH_Config = Seq(f("default_paging_cycle", Enum(4)), f("nb", Enum(8)))

PRACH_ConfigSIB = Seq(
    f("root_sequence_index", Int(0, 837)),
    f("prach_config_info", PRACH_ConfigInfo),
)

RadioResourceConfigCommonSIB = Seq(
    f("rach_config_common", RACH_ConfigCommon),
    f("bcch_config", BCCH_Config),
    f("pcch_config", PCCH_Config),
    f("prach_config", PRACH_ConfigSIB),
    f("pdsch_config_common", PDSCH_ConfigCommon),
    f("pusch_config_common", PUSCH_ConfigCommon),
    f("pucch_config_common", PUCCH_ConfigCommon),
    f("sounding_rs_ul_config_common", SoundingRS_UL_ConfigCommon),
    f("uplink_power_control_common", UplinkPowerControlCommon),
    f("ul_cyclic_prefix_length", Enum(2)),
    ext=True,
)

UE_TimersAndConstants = Seq(
    f("t300", Enum(8)), f("t301", Enum(8)), f("t310", Enum(7)),
    f("n310", Enum(8)), f("t311", Enum(7)), f("n311", Enum(8)),
    ext=True,
)

AC_BarringConfig = Seq(
    f("ac_barring_factor", Enum(16)),
    f("ac_barring_time", Enum(8)),
    f("ac_barring_for_special_ac", BitString(5)),
)

MBSFN_SubframeConfig = Seq(
    f("radioframe_allocation_period", Enum(8)),
    f("radioframe_allocation_offset", Int(0, 7)),
    f("subframe_allocation", Choice([("oneFrame", BitString(6)),
                                     ("fourFrames", BitString(24))])),
)

SystemInformationBlockType2 = Seq(
    f("ac_barring_info", Seq(
        f("ac_barring_for_emergency", Bool()),
        f("ac_barring_for_mo_signalling", AC_BarringConfig, optional=True),
        f("ac_barring_for_mo_data", AC_BarringConfig, optional=True)),
      optional=True),
    f("radio_resource_config_common", RadioResourceConfigCommonSIB),
    f("ue_timers_and_constants", UE_TimersAndConstants),
    f("freq_info", Seq(
        f("ul_carrier_freq", ARFCN_ValueEUTRA, optional=True),
        f("ul_bandwidth", Enum(6), optional=True),
        f("additional_spectrum_emission", Int(1, 32)))),
    f("mbsfn_subframe_config_list", SeqOf(MBSFN_SubframeConfig, 1, 8),
      optional=True),
    f("time_alignment_timer_common", Enum(8)),
    ext=True,
)

SystemInformationBlockType3 = Seq(
    f("cell_reselection_info_common", Seq(
        f("q_hyst", Enum(16)),
        f("speed_state_reselection_pars", Seq(
            f("mobility_state_parameters", Seq(
                f("t_evaluation", Enum(8)), f("t_hyst_normal", Enum(8)),
                f("n_cell_change_medium", Int(1, 16)),
                f("n_cell_change_high", Int(1, 16)))),
            f("q_hyst_sf", Seq(f("sf_medium", Enum(4)),
                               f("sf_high", Enum(4))))), optional=True))),
    f("cell_reselection_serving_freq_info", Seq(
        f("s_non_intra_search", Int(0, 31), optional=True),
        f("thresh_serving_low", Int(0, 31)),
        f("cell_reselection_priority", Int(0, 7)))),
    f("intra_freq_cell_reselection_info", Seq(
        f("q_rx_lev_min", Int(-70, -22)),
        f("p_max", Int(-30, 33), optional=True),
        f("s_intra_search", Int(0, 31), optional=True),
        f("allowed_meas_bandwidth", Enum(6), optional=True),
        f("presence_antenna_port1", Bool()),
        f("neigh_cell_config", BitString(2)),
        f("t_reselection_eutra", Int(0, 7)),
        f("t_reselection_eutra_sf", Seq(f("sf_medium", Enum(4)),
                                        f("sf_high", Enum(4))),
          optional=True))),
    ext=True,
)

# --- SIB4-13 (36.331 6.3.1) --------------------------------------------------
# The reference codes exactly SIB1-9 + SIB13 (liblte_rrc.h:5640-5964,
# liblte_rrc.cc pack/unpack_sys_info_block_type_{4..9,13}_ie); SIB10-12
# (ETWS/CMAS) are added here for completeness of the SI container.

PhysCellIdRange = Seq(
    f("start", PhysCellId),
    f("range", Enum(16), optional=True),   # n4..n504 + spares
)

SpeedStateScaleFactors = Seq(f("sf_medium", Enum(4)), f("sf_high", Enum(4)))

IntraFreqNeighCellInfo = Seq(
    f("phys_cell_id", PhysCellId),
    f("q_offset_cell", Q_OffsetRange),
    ext=True,
)

SystemInformationBlockType4 = Seq(
    f("intra_freq_neigh_cell_list", SeqOf(IntraFreqNeighCellInfo, 1, 16),
      optional=True),
    f("intra_freq_black_cell_list", SeqOf(PhysCellIdRange, 1, 16),
      optional=True),
    f("csg_phys_cell_id_range", PhysCellIdRange, optional=True),
    ext=True,
)

InterFreqNeighCellInfo = Seq(
    f("phys_cell_id", PhysCellId),
    f("q_offset_cell", Q_OffsetRange),
)

InterFreqCarrierFreqInfo = Seq(
    f("dl_carrier_freq", ARFCN_ValueEUTRA),
    f("q_rx_lev_min", Int(-70, -22)),
    f("p_max", Int(-30, 33), optional=True),
    f("t_reselection_eutra", Int(0, 7)),
    f("t_reselection_eutra_sf", SpeedStateScaleFactors, optional=True),
    f("thresh_x_high", Int(0, 31)),
    f("thresh_x_low", Int(0, 31)),
    f("allowed_meas_bandwidth", Enum(6)),
    f("presence_antenna_port1", Bool()),
    f("cell_reselection_priority", Int(0, 7), optional=True),
    f("neigh_cell_config", BitString(2)),
    # spec says DEFAULT dB0 (presence bit + omit-when-default); the
    # reference encodes it unconditionally with no presence bit
    # (liblte_rrc.cc pack_sys_info_block_type_5_ie) — match its wire format
    f("q_offset_freq", Q_OffsetRange, default=15),
    f("inter_freq_neigh_cell_list", SeqOf(InterFreqNeighCellInfo, 1, 16),
      optional=True),
    f("inter_freq_black_cell_list", SeqOf(PhysCellIdRange, 1, 16),
      optional=True),
    ext=True,
)

SystemInformationBlockType5 = Seq(
    f("inter_freq_carrier_freq_list", SeqOf(InterFreqCarrierFreqInfo, 1, 8)),
    ext=True,
)

CarrierFreqUTRA_FDD = Seq(
    f("carrier_freq", Int(0, 16383)),
    f("cell_reselection_priority", Int(0, 7), optional=True),
    f("thresh_x_high", Int(0, 31)),
    f("thresh_x_low", Int(0, 31)),
    f("q_rx_lev_min", Int(-60, -13)),
    f("p_max_utra", Int(-50, 33)),
    f("q_qual_min", Int(-24, 0)),
    ext=True,
)

CarrierFreqUTRA_TDD = Seq(
    f("carrier_freq", Int(0, 16383)),
    f("cell_reselection_priority", Int(0, 7), optional=True),
    f("thresh_x_high", Int(0, 31)),
    f("thresh_x_low", Int(0, 31)),
    f("q_rx_lev_min", Int(-60, -13)),
    f("p_max_utra", Int(-50, 33)),
    ext=True,
)

SystemInformationBlockType6 = Seq(
    f("carrier_freq_list_utra_fdd", SeqOf(CarrierFreqUTRA_FDD, 1, 16),
      optional=True),
    f("carrier_freq_list_utra_tdd", SeqOf(CarrierFreqUTRA_TDD, 1, 16),
      optional=True),
    f("t_reselection_utra", Int(0, 7)),
    f("t_reselection_utra_sf", SpeedStateScaleFactors, optional=True),
    ext=True,
)

CarrierFreqsGERAN = Seq(
    f("starting_arfcn", Int(0, 1023)),
    f("band_indicator", Enum(["dcs1800", "pcs1900"])),
    f("following_arfcns", Choice([
        ("explicitListOfARFCNs", SeqOf(Int(0, 1023), 0, 31)),
        ("equallySpacedARFCNs", Seq(
            f("arfcn_spacing", Int(1, 8)),
            f("number_of_following_arfcns", Int(0, 31)))),
        ("variableBitMapOfARFCNs", OctetString(lo=1, hi=16))])),
)

CarrierFreqsInfoGERAN = Seq(
    f("carrier_freqs", CarrierFreqsGERAN),
    f("common_info", Seq(
        f("cell_reselection_priority", Int(0, 7), optional=True),
        f("ncc_permitted", BitString(8)),
        f("q_rx_lev_min", Int(0, 45)),
        f("p_max_geran", Int(0, 39), optional=True),
        f("thresh_x_high", Int(0, 31)),
        f("thresh_x_low", Int(0, 31)))),
    ext=True,
)

SystemInformationBlockType7 = Seq(
    f("t_reselection_geran", Int(0, 7)),
    f("t_reselection_geran_sf", SpeedStateScaleFactors, optional=True),
    f("carrier_freqs_info_list", SeqOf(CarrierFreqsInfoGERAN, 1, 16),
      optional=True),
    ext=True,
)

BandclassCDMA2000 = Enum(32, ext=True)

BandClassInfoCDMA2000 = Seq(
    f("band_class", BandclassCDMA2000),
    f("cell_reselection_priority", Int(0, 7), optional=True),
    f("thresh_x_high", Int(0, 63)),
    f("thresh_x_low", Int(0, 63)),
    ext=True,
)

NeighCellsPerBandclassCDMA2000 = Seq(
    f("arfcn", Int(0, 2047)),
    f("phys_cell_id_list", SeqOf(Int(0, 511), 1, 16)),
)

NeighCellCDMA2000 = Seq(
    f("band_class", BandclassCDMA2000),
    f("neigh_cells_per_freq_list",
      SeqOf(NeighCellsPerBandclassCDMA2000, 1, 16)),
)

CellReselectionParametersCDMA2000 = Seq(
    f("band_class_list", SeqOf(BandClassInfoCDMA2000, 1, 32)),
    f("neigh_cell_list", SeqOf(NeighCellCDMA2000, 1, 16)),
    f("t_reselection_cdma2000", Int(0, 7)),
    f("t_reselection_cdma2000_sf", SpeedStateScaleFactors, optional=True),
)

CSFB_RegistrationParam1XRTT = Seq(
    f("sid", BitString(15)), f("nid", BitString(16)),
    f("multiple_sid", Bool()), f("multiple_nid", Bool()),
    f("home_reg", Bool()), f("foreign_sid_reg", Bool()),
    f("foreign_nid_reg", Bool()), f("parameter_reg", Bool()),
    f("power_up_reg", Bool()), f("registration_period", BitString(7)),
    f("registration_zone", BitString(12)), f("total_zone", BitString(3)),
    f("zone_timer", BitString(3)),
)

SystemTimeInfoCDMA2000 = Seq(
    f("cdma_eutra_synchronisation", Bool()),
    f("cdma_system_time", Choice([
        ("synchronousSystemTime", BitString(39)),
        ("asynchronousSystemTime", BitString(49))])),
)

PreRegistrationInfoHRPD = Seq(
    f("pre_registration_allowed", Bool()),
    f("pre_registration_zone_id", Int(0, 255), optional=True),
    f("secondary_pre_registration_zone_id_list", SeqOf(Int(0, 255), 1, 2),
      optional=True),
)

SystemInformationBlockType8 = Seq(
    f("system_time_info", SystemTimeInfoCDMA2000, optional=True),
    f("search_window_size", Int(0, 15), optional=True),
    f("parameters_hrpd", Seq(
        f("pre_registration_info_hrpd", PreRegistrationInfoHRPD),
        f("cell_reselection_parameters_hrpd",
          CellReselectionParametersCDMA2000, optional=True)), optional=True),
    f("parameters_1xrtt", Seq(
        f("csfb_registration_param_1xrtt", CSFB_RegistrationParam1XRTT,
          optional=True),
        f("long_code_state_1xrtt", BitString(42), optional=True),
        f("cell_reselection_parameters_1xrtt",
          CellReselectionParametersCDMA2000, optional=True)), optional=True),
    ext=True,
)

SystemInformationBlockType9 = Seq(
    f("hnb_name", OctetString(lo=1, hi=48), optional=True),
    ext=True,
)

SystemInformationBlockType10 = Seq(
    f("message_identifier", BitString(16)),
    f("serial_number", BitString(16)),
    f("warning_type", OctetString(2)),
    f("warning_security_info", OctetString(50), optional=True),
    ext=True,
)

SystemInformationBlockType11 = Seq(
    f("message_identifier", BitString(16)),
    f("serial_number", BitString(16)),
    f("warning_message_segment_type",
      Enum(["notLastSegment", "lastSegment"])),
    f("warning_message_segment_number", Int(0, 63)),
    f("warning_message_segment", OctetString()),
    f("data_coding_scheme", OctetString(1), optional=True),
    ext=True,
)

SystemInformationBlockType12_r9 = Seq(
    f("message_identifier", BitString(16)),
    f("serial_number", BitString(16)),
    f("warning_message_segment_type",
      Enum(["notLastSegment", "lastSegment"])),
    f("warning_message_segment_number", Int(0, 63)),
    f("warning_message_segment", OctetString()),
    f("data_coding_scheme", OctetString(1), optional=True),
    f("late_non_critical_extension", OctetString(), optional=True),
    ext=True,
)

MBSFN_AreaInfo_r9 = Seq(
    f("mbsfn_area_id", Int(0, 255)),
    f("non_mbsfn_region_length", Enum(["s1", "s2"])),
    f("notification_indicator", Int(0, 7)),
    f("mcch_config", Seq(
        f("mcch_repetition_period", Enum(["rf32", "rf64", "rf128", "rf256"])),
        f("mcch_offset", Int(0, 10)),
        f("mcch_modification_period", Enum(["rf512", "rf1024"])),
        f("sf_alloc_info", BitString(6)),
        f("signalling_mcs", Enum(["n2", "n7", "n13", "n19"])))),
    ext=True,
)

SystemInformationBlockType13_r9 = Seq(
    f("mbsfn_area_info_list", SeqOf(MBSFN_AreaInfo_r9, 1, 8)),
    f("notification_config", Seq(
        f("notification_repetition_coeff", Enum(["n2", "n4"])),
        f("notification_offset", Int(0, 10)),
        f("notification_sf_index", Int(1, 6)))),
    f("late_non_critical_extension", OctetString(), optional=True),
    ext=True,
)

_sib_type_and_info = Choice([
    ("sib2", SystemInformationBlockType2),
    ("sib3", SystemInformationBlockType3),
    ("sib4", SystemInformationBlockType4),
    ("sib5", SystemInformationBlockType5),
    ("sib6", SystemInformationBlockType6),
    ("sib7", SystemInformationBlockType7),
    ("sib8", SystemInformationBlockType8),
    ("sib9", SystemInformationBlockType9),
    ("sib10", SystemInformationBlockType10),
    ("sib11", SystemInformationBlockType11),
], ext_options=[
    ("sib12_v920", SystemInformationBlockType12_r9),
    ("sib13_v920", SystemInformationBlockType13_r9),
])

SystemInformation = Seq(
    f("critical_extensions", Choice([
        ("systemInformation_r8", Seq(
            f("sib_type_and_info", SeqOf(_sib_type_and_info, 1, 32)),
            f("non_critical_extension", Seq(), optional=True))),
        ("criticalExtensionsFuture", Seq())])),
)

BCCH_DL_SCH_Message = Choice([("c1", Choice([
    ("systemInformation", SystemInformation),
    ("systemInformationBlockType1", SystemInformationBlockType1)])),
    ("messageClassExtension", Seq())])


def pack_bcch_dlsch(name: str, value) -> bytes:
    return _pack(BCCH_DL_SCH_Message, ("c1", (name, value)))


def unpack_bcch_dlsch(data: bytes):
    return _unpack(BCCH_DL_SCH_Message, data)[1]


# --- paging (PCCH; 36.331 6.2.2) ----------------------------------------------

IMSI = SeqOf(Digit, 6, 21)

PagingUE_Identity = Choice([("s_tmsi", S_TMSI), ("imsi", IMSI)], ext=True)

PagingRecord = Seq(
    f("ue_identity", PagingUE_Identity),
    f("cn_domain", Enum(["ps", "cs"])),
    ext=True,
)

Paging = Seq(
    f("paging_record_list", SeqOf(PagingRecord, 1, 16), optional=True),
    f("system_info_modification", Enum(["true"]), optional=True),
    f("etws_indication", Enum(["true"]), optional=True),
    f("non_critical_extension", Seq(), optional=True),
)

PCCH_Message = Choice([("c1", Choice([("paging", Paging)])),
                       ("messageClassExtension", Seq())])


def pack_pcch(value) -> bytes:
    return _pack(PCCH_Message, ("c1", ("paging", value)))


def unpack_pcch(data: bytes):
    return _unpack(PCCH_Message, data)[1][1]


# --- MCCH (eMBMS control; 36.331 6.2.1 MCCH-Message, liblte mcch) -------------

TMGI = Seq(
    f("plmn_id", Choice([("plmn_index", Int(1, 6)),
                         ("explicitValue", PLMN_Identity)])),
    f("service_id", OctetString(3)),
)

MBMS_SessionInfo = Seq(
    f("tmgi", TMGI),
    f("session_id", OctetString(1), optional=True),
    f("logical_channel_identity", Int(0, 28)),
    ext=True,
)

PMCH_Config = Seq(
    f("sf_alloc_end", Int(0, 1535)),
    f("data_mcs", Int(0, 28)),
    f("mch_scheduling_period", Enum(8)),    # rf8..rf1024
    ext=True,
)

PMCH_Info = Seq(
    f("pmch_config", PMCH_Config),
    f("mbms_session_info_list", SeqOf(MBMS_SessionInfo, 0, 29)),
    ext=True,
)

MBSFNAreaConfiguration = Seq(
    f("commonsf_alloc", SeqOf(MBSFN_SubframeConfig, 1, 8)),
    f("commonsf_alloc_period", Enum(7)),    # rf4..rf256
    f("pmch_info_list", SeqOf(PMCH_Info, 0, 15)),
    f("non_critical_extension", Seq(), optional=True),
)

MCCH_Message = Choice([("c1", Choice([("mbsfnAreaConfiguration",
                                       MBSFNAreaConfiguration)])),
                       ("messageClassExtension", Seq())])


def pack_mcch(value) -> bytes:
    return _pack(MCCH_Message, ("c1", ("mbsfnAreaConfiguration", value)))


def unpack_mcch(data: bytes):
    return _unpack(MCCH_Message, data)[1][1]


# --- Inter-node messages (36.331 10.2.2) -------------------------------------
# HandoverPreparationInformation, reduced to the AS context the target
# admission consumes (the reference has no inter-eNB preparation path —
# its handover is intra-eNB, srsenb/src/upper/rrc.cc — so this container
# backs the S1 handover leg the S1AP layer adds).

HandoverPrepInfo = Seq(
    f("source_pci", PhysCellId),
    f("old_c_rnti", BitString(16)),
    f("ue_category", Int(1, 5)),
    ext=True,
)


def pack_handover_prep_info(source_pci: int, old_c_rnti: int,
                            ue_category: int = 4) -> bytes:
    from .per import BitWriter

    w = BitWriter()
    HandoverPrepInfo.pack(w, {"source_pci": source_pci,
                              "old_c_rnti": old_c_rnti,
                              "ue_category": ue_category})
    return w.to_bytes()


def unpack_handover_prep_info(data: bytes) -> dict:
    from .per import BitReader

    return HandoverPrepInfo.unpack(BitReader(data))
