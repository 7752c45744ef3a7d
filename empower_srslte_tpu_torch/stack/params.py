"""Shared UE/eNB air-interface parameters (the rr.conf/sib.conf common
radio-resource config of the reference: prach-Config, pucch-ConfigCommon,
msg3 grant shape — srsenb/rr.conf.example, enb_cfg_parser.cc).

The frequency plan keeps every uplink channel in a disjoint PRB region so
the multi-UE summed air never self-interferes (25-PRB reference layout):

  PRB 0..1 / 23..24   PUCCH (format 2 region m=0, format 1 region m>=1)
  PRB 4..9            PRACH (subframe 1, prach-FreqOffset = 4)
  PRB 10..13          msg3 grants (RAR UL grant)
  PRB 14..21          dynamic PUSCH grants (4-PRB slices per UE)
"""

#: prach-ConfigIndex 3: PRACH occasion in subframe 1 of every frame.
PRACH_SF = 1
#: prach-FreqOffset (PRBs from band edge) — keeps the 6-PRB PRACH region
#: clear of the band-edge PUCCH resources (prach.c freq_offset).
PRACH_FREQ_OFFSET = 4
#: (start, n_prb) of the RAR msg3 grant.
MSG3_PRB = (10, 4)
MSG3_MCS = 4
#: First PRB of the dynamic per-UE PUSCH slices.
UL_GRANT_PRB0 = 14
UL_GRANT_N_PRB = 4
#: pucch-ConfigCommon nRB-CQI: PRB pairs reserved for format 2 (CQI);
#: format 1 (SR/ACK) resources live in the next PRB pair inward.
PUCCH_N_RB_2 = 1
#: n1PUCCH-AN: HARQ-ACK resource = N1_PUCCH + first CCE of the DL grant
#: (36.213 10.1) — distinct per UE since CCEs are distinct per subframe.
N1_PUCCH = 2
#: zeroCorrelationZoneConfig (36.211 Table 5.7.2-2): N_cs=119 supports
#: delays up to ~871 samples (~17 km cells) before zone ambiguity —
#: the reference's sib.conf default (zero_correlation_zone_config 11).
PRACH_ZCZ = 11
