"""libconfig-grammar parser for the eNB cell configuration files.

The reference parses sib.conf / rr.conf / drb.conf with libconfig++
(srsenb/src/enb_cfg_parser.cc via parser.cc:32); enb.conf itself is INI
(handled by runtime.config). This is a dependency-free recursive-descent
parser for the libconfig subset those files use:

* groups     ``name = { setting; ... };``
* lists      ``name = ( value, value, ... );``
* arrays     ``name = [ scalar, ... ];``
* scalars    int (dec/hex), float, bool, "string"
* comments   ``//``, ``#``, ``/* ... */``
* ``=`` or ``:`` assignment, optional ``;``/``,`` terminators

plus typed mappers from the parsed trees onto the framework's dataclasses
(UlSchConfig from rr.conf's mac_cnfg, per-QCI RLC/PDCP setups from
drb.conf, SIB1/SIB2 field dicts from sib.conf).
"""

from __future__ import annotations

import re
from dataclasses import dataclass

_TOKEN = re.compile(r"""
    (?P<ws>\s+)
  | (?P<comment>//[^\n]*|\#[^\n]*|/\*.*?\*/)
  | (?P<float>[-+]?(\d+\.\d*|\.\d+)([eE][-+]?\d+)?|[-+]?\d+[eE][-+]?\d+)
  | (?P<hex>0[xX][0-9a-fA-F]+)
  | (?P<int>[-+]?\d+L?)
  | (?P<bool>\b(true|false|TRUE|FALSE)\b)
  | (?P<string>"(?:[^"\\]|\\.)*")
  | (?P<name>[A-Za-z*][-A-Za-z0-9_*.]*)
  | (?P<punct>[={}()\[\];:,])
""", re.VERBOSE | re.DOTALL)


def _tokenize(text: str):
    pos = 0
    out = []
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ValueError(f"libconf: bad token at offset {pos}: "
                             f"{text[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        out.append((kind, m.group()))
    return out


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else (None, None)

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, val):
        kind, tok = self.next()
        if tok != val:
            raise ValueError(f"libconf: expected {val!r}, got {tok!r}")

    def parse_settings(self, stop=None) -> dict:
        out = {}
        while True:
            kind, tok = self.peek()
            if kind is None or tok == stop:
                return out
            if tok in (";", ","):
                self.next()
                continue
            if kind != "name":
                raise ValueError(f"libconf: expected setting name, got "
                                 f"{tok!r}")
            self.next()
            k2, t2 = self.peek()
            if t2 in ("=", ":"):
                self.next()
            out[tok] = self.parse_value()

    def parse_value(self):
        kind, tok = self.peek()
        if tok == "{":
            self.next()
            v = self.parse_settings(stop="}")
            self.expect("}")
            return v
        if tok == "(":
            self.next()
            v = self.parse_seq(")")
            self.expect(")")
            return v
        if tok == "[":
            self.next()
            v = self.parse_seq("]")
            self.expect("]")
            return v
        self.next()
        if kind == "int":
            return int(tok.rstrip("L"))
        if kind == "hex":
            return int(tok, 16)
        if kind == "float":
            return float(tok)
        if kind == "bool":
            return tok.lower() == "true"
        if kind == "string":
            return tok[1:-1].encode().decode("unicode_escape")
        raise ValueError(f"libconf: unexpected value token {tok!r}")

    def parse_seq(self, stop) -> list:
        out = []
        while True:
            kind, tok = self.peek()
            if tok == stop:
                return out
            if tok == ",":
                self.next()
                continue
            out.append(self.parse_value())


def parse(text: str) -> dict:
    """Parse a libconfig document into nested dict/list/scalar values."""
    return _Parser(_tokenize(text)).parse_settings()


def parse_file(path: str) -> dict:
    with open(path) as f:
        return parse(f.read())


# --- typed mappers -----------------------------------------------------------


def load_mac_cnfg(rr: dict):
    """rr.conf mac_cnfg -> mac.procs.UlSchConfig (enb_cfg_parser.cc
    mac_cnfg section)."""
    from ..mac.procs import UlSchConfig

    mac = rr.get("mac_cnfg", {})
    phr = mac.get("phr_cnfg", {})
    ulsch = mac.get("ulsch_cnfg", {})
    sr = rr.get("phy_cnfg", {}).get("sched_request_cnfg", {})
    plc = str(phr.get("dl_pathloss_change", "3dB")).rstrip("dB")
    sr_sf = sr.get("subframe", [0])
    return UlSchConfig(
        periodic_bsr_timer_ms=int(ulsch.get("periodic_bsr_timer", 0)),
        retx_bsr_timer_ms=int(ulsch.get("retx_bsr_timer", 2560)),
        sr_configured="sched_request_cnfg" in rr.get("phy_cnfg", {}),
        dsr_trans_max=int(sr.get("dsr_trans_max", 4)),
        sr_period_ms=int(sr.get("period", 10)),
        sr_subframe=int(sr_sf[0]) if sr_sf else 0,
        phr_setup=bool(phr),
        periodic_phr_timer_ms=int(phr.get("periodic_phr_timer", 50)),
        prohibit_phr_timer_ms=int(phr.get("prohibit_phr_timer", 0)),
        dl_pathloss_change_db=int(plc) if plc.isdigit() else 0,
    )


@dataclass
class QciConfig:
    """One drb.conf qci_config entry (enb_cfg_parser.cc parse_drb)."""
    qci: int
    rlc_mode: str               # "um" | "am"
    pdcp_sn_size: int = 12
    discard_timer_ms: int = 100
    status_report_required: bool = False
    t_reordering_ms: int = 45
    priority: int = 13
    log_chan_group: int = 2
    prioritized_bit_rate: int = -1
    bucket_size_duration_ms: int = 100


def load_drb_conf(drb: dict) -> dict[int, QciConfig]:
    out = {}
    for entry in drb.get("qci_config", []):
        qci = int(entry["qci"])
        rlc = entry.get("rlc_config", {})
        mode = "am" if "ul_am" in rlc or "am" in rlc else "um"
        pdcp = entry.get("pdcp_config", {})
        lc = entry.get("logical_channel_config", {})
        dl_um = rlc.get("dl_um", {})
        out[qci] = QciConfig(
            qci=qci,
            rlc_mode=mode,
            pdcp_sn_size=int(pdcp.get("pdcp_sn_size", 12)),
            discard_timer_ms=int(pdcp.get("discard_timer", 100)),
            status_report_required=bool(
                pdcp.get("status_report_required", False)),
            t_reordering_ms=int(dl_um.get("t_reordering", 45)),
            priority=int(lc.get("priority", 13)),
            log_chan_group=int(lc.get("log_chan_group", 2)),
            prioritized_bit_rate=int(lc.get("prioritized_bit_rate", -1)),
            bucket_size_duration_ms=int(lc.get("bucket_size_duration",
                                               100)),
        )
    return out


def load_sib_conf(sib: dict) -> dict:
    """sib.conf -> flat dicts for SIB1/SIB2/SIB3 construction (the fields
    the rrc.messages SIB schemas carry)."""
    out = {}
    s1 = sib.get("sib1", {})
    if s1:
        out["sib1"] = dict(
            intra_freq_reselection=s1.get("intra_freq_reselection",
                                          "Allowed") == "Allowed",
            q_rx_lev_min=int(s1.get("q_rx_lev_min", -130)),
            cell_barred=s1.get("cell_barred", "Not Barred") != "Not Barred",
            si_window_length=int(s1.get("si_window_length", 20)),
            sched_info=[dict(si_periodicity=int(e.get("si_periodicity", 16)),
                             si_mapping_info=[int(x) for x in
                                              e.get("si_mapping_info", [])])
                        for e in s1.get("sched_info", [])],
            system_info_value_tag=int(s1.get("system_info_value_tag", 0)),
        )
    s2 = sib.get("sib2", {})
    if s2:
        rr_common = s2.get("rr_config_common_sib", {})
        rach = rr_common.get("rach_cnfg", {})
        prach = rr_common.get("prach_cnfg", {})
        prach_info = prach.get("prach_cnfg_info", {})
        out["sib2"] = dict(
            num_ra_preambles=int(rach.get("num_ra_preambles", 52)),
            preamble_trans_max=int(rach.get("preamble_trans_max", 10)),
            ra_resp_win_size=int(rach.get("ra_resp_win_size", 10)),
            mac_con_res_timer=int(rach.get("mac_con_res_timer", 64)),
            max_harq_msg3_tx=int(rach.get("max_harq_msg3_tx", 4)),
            root_sequence_index=int(prach.get("root_sequence_index", 128)),
            prach_config_index=int(prach_info.get("prach_config_index", 3)),
            prach_freq_offset=int(prach_info.get("prach_freq_offset", 2)),
            zero_correlation_zone_config=int(
                prach_info.get("zero_correlation_zone_config", 5)),
            high_speed_flag=bool(prach_info.get("high_speed_flag", False)),
        )
    s3 = sib.get("sib3", {})
    if s3:
        cell_resel = s3.get("cell_reselection_common", {})
        out["sib3"] = dict(
            q_hyst=int(str(cell_resel.get("q_hyst", 0)).rstrip("dB") or 0),
        )
    return out
