"""Configuration system: INI files + --section.key CLI overrides.

Capability parity with the reference's configuration surface: srsue/srsenb
parse CLI + INI via boost::program_options with every option addressable
as --section.key (srsue/src/main.cc:36-69), and the eNB cell files use
libconfig (srsenb/src/parser.cc). Here: frozen dataclasses per section,
an INI loader, and the same --section.key=value override grammar.
"""

from __future__ import annotations

import configparser
from dataclasses import dataclass, field, fields


@dataclass
class RfConfig:
    freq_hz: float = 2.68e9
    srate_hz: float = 11.52e6
    rx_gain: float = 40.0
    tx_gain: float = 40.0
    device: str = "file"           # file | net | (hardware via plugin)
    device_args: str = ""


@dataclass
class CellFileConfig:
    nof_prb: int = 50
    nof_ports: int = 1
    cell_id: int = 1
    cp: str = "normal"


@dataclass
class LogConfig:
    phy_level: str = "warning"
    mac_level: str = "warning"
    all_level: str = "warning"
    filename: str = ""
    hex_limit: int = 32


@dataclass
class ExpertConfig:
    nof_workers: int = 1           # kept for CLI parity; batching replaces it
    turbo_iterations: int = 5
    turbo_window: int = 128
    decoder_impl: str = "xla"
    metrics_period_s: float = 1.0
    metrics_csv_enable: bool = False
    metrics_csv_filename: str = "metrics.csv"


@dataclass
class SchedulerConfig:
    policy: str = "rr"             # rr | ran_multi | ran_duo
    pdsch_mcs: int = -1            # -1 = from CQI
    pdsch_max_mcs: int = 28
    nof_ctrl_symbols: int = 1


@dataclass
class AppConfig:
    rf: RfConfig = field(default_factory=RfConfig)
    cell: CellFileConfig = field(default_factory=CellFileConfig)
    log: LogConfig = field(default_factory=LogConfig)
    expert: ExpertConfig = field(default_factory=ExpertConfig)
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)


def _coerce(value: str, typ):
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return value


def load_config(ini_path: str | None = None,
                overrides: list[str] | None = None) -> AppConfig:
    """Build an AppConfig from an INI file plus --section.key=value args."""
    cfg = AppConfig()
    sections = {f.name: getattr(cfg, f.name) for f in fields(cfg)}

    def apply(section: str, key: str, value: str):
        obj = sections.get(section)
        if obj is None:
            raise KeyError(f"unknown config section [{section}]")
        match = {f.name: f for f in fields(obj)}
        if key not in match:
            raise KeyError(f"unknown option {section}.{key}")
        setattr(obj, key, _coerce(value, match[key].type if isinstance(
            match[key].type, type) else type(getattr(obj, key))))

    if ini_path:
        parser = configparser.ConfigParser()
        parser.read(ini_path)
        for section in parser.sections():
            for key, value in parser.items(section):
                apply(section, key, value)

    for ov in overrides or []:
        ov = ov.lstrip("-")
        dotted, _, value = ov.partition("=")
        section, _, key = dotted.partition(".")
        apply(section, key, value)
    return cfg
