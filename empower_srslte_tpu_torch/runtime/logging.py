"""Layered logging with TTI stamps and hex dumps.

Capability parity with lib/src/common/log_filter.cc / logger_file.cc: a
per-layer leveled logger ([PHY], [MAC], ...) with TTI timestamps and
optional hex dumps, backed by Python logging (whose handlers provide the
reference's background-file-writer behavior).
"""

from __future__ import annotations

import logging
import sys

LEVELS = {"none": logging.CRITICAL + 10, "error": logging.ERROR,
          "warning": logging.WARNING, "info": logging.INFO,
          "debug": logging.DEBUG}

_root_configured = False


def _configure_root(filename: str | None = None):
    global _root_configured
    if _root_configured:
        return
    handler = (logging.FileHandler(filename) if filename
               else logging.StreamHandler(sys.stdout))
    handler.setFormatter(logging.Formatter("%(asctime)s [%(name)-4s] %(levelname).1s %(message)s"))
    root = logging.getLogger("srslte_tpu")
    root.addHandler(handler)
    root.setLevel(logging.DEBUG)
    _root_configured = True


def get_logger(layer: str, level: str = "info",
               filename: str | None = None) -> "LogFilter":
    _configure_root(filename)
    return LogFilter(layer, level)


class LogFilter:
    """Per-layer logger with TTI context (log_filter.h:50-97 analog)."""

    def __init__(self, layer: str, level: str = "info"):
        self._log = logging.getLogger(f"srslte_tpu.{layer}")
        self._log.setLevel(LEVELS[level])
        self.tti: int | None = None
        self.hex_limit = 32

    def set_level(self, level: str) -> None:
        self._log.setLevel(LEVELS[level])

    def step(self, tti: int) -> None:
        self.tti = tti

    def _fmt(self, msg: str) -> str:
        return f"[{self.tti:5d}] {msg}" if self.tti is not None else msg

    def error(self, msg: str, *a) -> None:
        self._log.error(self._fmt(msg % a if a else msg))

    def warning(self, msg: str, *a) -> None:
        self._log.warning(self._fmt(msg % a if a else msg))

    def info(self, msg: str, *a) -> None:
        self._log.info(self._fmt(msg % a if a else msg))

    def debug(self, msg: str, *a) -> None:
        self._log.debug(self._fmt(msg % a if a else msg))

    def info_hex(self, data, msg: str, *a) -> None:
        import numpy as np

        b = np.asarray(data).tobytes()[: self.hex_limit]
        dump = " ".join(f"{x:02x}" for x in b)
        self._log.info(self._fmt((msg % a if a else msg) + f" [{dump}]"))
