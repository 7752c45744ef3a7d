"""Metrics hub with stdout-table and CSV listeners.

Capability parity with the reference's metrics_hub/metrics_stdout/
metrics_csv (srsue/src/metrics_*.cc): producers push per-period metric
dicts; listeners render a console table or append CSV rows. Used by the
example apps (tools/) to report rates like pdsch_ue.c:786-827.
"""

from __future__ import annotations

import csv
import sys
import time


class MetricsHub:
    def __init__(self):
        self._listeners = []

    def add_listener(self, listener) -> None:
        self._listeners.append(listener)

    def report(self, metrics: dict) -> None:
        stamped = {"t": time.time(), **metrics}
        for cb in self._listeners:
            cb.notify(stamped)


class MetricsStdout:
    """Periodic console table (metrics_stdout.cc analog)."""

    def __init__(self, file=None, header_every: int = 10):
        self._file = file  # None = current sys.stdout at print time
        self._count = 0
        self._header_every = header_every
        self._keys: list[str] | None = None

    def notify(self, metrics: dict) -> None:
        out = self._file or sys.stdout
        keys = [k for k in metrics if k != "t"]
        if self._keys != keys or self._count % self._header_every == 0:
            self._keys = keys
            print("  ".join(f"{k:>12s}" for k in keys), file=out)
        vals = []
        for k in keys:
            v = metrics[k]
            vals.append(f"{v:12.3f}" if isinstance(v, float) else f"{v!s:>12s}")
        print("  ".join(vals), file=out)
        self._count += 1


class MetricsCsv:
    """CSV appender (metrics_csv.cc analog)."""

    def __init__(self, path: str):
        self._path = path
        self._writer = None
        self._file = None

    def notify(self, metrics: dict) -> None:
        if self._writer is None:
            self._file = open(self._path, "w", newline="")
            self._writer = csv.DictWriter(self._file, fieldnames=list(metrics))
            self._writer.writeheader()
        self._writer.writerow(metrics)
        self._file.flush()

    def close(self) -> None:
        if self._file:
            self._file.close()
