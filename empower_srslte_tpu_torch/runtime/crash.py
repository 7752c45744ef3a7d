"""Crash handler: fault backtraces to a file (lib/src/common/crash_handler.c
parity: SIGSEGV etc. -> ./srsLTE.backtrace.crash, crash_handler.c:40-75).

Python-native equivalent via faulthandler (hard faults in native/XLA code)
plus an uncaught-exception hook appending tracebacks to the same file.
"""

from __future__ import annotations

import datetime
import faulthandler
import sys
import traceback

CRASH_FILE = "./srslte_tpu.backtrace.crash"

_installed = False
_crash_fh = None


def install(path: str = CRASH_FILE) -> None:
    """Install fault + exception handlers (call once at app start)."""
    global _installed, _crash_fh
    if _installed:
        return
    _crash_fh = open(path, "a")
    faulthandler.enable(file=_crash_fh, all_threads=True)

    prev_hook = sys.excepthook

    def hook(exc_type, exc, tb):
        _crash_fh.write(f"--- crash at {datetime.datetime.now().isoformat()} ---\n")
        traceback.print_exception(exc_type, exc, tb, file=_crash_fh)
        _crash_fh.flush()
        prev_hook(exc_type, exc, tb)

    sys.excepthook = hook
    _installed = True
