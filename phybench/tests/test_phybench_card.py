"""One short cell on the card, through the benchmark's own command."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent.parent


@pytest.mark.card
def test_short_cell_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "-m", "phybench.run", "--workload",
         "dl_tm4_b256", "--seed", str(2**31 + 77), "--seconds", "2",
         "--trace", "0"], capture_output=True, text=True, timeout=1200,
        cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert set(result["metrics"]) == {"mbps", "batch_p95_ms", "setup_s"}
    assert result["device"]["platform"] == "gpu"
    assert result["failed"] == 0 and result["attempted"] > 0
