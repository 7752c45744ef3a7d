"""The readers of the receiver's root range, its early-stop reads and the
port's first-use counters, on a small synthetic trace: two calls, each a
root range ``ue_dl.tm4_batch`` holding a stage and a turbo decode with
its early-stop reads."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from empower_srslte_tpu_torch.runtime import trace as port_trace
from phybench.harness import Spec
from phybench.tracing import Trace


def _range(name, start_ms, end_ms):
    return SimpleNamespace(
        name=name, id=0, device_type=DeviceType.CPU,
        is_user_annotation=False, device_time=0.0,
        time_range=SimpleNamespace(start=start_ms * 1e3, end=end_ms * 1e3))


def _call(t0):
    """One call of 10 ms: root [0, 10], FFT [1, 2], turbo decode [3, 8]
    with two early-stop reads of 1 and 0.5 ms."""
    return [_range("ue_dl.tm4_batch", t0, t0 + 10),
            _range("ue_dl.ofdm_rx", t0 + 1, t0 + 2),
            _range("dlsch.turbo_decode", t0 + 3, t0 + 8),
            _range("turbo.stop_read", t0 + 4, t0 + 5),
            _range("turbo.stop_read", t0 + 6, t0 + 6.5)]


@pytest.fixture
def traced():
    return Trace(_call(0) + _call(20), wall_s=0.03, calls=2)


@pytest.fixture
def bare():
    """A parent's trace: the stage ranges alone."""
    events = [e for e in _call(0) if e.name in ("ue_dl.ofdm_rx",
                                                "dlsch.turbo_decode")]
    return Trace(events, wall_s=0.01, calls=1)


def read(name, tr):
    return Spec({}).reader("metrics", name).read(tr, {})


@pytest.mark.parametrize("cell", ["tput", "tti"])
def test_glue_is_the_roots_self_time(traced, bare, cell):
    # 10 ms less the FFT (1) and the turbo decode (5) with its reads
    assert read(f"rx.glue_host_ms.{cell}", traced) == pytest.approx(4.0)
    assert read(f"rx.glue_host_ms.{cell}", bare) is None


@pytest.mark.parametrize("cell", ["tput", "tti"])
def test_read_wait_leaves_the_sch_host_time(traced, bare, cell):
    assert read(f"sch.read_wait_ms.{cell}", traced) == pytest.approx(1.5)
    assert read(f"sch.host_ms.{cell}", traced) == pytest.approx(3.5)
    assert read(f"sch.read_wait_ms.{cell}", bare) is None
    # without the reads' ranges the decode's self time holds them
    assert read(f"sch.host_ms.{cell}", bare) == pytest.approx(5.0)


@pytest.mark.parametrize("cell", ["tput", "tti"])
def test_cold_events_per_call(traced, cell, monkeypatch):
    port_trace.reset()
    assert read(f"rx.cold_events.{cell}", traced) == 0.0
    port_trace.enable()
    try:
        port_trace.count("table_build")
        port_trace.count("alloc_segment", 2)
        port_trace.count("gc_gen2")
    finally:
        port_trace.disable()
    assert read(f"rx.cold_events.{cell}", traced) == pytest.approx(2.0)
    port_trace.reset()
    # a port without the registry: nothing to read, and no error
    monkeypatch.delattr(port_trace, "counts")
    assert read(f"rx.cold_events.{cell}", traced) is None
