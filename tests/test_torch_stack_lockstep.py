"""The port's eNB/UE/EPC stack in lockstep with the JAX package's.

Both pairs attach over the same ideal air (Cell(25, id 1), as
``tests/test_stack.py::_run``). The only nondeterminism of either stack
is ``os.urandom`` (the RRC ue-identity and the HSS RAND); with it drawn
from one seeded generator, reseeded before each pair, both stacks are
deterministic functions of the air. So every TTI must give the same
events at both eNBs, UEs and RRCs, and the same downlink and uplink IQ
within 1e-4 of the subframe's peak. The JAX side decodes with its XLA
turbo scans on the CPU, the port with its NII twin: on ideal air their
CRC decisions agree, and so does everything downstream of them.

The same holds for ``tests/test_multi_ue.py::TestTwoUes``' attach: two
UEs (preambles 7 and 23, the second two frames late, the EmPOWER agent
on the eNB) until both have DRB 1. There the eNB's per-user decisions
interleave (two random accesses, two dedicated PUCCH configurations, two
UL grants a TTI) and the uplink is the sum of both UEs' signals. It runs
in this module after the one-UE attach, whose JAX programs it reuses.

And for ``tests/test_mac_procs.py::TestDlHarqOverTheAir``: 14 TTIs after
the attach a pong goes down through one subframe at -12 dB (the air's
noise is drawn from its own seeded generator, so both sides get the same
noise); the UE NACKs, the eNB sends the next rv and the UE combines it
with its softbuffer (the port in bfloat16 with its scaled filler prior)
and delivers the packet: the same events every TTI, and the same IQ.

The port's PUSCH DMRS and SC-FDMA follow TS 36.211 5.5.2.1.1 and 5.6,
where the JAX package's depart from it, so the JAX pairs run with those
stages replaced by the specification's (``tests/jax_ul_spec.py``): the
UL IQ is compared with every other JAX stage as it is. The port's PHICH
follows TS 36.211 6.9, where the JAX package's departs from it, so the
JAX pairs run with its ``phich_put`` and ``phich_decode`` replaced by the
specification's too (``tests/jax_dl_spec.py``): the DL IQ carries the
eNB's HARQ indicators, and the JAX UE reads them.
"""

import os

import numpy as np
import pytest

import empower_srslte_tpu.epc as jepc
import empower_srslte_tpu.epc.mme as jmme
import empower_srslte_tpu.mac.agent as jagent
import empower_srslte_tpu.stack as jstack
import empower_srslte_tpu_torch.epc as tepc
import empower_srslte_tpu_torch.epc.mme as tmme
import empower_srslte_tpu_torch.mac.agent as tagent
import empower_srslte_tpu_torch.stack as tstack
from empower_srslte_tpu.upper import security as jsec
from empower_srslte_tpu.utils.cell import Cell as JCell
from empower_srslte_tpu_torch.tools.stack_drive import StackDrive
from empower_srslte_tpu_torch.tools.stack_scenarios import pong
from empower_srslte_tpu_torch.upper import security as tsec
from empower_srslte_tpu_torch.utils.cell import Cell as TCell

from tests.jax_dl_spec import spec_downlink
from tests.jax_ul_spec import spec_uplink

K = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
OP = bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318")
IMSI = "001010123456789"
MAX_TTI = 80
#: the second UE's IMSI; its key is K with the first byte one higher
IMSI_2 = "001010123456790"
#: the two-UE attach's horizon (``tests/test_multi_ue.py``)
MAX_TTI_TWO = 200
#: the DL HARQ scenario's horizon (``tests/test_mac_procs.py``)
MAX_TTI_HARQ = 140
#: IQ tolerance: a fraction of the subframe's largest sample magnitude
IQ_RTOL_OF_PEAK = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _spec_uplink():
    """The JAX stack's PUSCH DMRS and SC-FDMA pair, and its PHICH, held to
    TS 36.211."""
    with spec_uplink(), spec_downlink():
        yield


def _seed_urandom(monkeypatch, seed: int = 5) -> None:
    g = np.random.default_rng(seed)
    monkeypatch.setattr(os, "urandom",
                        lambda n: g.integers(0, 256, n, np.uint8).tobytes())


def _pair(epc, mme_mod, stack, security, cell, **dev):
    """One eNB/UE pair over the subscriber ``IMSI``'s EPC: (mme, enb,
    ue)."""
    opc = security.milenage_opc(K, OP)
    hss = epc.Hss()
    hss.add_subscriber(epc.Subscriber(name="t", auth_algo="mil", imsi=IMSI,
                                      key=K, opc=opc))
    mme = mme_mod.Mme(hss)
    enb = stack.EnbStack(cell, mme, **dev)
    ue = stack.UeStack(cell, mme_mod.UeNas(imsi=IMSI, key=K, opc=opc),
                       **dev)
    return mme, enb, ue


def _run_pair(epc, mme_mod, stack, security, cell, **dev) -> list:
    """Attach one eNB/UE pair over the ideal air; per TTI the new events
    of (eNB, UE, eNB RRC, UE RRC), the DL IQ and the UL IQ."""
    _mme, enb, ue = _pair(epc, mme_mod, stack, security, cell, **dev)
    trace = _trace(enb, [ue], stack.Air(cell.sf_sample_len), MAX_TTI)
    assert ue.rrc.nas.attached and ue.rrc.drbs == [1], ue.events[-8:]
    return trace


def _run_dl_harq(epc, mme_mod, stack, security, cell, **dev) -> list:
    """``tests/test_mac_procs.py::TestDlHarqOverTheAir`` on one pair: the
    ``_run_pair`` trace, on until the UE has the pong whose first
    transmission went through a -12 dB subframe."""
    mme, enb, ue = _pair(epc, mme_mod, stack, security, cell, **dev)
    air = stack.Air(cell.sf_sample_len)
    st = {"at": None, "sent_at": None}

    def before(tti):
        air.snr_db = -12.0 if tti == st["sent_at"] else None

    def until(tti):
        if st["at"] is None and ue.rrc.nas.attached and ue.rrc.drbs:
            st["at"] = tti
        if st["at"] is not None and tti == st["at"] + 14 \
                and st["sent_at"] is None:
            fwd = mme.spgw.downlink(pong(ue.rrc.nas.ue_ip,
                                         b"HARQ-COMBINED!!!"))
            enb.deliver_gtpu(fwd[1])
            st["sent_at"] = tti + 1
        return st["sent_at"] is not None and bool(ue.rx_ip)

    trace = _trace(enb, [ue], air, MAX_TTI_HARQ, until, before)
    assert len(ue.rx_ip) == 1 and ue.rx_ip[0].endswith(b"HARQ-COMBINED!!!")
    return trace


def _run_two(epc, mme_mod, agent, stack, security, cell, **dev) -> list:
    """Attach two UEs to one eNB over the ideal air, as ``tests/
    test_multi_ue.py::TestTwoUes`` does; per TTI the new events of (eNB,
    UE 1, UE 2, eNB RRC, UE 1 RRC, UE 2 RRC), the DL IQ and the sum of
    both UEs' uplink signals."""
    hss = epc.Hss()
    nas = []
    for i, imsi in enumerate((IMSI, IMSI_2)):
        key = bytes([K[0] + i]) + K[1:]
        opc = security.milenage_opc(key, OP)
        hss.add_subscriber(epc.Subscriber(name=f"u{i}", auth_algo="mil",
                                          imsi=imsi, key=key, opc=opc))
        nas.append(mme_mod.UeNas(imsi=imsi, key=key, opc=opc))
    enb = stack.EnbStack(cell, mme_mod.Mme(hss),
                         agent=agent.EmpowerAgent(), **dev)
    ues = [stack.UeStack(cell, nas[0], preamble=7, ra_delay_frames=0,
                         **dev),
           stack.UeStack(cell, nas[1], preamble=23, ra_delay_frames=2,
                         **dev)]
    trace = _trace(enb, ues, stack.Air(cell.sf_sample_len), MAX_TTI_TWO)
    for ue in ues:
        assert ue.rrc.nas.attached and ue.rrc.drbs == [1], ue.events[-8:]
    assert ues[0].c_rnti != ues[1].c_rnti
    return trace


def _trace(enb, ues, air, max_tti: int, until=None, before=None) -> list:
    """Run ``enb`` and ``ues`` over ``air`` (``StackDrive``, with the
    ``before`` hook) until ``until(tti)`` holds after a TTI, by default
    until every UE is attached with a DRB; per TTI the new events of the
    eNB, each UE, the eNB's RRC and each UE's RRC, the DL IQ and the UEs'
    UL IQ summed."""
    logs = ([enb.events] + [ue.events for ue in ues] + [enb.rrc.events]
            + [ue.rrc.events for ue in ues])
    seen = [0] * len(logs)
    trace = []
    drive = StackDrive([enb], ues, air=air)
    if until is None:
        def until(tti):
            return all(ue.rrc.nas.attached and ue.rrc.drbs for ue in ues)

    def record(tti):
        trace.append((tuple(list(log[n:]) for log, n in zip(logs, seen)),
                      drive.dl[0], drive.ul_sum()))
        seen[:] = [len(log) for log in logs]
        return until(tti)

    drive.run(max_tti, record, before)
    return trace


def _close(port, ref, what: str, tti: int) -> None:
    assert (port is None) == (ref is None), f"{what} at tti {tti}"
    if ref is None:
        return
    assert port.shape == ref.shape and port.dtype == ref.dtype, \
        f"{what} at tti {tti}"
    peak = float(np.max(np.abs(ref)))
    np.testing.assert_allclose(port, ref, rtol=0,
                               atol=IQ_RTOL_OF_PEAK * peak,
                               err_msg=f"{what} at tti {tti}")


def _same_every_tti(port: list, ref: list, names: tuple) -> None:
    """Two traces of ``_trace``: as many TTIs, and in each the same new
    events in every log, and IQ within ``IQ_RTOL_OF_PEAK``."""
    assert len(port) == len(ref)
    for tti, ((ev_p, dl_p, ul_p), (ev_r, dl_r, ul_r)) in enumerate(
            zip(port, ref)):
        for name, a, b in zip(names, ev_p, ev_r):
            assert a == b, f"{name} at tti {tti}"
        _close(dl_p, dl_r, "DL IQ", tti)
        _close(ul_p, ul_r, "UL IQ", tti)


def test_attach_in_lockstep_with_jax(monkeypatch):
    _seed_urandom(monkeypatch)
    ref = _run_pair(jepc, jmme, jstack, jsec, JCell(nof_prb=25, id=1))
    _seed_urandom(monkeypatch)
    port = _run_pair(tepc, tmme, tstack, tsec, TCell(nof_prb=25, id=1),
                     device="cpu")
    _same_every_tti(port, ref, ("eNB events", "UE events", "eNB RRC events",
                                "UE RRC events"))
    # the attach ran the whole procedure on both sides
    events = [e for (ev, _d, _u) in port for e in ev[0]]
    assert any(e.startswith("prach_rapid7_") for e in events)
    assert "contention_resolved" in [e for (ev, _d, _u) in port
                                     for e in ev[1]]


def test_urandom_patch_makes_a_stack_repeatable(monkeypatch):
    """The premise of the lockstep: with ``os.urandom`` seeded, two runs
    of the port's pair are identical (events and IQ bit for bit)."""
    runs = []
    for _ in range(2):
        _seed_urandom(monkeypatch)
        runs.append(_run_pair(tepc, tmme, tstack, tsec,
                              TCell(nof_prb=25, id=1), device="cpu"))
    assert len(runs[0]) == len(runs[1])
    for (ev_a, dl_a, ul_a), (ev_b, dl_b, ul_b) in zip(*runs):
        assert ev_a == ev_b
        np.testing.assert_array_equal(dl_a, dl_b)
        assert (ul_a is None) == (ul_b is None)
        if ul_a is not None:
            np.testing.assert_array_equal(ul_a, ul_b)


def test_two_ue_attach_in_lockstep_with_jax(monkeypatch):
    _seed_urandom(monkeypatch)
    ref = _run_two(jepc, jmme, jagent, jstack, jsec,
                   JCell(nof_prb=25, id=1))
    _seed_urandom(monkeypatch)
    port = _run_two(tepc, tmme, tagent, tstack, tsec,
                    TCell(nof_prb=25, id=1), device="cpu")
    _same_every_tti(port, ref, ("eNB events", "UE 1 events", "UE 2 events",
                                "eNB RRC events", "UE 1 RRC events",
                                "UE 2 RRC events"))
    # both random accesses ran, each on its own preamble
    events = [e for (ev, _d, _u) in port for e in ev[0]]
    assert any(e.startswith("prach_rapid7_") for e in events)
    assert any(e.startswith("prach_rapid23_") for e in events)
    for i in (1, 2):
        assert "contention_resolved" in [e for (ev, _d, _u) in port
                                         for e in ev[i]]


def test_dl_harq_in_lockstep_with_jax(monkeypatch):
    _seed_urandom(monkeypatch)
    ref = _run_dl_harq(jepc, jmme, jstack, jsec, JCell(nof_prb=25, id=1))
    _seed_urandom(monkeypatch)
    port = _run_dl_harq(tepc, tmme, tstack, tsec, TCell(nof_prb=25, id=1),
                        device="cpu")
    _same_every_tti(port, ref, ("eNB events", "UE events", "eNB RRC events",
                                "UE RRC events"))
    # the faded first transmission was NACKed and retransmitted
    enb_events = [e for (ev, _d, _u) in port for e in ev[0]]
    assert any(e.startswith("harq_retx") for e in enb_events)
    assert any(e.startswith("harq_nack") for (ev, _d, _u) in port
               for e in ev[0] + ev[1])
