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
"""

import os

import numpy as np

import empower_srslte_tpu.epc as jepc
import empower_srslte_tpu.epc.mme as jmme
import empower_srslte_tpu.stack as jstack
import empower_srslte_tpu_torch.epc as tepc
import empower_srslte_tpu_torch.epc.mme as tmme
import empower_srslte_tpu_torch.stack as tstack
from empower_srslte_tpu.upper import security as jsec
from empower_srslte_tpu.utils.cell import Cell as JCell
from empower_srslte_tpu_torch.upper import security as tsec
from empower_srslte_tpu_torch.utils.cell import Cell as TCell

K = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
OP = bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318")
IMSI = "001010123456789"
MAX_TTI = 80
#: IQ tolerance: a fraction of the subframe's largest sample magnitude
IQ_RTOL_OF_PEAK = 1e-4


def _seed_urandom(monkeypatch, seed: int = 5) -> None:
    g = np.random.default_rng(seed)
    monkeypatch.setattr(os, "urandom",
                        lambda n: g.integers(0, 256, n, np.uint8).tobytes())


def _run_pair(epc, mme_mod, stack, security, cell, **dev) -> list:
    """Attach one eNB/UE pair over the ideal air; per TTI the new events
    of (eNB, UE, eNB RRC, UE RRC), the DL IQ and the UL IQ."""
    opc = security.milenage_opc(K, OP)
    hss = epc.Hss()
    hss.add_subscriber(epc.Subscriber(name="t", auth_algo="mil", imsi=IMSI,
                                      key=K, opc=opc))
    mme = mme_mod.Mme(hss)
    enb = stack.EnbStack(cell, mme, **dev)
    ue = stack.UeStack(cell, mme_mod.UeNas(imsi=IMSI, key=K, opc=opc),
                       **dev)
    air = stack.Air(cell.sf_sample_len)
    logs = (enb.events, ue.events, enb.rrc.events, ue.rrc.events)
    seen = [0] * len(logs)
    trace, ul_iq = [], None
    for tti in range(MAX_TTI):
        dl_iq = enb.tti(tti, air.ul(ul_iq) if ul_iq is not None else None)
        ul_iq = ue.tti(tti, air.dl(dl_iq))
        new = tuple(list(log[n:]) for log, n in zip(logs, seen))
        seen = [len(log) for log in logs]
        trace.append((new, dl_iq, ul_iq))
        if ue.rrc.nas.attached and ue.rrc.drbs:
            break
    assert ue.rrc.nas.attached and ue.rrc.drbs == [1], ue.events[-8:]
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


def test_attach_in_lockstep_with_jax(monkeypatch):
    _seed_urandom(monkeypatch)
    ref = _run_pair(jepc, jmme, jstack, jsec, JCell(nof_prb=25, id=1))
    _seed_urandom(monkeypatch)
    port = _run_pair(tepc, tmme, tstack, tsec, TCell(nof_prb=25, id=1),
                     device="cpu")
    assert len(port) == len(ref)
    names = ("eNB events", "UE events", "eNB RRC events", "UE RRC events")
    for tti, ((ev_p, dl_p, ul_p), (ev_r, dl_r, ul_r)) in enumerate(
            zip(port, ref)):
        for name, a, b in zip(names, ev_p, ev_r):
            assert a == b, f"{name} at tti {tti}"
        _close(dl_p, dl_r, "DL IQ", tti)
        _close(ul_p, ul_r, "UL IQ", tti)
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
