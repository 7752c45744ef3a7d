"""Mobility on the port's stack on the CPU: S1 handover between two eNBs,
and idle reselection with its cell-selection rules.

``tests/test_handover_ota.py`` and ``tests/test_idle_reselect.py``'s
over-the-air tests with their asserts as the checks of
``tools/stack_scenarios.py``'s scenarios, on the port's stacks with
``device="cpu"``. Two eNBs share one IQ channel: a UE hears the
gain-weighted sum of their downlinks and both hear its uplink. An A3
report drives an S1 handover from PCI 1 to PCI 2, where the target admits
the UE with a dedicated preamble; an idle UE reselects to the stronger
cell, re-reads its system information and comes back through it with a
Service Request; a cell below Qrxlevmin and a cell of a foreign PLMN are
never camped on.
"""

from empower_srslte_tpu_torch.tools import stack_scenarios as S


def test_a3_report_drives_s1_handover():
    bad, info = S.failures(S.handover, "cpu")
    assert not bad, (bad, info)


def test_reselect_and_reattach_via_target():
    bad, info = S.failures(S.reselect, "cpu")
    assert not bad, (bad, info)


def test_s_criterion_rejects_weak_cell():
    bad, info = S.failures(S.s_criterion, "cpu")
    assert not bad, (bad, info)


def test_plmn_mismatch_rejects_cell():
    bad, info = S.failures(S.plmn_mismatch, "cpu")
    assert not bad, (bad, info)
