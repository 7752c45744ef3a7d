"""Two UEs on one cell, on the port's stack on the CPU.

``tests/test_multi_ue.py`` with its asserts as the checks of
``tools/stack_scenarios.py``'s scenarios, on the port's stacks with
``device="cpu"``: staggered random access (preambles 7 and 23),
RRC-assigned dedicated PUCCH resources, per-UE UL PRB allocations and
both user planes over one air whose uplink is the sum of both UEs'
transmissions; then both UEs' downlink data, which the scheduler packs
into one subframe.
"""

from empower_srslte_tpu_torch.tools import stack_scenarios as S


def test_both_attach_and_ping():
    bad, info = S.failures(S.two_ues_ping, "cpu")
    assert not bad, (bad, info)


def test_same_subframe_dl_to_both():
    bad, info = S.failures(S.two_ues_dl, "cpu")
    assert not bad, (bad, info)
