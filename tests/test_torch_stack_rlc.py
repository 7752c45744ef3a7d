"""SRB1 over RLC AM when HARQ gives up, and radio-link failure, on the
port's stack on the CPU.

``tests/test_stack.py::TestSrb1RlcAm`` and ``::TestRadioLinkFailure``
with their asserts as the checks of ``tools/stack_scenarios.py``'s
scenarios, on the port's stacks with ``device="cpu"``: an RRC message
lost in a fade that DL HARQ cannot bridge is recovered by the AM layer's
poll/status retransmission; a dead uplink exhausts SRB1's AM
retransmissions, the UE declares RLF and re-establishes its connection
over random access.
"""

from empower_srslte_tpu_torch.tools import stack_scenarios as S


def test_signalling_survives_harq_exhaustion():
    bad, info = S.failures(S.srb1_rlc_am, "cpu")
    assert not bad, (bad, info)


def test_rlc_max_retx_triggers_reestablishment():
    bad, info = S.failures(S.rlf, "cpu")
    assert not bad, (bad, info)
