"""CSI feedback over the air, on the port's stack on the CPU.

``tests/test_csi_feedback.py``'s over-the-air cases with their asserts as
the checks of ``tools/stack_scenarios.py``'s scenarios, on the port's
stacks with ``device="cpu"``: a two-tap channel notches part of the
band, the UE's aperiodic higher-layer subband CQI on PUSCH shows the dip,
and the eNB steers its allocations into the clean window; the periodic
RI on PUCCH is stored per UE.
"""

from empower_srslte_tpu_torch.tools import stack_scenarios as S


def test_subband_report_steers_allocation():
    bad, info = S.failures(S.subband_cqi, "cpu")
    assert not bad, (bad, info)


def test_periodic_ri_reported():
    bad, info = S.failures(S.periodic_ri, "cpu")
    assert not bad, (bad, info)
