"""The MAC procedures over the air, on the port's stack on the CPU.

The over-the-air cases of ``tests/test_mac_procs.py`` with their asserts
as the checks of ``tools/stack_scenarios.py``'s scenarios, on the port's
stacks with ``device="cpu"``: SR -> grant -> BSR, periodic CQI driving
the link adaptation, and the downlink and uplink HARQ retransmissions
that one faded subframe causes.
"""

from empower_srslte_tpu_torch.tools import stack_scenarios as S


def test_sr_triggers_grant_and_bsr():
    bad, info = S.failures(S.sr_bsr, "cpu")
    assert not bad, (bad, info)


def test_cqi_reports_drive_link_adaptation():
    bad, info = S.failures(S.periodic_cqi, "cpu")
    assert not bad, (bad, info)


def test_dl_nack_triggers_rv_retx_and_delivery():
    bad, info = S.failures(S.dl_harq, "cpu")
    assert not bad, (bad, info)


def test_ul_phich_nack_triggers_retx_and_delivery():
    bad, info = S.failures(S.ul_harq, "cpu")
    assert not bad, (bad, info)
