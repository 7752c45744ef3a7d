"""Idle mode on the port's stack on the CPU: paging and service request,
periodic TAU, TAU on a tracking-area change.

``tests/test_idle_paging.py`` and ``tests/test_tau_ota.py`` with their
asserts as the checks of ``tools/stack_scenarios.py``'s scenarios, on the
port's stacks with ``device="cpu"``: the network releases the UE to
ECM-idle, pages it at its 36.304 occasion on the P-RNTI and the UE comes
back with a NAS Service Request on the same session; T3412 expires in
idle, the UE wakes for a TAU that reallocates its GUTI, and the bearer
still carries data after a page with the new M-TMSI; camping on a TAC
outside the registered TAI list arms a TAU, and the accept's TAI list
stops the loop.
"""

from empower_srslte_tpu_torch.tools import stack_scenarios as S


def test_release_page_service_request():
    bad, info = S.failures(S.paging, "cpu")
    assert not bad, (bad, info)


def test_t3412_tau_guti_survives_bearer():
    bad, info = S.failures(S.periodic_tau, "cpu")
    assert not bad, (bad, info)


def test_camp_outside_tai_list_arms_tau():
    bad, info = S.failures(S.tac_change_arms_tau, "cpu")
    assert not bad, (bad, info)


def test_tau_accept_updates_tai_list():
    bad, info = S.failures(S.tau_accept_lists_every_tac, "cpu")
    assert not bad, (bad, info)
