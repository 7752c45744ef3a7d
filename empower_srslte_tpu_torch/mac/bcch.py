"""Broadcast + paging scheduling (srsenb mac/scheduler.cc dl_sched_bc +
rrc.cc is_paging_opportunity parity).

SIB1 transmits on every even SFN at subframe 5 with RV cycling over its
4-transmission period; SI-message n opens a window of si_window_ms every
period_rf radio frames at the 36.331-derived offset and repeats inside it
(scheduler.cc:487-570). Paging frames/occasions follow 36.304 7.1-7.2
with UE_ID = IMSI mod 1024 (rrc.cc:429-470).
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: RV sequence for SI retransmissions (36.321: rv = ceil(3/2 k) mod 4)
RV_IDX = (0, 2, 3, 1)

#: FDD paging subframe patterns (36.304 Table 7.2-1; rrc.cc:431):
#: rows Ns=1,2,4 -> i_s -> subframe (-1 invalid)
_SF_PATTERN = {1: (9, -1, -1, -1), 2: (4, 9, -1, -1), 4: (0, 4, 5, 9)}


@dataclass
class SibConfig:
    payload_len: int                  # encoded SIB bytes (0 = not present)
    period_rf: int = 8                # radio frames (SIB1 fixed at 8)


@dataclass
class BcGrant:
    sib_index: int                    # 0 = SIB1, 1.. = SI messages
    rv: int
    payload_len: int


@dataclass
class SibScheduler:
    """dl_sched_bc analog: call new_tti(tti) every subframe."""

    sibs: list                        # list[SibConfig]
    si_window_ms: int = 20
    _win: dict = field(default_factory=dict)   # i -> (start_tti, n_tx)

    def new_tti(self, tti: int) -> list[BcGrant]:
        sfn, sf_idx = (tti // 10) % 1024, tti % 10
        out: list[BcGrant] = []
        for i, sib in enumerate(self.sibs):
            if not sib.payload_len:
                continue
            if i not in self._win:
                # window opening (scheduler.cc:492-503): SI message i>0
                # starts x = (i-1)*w ms into its period
                x = 0 if i == 0 else (i - 1) * self.si_window_ms
                if sfn % sib.period_rf == x // 10 and sf_idx == x % 10:
                    self._win[i] = (tti, 0)
            elif i > 0 and (tti - self._win[i][0]) % 10240 \
                    > self.si_window_ms:
                del self._win[i]

            if i not in self._win:
                continue
            start, n_tx = self._win[i]
            if n_tx >= 4:
                if i == 0:
                    self._win[i] = (start, 0)   # SIB1 always in window
                continue
            if i == 0:
                due = sfn % 2 == 0 and sf_idx == 5
                nof_tx = 4
            else:
                nof_tx = min(4, max(1, self.si_window_ms // 10))
                n_sf = (tti - start) % 10240
                due = n_sf >= (self.si_window_ms // nof_tx) * n_tx \
                    and sf_idx == 9
            if due:
                out.append(BcGrant(i, RV_IDX[n_tx % 4], sib.payload_len))
                self._win[i] = (start, n_tx + 1)
        return out


def paging_occasion(ue_id: int, t: int, nb_factor: float) -> tuple[int, int]:
    """(paging frame offset within T, paging subframe) per 36.304 7.1.

    ue_id: IMSI mod 1024; t: DRX cycle in radio frames; nb = nb_factor*T.
    """
    nb = int(t * nb_factor)
    n = min(t, nb)
    ns = max(1, nb // t)
    pf = (t // n) * (ue_id % n) % t
    i_s = (ue_id // n) % ns
    po = _SF_PATTERN[ns][i_s]
    if po < 0:
        raise ValueError(f"invalid i_s {i_s} for Ns={ns}")
    return pf, po


@dataclass
class PagingScheduler:
    """rrc.cc pending_paging analog: queue by IMSI-derived ue_id, drain
    at each UE's paging occasion."""

    t: int = 128                      # defaultPagingCycle rf128
    nb_factor: float = 1.0            # nB = T
    pending: dict = field(default_factory=dict)   # ue_id -> payload

    def add(self, imsi: str, payload) -> int:
        ue_id = int(imsi) % 1024
        self.pending[ue_id] = payload
        return ue_id

    def opportunity(self, tti: int) -> list:
        """Payloads due this subframe (and removes them)."""
        sfn, sf_idx = (tti // 10) % 1024, tti % 10
        due = []
        for ue_id in list(self.pending):
            pf, po = paging_occasion(ue_id, self.t, self.nb_factor)
            if sfn % self.t == pf and sf_idx == po:
                due.append(self.pending.pop(ue_id))
        return due
