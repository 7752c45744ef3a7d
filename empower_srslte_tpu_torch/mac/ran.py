"""RAN slicing registry (EmPOWER fork: srsenb/src/ran/ran.cc parity).

Slice id <-> PLMN association, user <-> slice mapping, and per-slice
resource get/set (ran_interface_common, srsenb/hdr/ran/ran.h:100-150).
The slice-aware schedulers in scheduler_ran.py consume this registry.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: Default slice every user starts in (the reference's special slice 1).
DEFAULT_SLICE_ID = 1


@dataclass
class Slice:
    slice_id: int
    plmn: int = 0
    #: abstract resource share used by the slice scheduler (credits for
    #: 'multi', PRBG share for 'duodynamic')
    resources: int = 0
    users: set = field(default_factory=set)
    locked: bool = False


class RanSlicer:
    """Slice registry + user map (ran_interface_common analog)."""

    def __init__(self):
        self._slices: dict[int, Slice] = {}
        self.add_slice(DEFAULT_SLICE_ID, plmn=0)

    # --- slice management (ran.cc add/rem/get/set) ------------------------

    def add_slice(self, slice_id: int, plmn: int = 0,
                  resources: int = 0) -> Slice:
        if slice_id in self._slices:
            raise ValueError(f"slice {slice_id} exists")
        s = Slice(slice_id=slice_id, plmn=plmn, resources=resources)
        self._slices[slice_id] = s
        return s

    def rem_slice(self, slice_id: int) -> None:
        if slice_id == DEFAULT_SLICE_ID:
            raise ValueError("cannot remove the default slice")
        s = self._slices.pop(slice_id)
        # orphaned users fall back to the default slice
        for rnti in s.users:
            self._slices[DEFAULT_SLICE_ID].users.add(rnti)

    def get_slice(self, slice_id: int) -> Slice:
        return self._slices[slice_id]

    def slices(self) -> list[Slice]:
        return list(self._slices.values())

    def set_slice_resources(self, slice_id: int, resources: int) -> None:
        self._slices[slice_id].resources = resources

    # --- user map (ran.cc add_user/rem_user) ------------------------------

    def add_user(self, rnti: int, slice_id: int = DEFAULT_SLICE_ID) -> None:
        for s in self._slices.values():
            s.users.discard(rnti)
        self._slices[slice_id].users.add(rnti)

    def rem_user(self, rnti: int) -> None:
        for s in self._slices.values():
            s.users.discard(rnti)

    def slice_of(self, rnti: int) -> int:
        for s in self._slices.values():
            if rnti in s.users:
                return s.slice_id
        return DEFAULT_SLICE_ID
