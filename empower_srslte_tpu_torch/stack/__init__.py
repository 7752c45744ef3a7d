"""Full-stack UE / eNB nodes over an IQ 'air' — the srsue/srsenb
binaries' integration layer (random access, MAC mux, RRC, NAS, S1AP)."""

from .air import Air  # noqa: F401
from .enb import EnbStack  # noqa: F401
from .ue import UeStack  # noqa: F401
