"""Upper protocol layers: RLC, PDCP, GTP-U, security, USIM.

Capability parity with lib/src/upper (rlc*.cc, pdcp*.cc, gtpu.cc),
lib/src/common/liblte_security.cc and srsue/src/upper/usim.cc: the
user-plane protocol stack above the PHY/MAC. Host-side Python — like the
reference these are per-packet control/data-plane logic, not DSP.
"""

from .rlc import RlcAm, RlcTm, RlcUm
from .pdcp import PdcpEntity
from .gtpu import gtpu_pack, gtpu_unpack

__all__ = ["RlcAm", "RlcTm", "RlcUm", "PdcpEntity", "gtpu_pack",
           "gtpu_unpack"]
