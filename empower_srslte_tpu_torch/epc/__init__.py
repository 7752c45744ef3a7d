"""EPC components (srsepc/ parity, host-side).

The reference's srsEPC bundles MME, HSS, SP-GW and MBMS-GW in one binary
(srsepc/src/main.cc). Provided here: the MME NAS EMM/ESM state machines
on the real 24.301 wire format (epc/mme.py + epc/nas.py, oracle-checked
against lib/src/asn1/liblte_mme.cc), HSS with a CSV subscriber database
and Milenage/XOR EPS authentication vectors (srsepc/src/hss/hss.cc:808),
an SP-GW with TEID allocation and GTP-U tunnel forwarding
(srsepc/src/spgw/spgw.cc), S11 GTPv2-C between them (epc/gtpc.py), and
the MBMS gateway (epc/mbms_gw.py).
"""

from .hss import Hss, Subscriber
from .mbms_gw import M1uReceiver, MbmsGw, m1_ingest
from .mme import Mme, UeNas
from .nas import Guti
from .spgw import SpGw

__all__ = ["Hss", "Subscriber", "SpGw", "Mme", "UeNas", "Guti",
           "MbmsGw", "M1uReceiver", "m1_ingest"]
