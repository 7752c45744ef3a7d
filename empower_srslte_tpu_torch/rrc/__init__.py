"""RRC ASN.1 codecs (36.331 Rel-8/9) — liblte_rrc.cc parity subset."""

from . import messages, per, schema  # noqa: F401
