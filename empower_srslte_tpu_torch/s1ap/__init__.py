"""S1AP (36.413) codecs + eNB/MME endpoints — liblte_s1ap.cc +
srsenb/src/upper/s1ap.cc + srsepc/src/mme/s1ap*.cc parity subset."""

from . import messages, per  # noqa: F401
