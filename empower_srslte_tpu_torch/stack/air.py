"""In-memory subframe-synchronous radio link (the file/UDP-IQ test mode
of the reference: ue_sync.c:675-707 file mode, io/netsource.c streaming —
here a lossless duplex channel with optional gain/phase/AWGN)."""

from __future__ import annotations

import numpy as np


class Air:
    def __init__(self, sf_len: int, snr_db: float | None = None,
                 h_dl: complex = 1.0, h_ul: complex = 1.0, seed: int = 0,
                 delay_samples: int = 0):
        self.sf_len = sf_len
        self.snr_db = snr_db
        self.h_dl = h_dl
        self.h_ul = h_ul
        self.rng = np.random.default_rng(seed)
        #: one-way propagation delay on the uplink (streaming delay
        #: line): what the eNB's PRACH offset detection measures and
        #: the RAR timing-advance command compensates
        self.delay = int(delay_samples)
        self._ul_tail = np.zeros(self.delay, np.complex64)

    #: per-direction SNR overrides (None = use self.snr_db); lets tests
    #: model asymmetric links (e.g. a deep uplink fade with a clean DL)
    snr_db_dl: float | None = None
    snr_db_ul: float | None = None

    def _impair(self, iq, h, snr_db=None):
        if iq is None:
            iq = np.zeros(self.sf_len, np.complex64)
        iq = np.asarray(iq).astype(np.complex64)
        if iq.ndim == 2:
            # multi-port TX: combine with per-port channel coefficients
            hs = h if isinstance(h, (tuple, list)) else (h,) * iq.shape[0]
            assert len(hs) >= iq.shape[0], "need one h per TX port"
            out = sum(hs[p] * iq[p] for p in range(iq.shape[0]))
            out = out.astype(np.complex64)
        else:
            out = iq * (h[0] if isinstance(h, (tuple, list)) else h)
        snr = snr_db if snr_db is not None else self.snr_db
        if snr is not None:
            p = np.mean(np.abs(out) ** 2)
            if p > 0:
                n0 = p / 10 ** (snr / 10)
                out = out + (self.rng.normal(size=out.shape)
                             + 1j * self.rng.normal(size=out.shape)
                             ).astype(np.complex64) * np.sqrt(n0 / 2)
        return out

    def dl(self, iq):
        return self._impair(iq, self.h_dl, self.snr_db_dl)

    def ul(self, iq, advance: int = 0):
        """``advance``: the UE's timed-TX advance (radio.cc tx_adv /
        the RAR timing-advance command) — it cancels the propagation
        delay at the receiver."""
        out = self._impair(iq, self.h_ul, self.snr_db_ul)
        d = max(0, self.delay - int(advance))
        if d != len(self._ul_tail):
            self._ul_tail = np.zeros(d, np.complex64)
        if d:
            spill = out[-d:].copy()
            out = np.concatenate([self._ul_tail, out[:-d]])
            self._ul_tail = spill
        return out
