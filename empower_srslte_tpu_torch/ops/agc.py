"""Automatic gain control (lib/src/phy/agc/agc.c parity).

The reference's loop: a per-frame level in ENERGY (RMS) or
PEAK_AMPLITUDE mode (agc.c:151-162), optional multi-frame accumulation
(agc.c:164-181), EMA tracking of the output level and the exponential gain
update ``g *= exp(-0.5 * bw * ln(y/target))`` (agc.c:188-196), the
hardware-gain callback path with dB clamping (agc.c:126-148
set_gain_callback) and the lock switch (srslte_agc_lock).

The level is measured with torch ops on the samples' device and read to
the host once per frame; the gain is a Python float.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

MODE_ENERGY = "energy"
MODE_PEAK = "peak"


@dataclass
class Agc:
    """Stateful software AGC; one ``process`` call per frame."""

    target: float = 1.0
    bandwidth: float = 0.7
    mode: str = MODE_ENERGY
    #: >0: accumulate this many frames before each gain update
    #: (srslte_agc_init_acc nof_frames; agc.c:164)
    nof_frames: int = 0
    #: hardware-gain hook (agc.c:126 set_gain_callback): called with the
    #: desired gain in dB, returns the gain actually applied in dB; when
    #: set, samples are NOT scaled in software (the radio applied it)
    set_gain_callback: object = None
    min_gain_db: float = -50.0
    max_gain_db: float = 50.0

    gain: float = 1.0
    y_out: float = 0.0
    lock: bool = False
    _isfirst: bool = True
    _y_tmp: list = field(default_factory=list)

    # --- accessors (srslte_agc_get_*) -----------------------------------

    def rssi(self) -> float:
        return self.target / self.gain

    def output_level(self) -> float:
        return self.y_out

    def set_lock(self, enable: bool) -> None:
        self.lock = enable

    # --- the loop (srslte_agc_process) ----------------------------------

    def _measure(self, x: torch.Tensor) -> float:
        if self.mode == MODE_PEAK:
            return float(torch.amax(x.real))
        return float(torch.sqrt(torch.mean(x.abs() ** 2)))

    def process(self, samples: torch.Tensor) -> torch.Tensor:
        """Apply the current gain and update it from this frame's level.

        Returns the scaled samples, or the input unchanged when a
        hardware-gain callback owns the scaling."""
        if self.lock:
            return samples
        if self.set_gain_callback is None:
            out = samples * self.gain
        else:
            gain_db = 10.0 * math.log10(max(self.gain, 1e-30))
            if gain_db < self.min_gain_db:
                gain_db = self.min_gain_db + 5.0
            elif gain_db > self.max_gain_db:
                gain_db = self.max_gain_db
            elif not math.isfinite(gain_db):
                gain_db = 0.5 * (self.min_gain_db + self.max_gain_db)
            applied_db = self.set_gain_callback(gain_db)
            self.gain = 10 ** (applied_db / 10.0)
            out = samples

        y = self._measure(out)
        if self.nof_frames > 0:
            self._y_tmp.append(y)
            if len(self._y_tmp) < self.nof_frames:
                return out
            y = (float(np.mean(self._y_tmp)) if self.mode == MODE_ENERGY
                 else float(np.max(self._y_tmp)))
            self._y_tmp.clear()

        if self._isfirst:
            self.y_out = y
            self._isfirst = False
        else:
            self.y_out = ((1 - self.bandwidth) * self.y_out
                          + self.bandwidth * y)
            self.gain *= math.exp(-0.5 * self.bandwidth
                                  * math.log(max(self.y_out, 1e-30)
                                             / self.target))
        return out


# --- the single-shot interface of the earlier AGC ------------------------


@dataclass
class AgcState:
    gain: float = 1.0
    avg_power: float = 0.0


def agc_process(state: AgcState, samples: torch.Tensor, target: float = 1.0,
                bandwidth: float = 0.7) -> tuple[AgcState, torch.Tensor]:
    """Scale one frame and update the gain for the next: an EMA of the
    frame power drives the gain toward ``target``, slew-limited to 4x per
    frame (srslte_agc_process). Returns (new_state, scaled_samples)."""
    p = float(torch.mean(samples.abs() ** 2))
    avg = bandwidth * p + (1 - bandwidth) * state.avg_power \
        if state.avg_power else p
    gain = state.gain * math.sqrt(target / max(avg * state.gain ** 2, 1e-20))
    gain = min(max(gain, state.gain * 0.25), state.gain * 4.0)
    return AgcState(gain=gain, avg_power=avg), samples * state.gain
