"""LTE cell configuration and physical dimensioning.

Capability parity with the reference's cell struct and dimensioning helpers
(lib/include/srslte/phy/common/phy_common.h, lib/src/phy/common/phy_common.c):
``srslte_cell_t``, ``srslte_symbol_sz``, CP lengths, subframe sample counts,
resource-grid geometry. Here the cell is a frozen, hashable dataclass so it
can key per-configuration caches of index tables — the analog of the
reference's plan-per-configuration design (lib/src/phy/dft/dft_fftw.c:76
replan-on-size). A backend-free copy of the JAX package's module.

All numerology is 3GPP TS 36.211 Rel-8 FDD. Everything is computed from
``nof_prb`` with the standard 2048-point/30.72 Msps reference scaling.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

# --- 36.211 constants -------------------------------------------------------

#: Subcarriers per physical resource block (36.211 6.2.3).
RE_PER_PRB = 12

#: OFDM symbols per slot, by CP type (36.211 Table 6.2.3-1).
SYMBOLS_PER_SLOT = {"normal": 7, "extended": 6}

#: Slots per 1 ms subframe, subframes per 10 ms radio frame.
SLOTS_PER_SF = 2
SF_PER_FRAME = 10

#: Max antenna ports on the DL cell-specific reference signals.
MAX_PORTS = 4
#: Max spatial layers (TM3/TM4 2x2 in this build; tables sized for 4).
MAX_LAYERS = 4
#: Max codewords per PDSCH allocation.
MAX_CODEWORDS = 2

#: Standard LTE channel bandwidth -> nof_prb.
BW_TO_PRB = {1.4e6: 6, 3e6: 15, 5e6: 25, 10e6: 50, 15e6: 75, 20e6: 100}

#: Valid downlink system bandwidths (36.101 Table 5.6-1).
VALID_NOF_PRB = (6, 15, 25, 50, 75, 100)


class CP(enum.Enum):
    """Cyclic prefix type (36.211 Table 6.12-1)."""

    NORM = "normal"
    EXT = "extended"

    @property
    def nsymb(self) -> int:
        """OFDM symbols per slot for this CP."""
        return SYMBOLS_PER_SLOT[self.value]


def symbol_sz(nof_prb: int, reduced: bool = False) -> int:
    """FFT size for a given downlink bandwidth.

    Mirrors ``srslte_symbol_sz`` (lib/src/phy/common/phy_common.c):
    ``reduced=False`` gives the LTE standard sampling rates (the
    reference's use_standard_rates=true, srslte_symbol_sz_power2);
    ``reduced=True`` gives the reference's reduced non-power-of-two
    rates (use_standard_rates=false — what its recorded captures use).
    """
    table = ({6: 128, 15: 256, 25: 384, 50: 768, 75: 1024, 100: 1536}
             if reduced else
             {6: 128, 15: 256, 25: 512, 50: 1024, 75: 1536, 100: 2048})
    try:
        return table[nof_prb]
    except KeyError:
        raise ValueError(f"unsupported nof_prb={nof_prb}; valid: {VALID_NOF_PRB}")


def sample_rate(nof_prb: int, reduced: bool = False) -> float:
    """Sampling rate in Hz: 15 kHz subcarrier spacing times the FFT size."""
    return 15_000.0 * symbol_sz(nof_prb, reduced)


def cp_lengths(nof_prb: int, cp: CP, reduced: bool = False) -> tuple[int, ...]:
    """Per-symbol CP lengths (samples) for one slot.

    Normal CP: 160 samples on symbol 0 and 144 on symbols 1..6 at the
    2048-point numerology, scaled by fft/2048; extended CP: 512 scaled
    (36.211 Table 6.12-1).
    """
    fft = symbol_sz(nof_prb, reduced)
    if cp is CP.NORM:
        return (160 * fft // 2048,) + (144 * fft // 2048,) * 6
    return (512 * fft // 2048,) * 6


def slot_sample_len(nof_prb: int, cp: CP, reduced: bool = False) -> int:
    """Samples per 0.5 ms slot = sum of (CP + FFT) over the slot's symbols."""
    fft = symbol_sz(nof_prb, reduced)
    return sum(cp_lengths(nof_prb, cp, reduced)) + cp.nsymb * fft


def sf_sample_len(nof_prb: int, cp: CP = CP.NORM,
                  reduced: bool = False) -> int:
    """Samples per 1 ms subframe."""
    return 2 * slot_sample_len(nof_prb, cp, reduced)


def SF_RE_LEN(nof_prb: int, cp: CP = CP.NORM) -> int:
    """Resource elements in one subframe grid (all symbols x subcarriers)."""
    return 2 * cp.nsymb * nof_prb * RE_PER_PRB


@dataclass(frozen=True)
class Cell:
    """Static LTE cell configuration.

    The equivalent of ``srslte_cell_t``
    (lib/include/srslte/phy/common/phy_common.h). Frozen + hashable so a
    ``Cell`` can key cached index tables; every derived dimension below
    is a plain Python int.
    """

    nof_prb: int = 50
    nof_ports: int = 1
    id: int = 0
    cp: CP = CP.NORM
    #: use the reference's reduced non-power-of-two sampling rates
    #: (srslte_use_standard_symbol_size(false) — its IQ captures' rates)
    reduced_rates: bool = False

    def __post_init__(self):
        if self.nof_prb not in VALID_NOF_PRB:
            raise ValueError(f"nof_prb={self.nof_prb} not in {VALID_NOF_PRB}")
        if self.nof_ports not in (1, 2, 4):
            raise ValueError(f"nof_ports={self.nof_ports} must be 1, 2 or 4")
        if not 0 <= self.id < 504:
            raise ValueError(f"cell id={self.id} out of range [0, 504)")

    # --- derived geometry ---------------------------------------------------

    @property
    def fft_size(self) -> int:
        return symbol_sz(self.nof_prb, self.reduced_rates)

    @property
    def srate(self) -> float:
        return sample_rate(self.nof_prb, self.reduced_rates)

    @property
    def nof_re(self) -> int:
        """Occupied subcarriers."""
        return self.nof_prb * RE_PER_PRB

    @property
    def nsymb_slot(self) -> int:
        return self.cp.nsymb

    @property
    def nsymb_sf(self) -> int:
        return 2 * self.cp.nsymb

    @property
    def sf_re_len(self) -> int:
        return self.nsymb_sf * self.nof_re

    @property
    def sf_sample_len(self) -> int:
        return sf_sample_len(self.nof_prb, self.cp, self.reduced_rates)

    @property
    def cp_len_slot(self) -> tuple[int, ...]:
        return cp_lengths(self.nof_prb, self.cp, self.reduced_rates)

    @property
    def n_id_1(self) -> int:
        """Physical layer cell identity group (SSS)."""
        return self.id // 3

    @property
    def n_id_2(self) -> int:
        """Identity within the group (PSS root index)."""
        return self.id % 3


# Handy canonical cells used throughout the tests and benchmarks, matching
# the reference's test sweep (lib/src/phy/phch/test/CMakeLists.txt).
CELL_1_4MHZ = Cell(nof_prb=6, nof_ports=1, id=1)
CELL_10MHZ = Cell(nof_prb=50, nof_ports=1, id=1)
CELL_20MHZ_MIMO = Cell(nof_prb=100, nof_ports=2, id=1)
