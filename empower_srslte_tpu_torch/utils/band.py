"""EUTRA band / EARFCN frequency tables (36.101 Table 5.7.3-1).

Capability parity with lib/src/phy/common/phy_common.c:393-525
(srslte_band_get_band / srslte_band_fd / srslte_band_fu) and the
EARFCN-driven tuning in lib/src/radio/radio.cc — values are the 3GPP
spec constants, re-entered from 36.101.
"""

from __future__ import annotations

#: (band, fd_low_MHz, dl_earfcn_offset, ul_earfcn_offset, duplex_MHz)
_BANDS = [
    (1, 2110.0, 0, 18000, 190.0),
    (2, 1930.0, 600, 18600, 80.0),
    (3, 1805.0, 1200, 19200, 95.0),
    (4, 2110.0, 1950, 19950, 400.0),
    (5, 869.0, 2400, 20400, 45.0),
    (6, 875.0, 2650, 20650, 45.0),
    (7, 2620.0, 2750, 20750, 120.0),
    (8, 925.0, 3450, 21450, 45.0),
    (9, 1844.9, 3800, 21800, 95.0),
    (10, 2110.0, 4150, 22150, 400.0),
    (11, 1475.9, 4750, 22750, 48.0),
    (12, 729.0, 5010, 23010, 30.0),
    (13, 746.0, 5180, 23180, -31.0),
    (14, 758.0, 5280, 23280, -30.0),
    (17, 734.0, 5730, 23730, 30.0),
    (18, 860.0, 5850, 23850, 45.0),
    (19, 875.0, 6000, 24000, 45.0),
    (20, 791.0, 6150, 24150, -41.0),
    (21, 1495.9, 6450, 24450, 48.0),
    (22, 3500.0, 6600, 24600, 100.0),
    (23, 2180.0, 7500, 25500, 180.0),
    (24, 1525.0, 7700, 25700, -101.5),
    (25, 1930.0, 8040, 26040, 80.0),
    (26, 859.0, 8690, 26690, 45.0),
    (27, 852.0, 9040, 27040, 45.0),
    (28, 758.0, 9210, 27210, 55.0),
    (29, 717.0, 9660, 0, 0.0),       # SDL, no uplink
    (30, 2350.0, 9770, 27660, 45.0),
    (31, 462.5, 9870, 27760, 10.0),
    (32, 1452.0, 9920, 0, 0.0),      # SDL
    (64, 0.0, 10359, 27809, 0.0),    # gap bound
    (65, 2110.0, 65536, 131072, 90.0),
    (66, 2110.0, 66436, 131972, 90.0),
    (67, 738.0, 67336, 0, 0.0),      # SDL
    (68, 753.0, 67536, 132672, 30.0),
    (69, 2570.0, 67836, 0, 50.0),    # SDL
    (70, 1995.0, 68336, 132972, 25.0),
    (71, 0.0, 68586, 133122, 0.0),   # bound
]


def _band_entry(dl_earfcn: int):
    prev = _BANDS[0]
    for entry in _BANDS[1:]:
        if dl_earfcn < entry[2]:
            return prev
        prev = entry
    return prev


def band_from_dl_earfcn(dl_earfcn: int) -> int:
    """Band number for a DL EARFCN (srslte_band_get_band)."""
    return _band_entry(dl_earfcn)[0]


def dl_freq_hz(dl_earfcn: int) -> float:
    """DL carrier frequency in Hz (srslte_band_fd: F = F_low +
    0.1 * (N - N_offs), 36.101 5.7.3)."""
    band, fd_low, dl_off, _, _ = _band_entry(dl_earfcn)
    if fd_low == 0.0:
        raise ValueError(f"EARFCN {dl_earfcn} not in an FDD DL band")
    return (fd_low + 0.1 * (dl_earfcn - dl_off)) * 1e6


def ul_freq_hz(ul_earfcn: int) -> float:
    """UL carrier frequency in Hz (srslte_band_fu)."""
    prev = _BANDS[0]
    for entry in _BANDS[1:]:
        if entry[3] and ul_earfcn < entry[3]:
            break
        if entry[3]:
            prev = entry
    band, fd_low, _, ul_off, duplex = prev
    if fd_low == 0.0 or duplex == 0.0:
        raise ValueError(f"EARFCN {ul_earfcn} not in an FDD UL band")
    return (fd_low - duplex + 0.1 * (ul_earfcn - ul_off)) * 1e6


def ul_earfcn_from_dl(dl_earfcn: int) -> int:
    """Default UL EARFCN paired with a DL EARFCN (36.101 5.7.3:
    N_ul = N_dl - N_offs_dl + N_offs_ul)."""
    band, _, dl_off, ul_off, duplex = _band_entry(dl_earfcn)
    if ul_off == 0:
        raise ValueError(f"band {band} is downlink-only")
    return dl_earfcn - dl_off + ul_off
