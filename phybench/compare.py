"""The numbers that decide ``correct``.

A *gap* compares the port's soft output with the plain reference's: the
largest absolute difference as a share of the reference's largest
magnitude. A *count* compares answers that are exact: how many differ.
``judge`` holds each reading to its limit.
"""

from __future__ import annotations

import numpy as np

#: the gap of an output that went unrecorded, whose shape disagrees or
#: that holds a NaN: a finite number, so that the result stays valid JSON
MISSING = 1e30


def gap(ours, ref) -> float:
    """max |ours - ref| / max |ref|; ``MISSING`` when ``ours`` is None,
    the shapes disagree or the difference is not finite."""
    if ours is None:
        return MISSING
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    if ours.shape != ref.shape:
        return MISSING
    if not ref.size:
        return 0.0
    diff = float(np.abs(ours - ref).max())
    if not np.isfinite(diff):
        return MISSING
    scale = float(np.abs(ref).max())
    return diff / scale if scale > 0 else diff


def tb_diff(crc, bits, ref_crc, ref_bits) -> int:
    """Transport blocks [..., tbs] whose answer differs from the
    reference's: the CRC verdicts differ, or both passed and the bits
    differ. All of them when the shapes disagree."""
    crc, ref_crc = np.asarray(crc, bool), np.asarray(ref_crc, bool)
    bits, ref_bits = np.asarray(bits), np.asarray(ref_bits)
    if crc.shape != ref_crc.shape or bits.shape != ref_bits.shape:
        return max(crc.size, ref_crc.size)
    differ = (crc != ref_crc) | (crc & (bits != ref_bits).any(-1))
    return int(differ.sum())


def judge(readings: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every reading within its limit, {name: {"value", "limit"}}).
    A reading without a limit, or a limit without a reading, fails."""
    names = sorted(set(readings) | set(limits))
    table = {n: {"value": readings.get(n), "limit": limits.get(n)}
             for n in names}
    ok = all(v["value"] is not None and v["limit"] is not None
             and v["value"] <= v["limit"] for v in table.values())
    return ok, table
