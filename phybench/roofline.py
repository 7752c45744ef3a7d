"""The least time a piece of work could take on the card, from the work
the algorithm needs and the card's published peaks.

The peaks are NVIDIA's H100 SXM data sheet's at the full 700 W: 3.35 TB/s
of HBM bandwidth, and outside the tensor cores 33.5e12 float32 operations
a second (67 TFLOP/s counts a fused multiply-add as two) and 66.9e12
bfloat16 operations a second in bf16x2 (two lanes an instruction). A card
set below 700 W runs below them; the harness reports its power limit.
"""

from __future__ import annotations

#: bytes a second of HBM
HBM_BYTES_S = 3.35e12
#: non-tensor operations a second by the decoder's metric precision
OPS_S = {"float32": 33.5e12, "bfloat16": 66.9e12}
#: max-log-MAP operations one constituent decoder needs per trellis step:
#: the alpha and the beta recursions, 8 states each, two candidate sums
#: and one max per state (2 x 8 x 3 = 48); the a-posteriori LLR, 16
#: branch sums of alpha + gamma + beta (32), a max over 8 for each bit
#: value (14) and their difference (1); the branch metrics (4); the
#: extrinsic (2)
OPS_PER_STEP = 48 + 32 + 14 + 1 + 4 + 2
#: trellis termination steps per constituent code
TAIL = 3


def turbo_ops(k: int, iterations: int) -> int:
    """Operations of one code block of size ``k`` over ``iterations``
    full iterations: two constituent decodes (half-iterations) each, over
    the K + 3 trellis steps, with nothing counted for window overlap,
    training or recomputation."""
    return iterations * 2 * (k + TAIL) * OPS_PER_STEP


def turbo_bytes(k: int, llr_bytes: int = 4, bit_bytes: int = 1) -> int:
    """Bytes one code block's decode must move: its 3 (K + 4) input LLRs
    read once (float32, the configuration's LLR precision) and its K
    output bits written once (one byte each, as the receiver returns
    them)."""
    return 3 * (k + 4) * llr_bytes + k * bit_bytes


def turbo_least_s(work) -> float:
    """The least time of the turbo calls ``work`` [(K, code blocks,
    iterations, metric dtype name)]: the larger of their operations over
    the non-tensor peak at each call's metric precision and their bytes
    over the HBM bandwidth."""
    ops_s = sum(n * turbo_ops(k, it) / OPS_S[dt] for k, n, it, dt in work)
    moved = sum(n * turbo_bytes(k) for k, n, _it, _dt in work)
    return max(ops_s, moved / HBM_BYTES_S)
