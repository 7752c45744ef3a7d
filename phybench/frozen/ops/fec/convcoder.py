"""K=7 tail-biting convolutional code, rate 1/3 (36.212 5.1.3.1).

Capability parity with lib/src/phy/fec/convcoder.c and viterbi.c (the soft
Viterbi decoders behind PBCH and PDCCH, pbch.c:156,425 / pdcch.c:79,341).

The decoder is a batched max-log Viterbi with register-exchange survivors,
tail-biting by the circular-halo trick (decode the circularly extended
sequence, keep the middle copy). ``viterbi_decode`` is the entry point:
in this frozen copy it runs ``viterbi_decode_plain`` on every device
(the port's card path launches a kernel there), the port of the JAX package's three-segment
scan (empower_srslte_tpu/ops/fec/convcoder.py:99-232), which is the
kernel's plain twin: the two take bit-identical decisions.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils.device import device_table

#: Generator polynomials G0=133, G1=171, G2=165 (octal), MSB = newest bit.
POLYS = (0o133, 0o171, 0o165)
NOF_STATES = 64
RATE = 3
@functools.lru_cache(maxsize=1)
def _tables():
    """Transition tables over state s = (u_{k-1}..u_{k-6}).

    next_state[s, u], out_bits[s, u, 3]; and the reverse view
    prev_state[s', b] (b = the shifted-out oldest bit hypothesis) with
    prev_u[s'] = newest input bit implied by s'.
    """
    ns = np.zeros((NOF_STATES, 2), np.int32)
    out = np.zeros((NOF_STATES, 2, RATE), np.int8)
    for s in range(NOF_STATES):
        for u in (0, 1):
            reg = (u << 6) | s
            ns[s, u] = (u << 5) | (s >> 1)
            for j, g in enumerate(POLYS):
                out[s, u, j] = bin(reg & g).count("1") % 2
    ps = np.zeros((NOF_STATES, 2), np.int32)
    pu = np.zeros(NOF_STATES, np.int32)
    pout = np.zeros((NOF_STATES, 2, RATE), np.int8)
    for sp in range(NOF_STATES):
        u = sp >> 5
        pu[sp] = u
        for b in (0, 1):
            s = ((sp & 31) << 1) | b
            ps[sp, b] = s
            pout[sp, b] = out[s, u]
    return ns, out, ps, pu, pout


def conv_encode(u: torch.Tensor) -> torch.Tensor:
    """Tail-biting encode u[..., K] 0/1 -> d[..., 3, K] int8 (initial
    state = last 6 input bits, 36.212 5.1.3.1)."""
    ns, out, *_ = _tables()
    dev = u.device
    ns_t = device_table("cc_ns", dev, lambda: ns.astype(np.int64))
    out_t = device_table("cc_out", dev, lambda: out)
    k = u.shape[-1]
    u = u.to(torch.int64)
    state = torch.zeros(u.shape[:-1], dtype=torch.int64, device=dev)
    for j in range(6):
        state = state | (u[..., k - 1 - j] << (5 - j))
    outs = []
    for i in range(k):
        ui = u[..., i]
        outs.append(out_t[state, ui])
        state = ns_t[state, ui]
    return torch.stack(outs, dim=-1)                    # [..., 3, K]


