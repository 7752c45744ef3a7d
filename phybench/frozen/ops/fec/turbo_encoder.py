"""LTE turbo encoder: rate-1/3 PCCC of two 8-state RSC codes, 36.212 5.1.3.2.

Capability parity with lib/src/phy/fec/turbocoder.c (srslte_tcod_encode).
Constituent code: G(D) = [1, g1(D)/g0(D)] with g0 = 1 + D^2 + D^3 (feedback)
and g1 = 1 + D + D^3. The trellis tables here are shared with the
max-log-MAP decoder. The encoder serves the eNB transmitter; it steps
through the trellis a byte at a time (8 input bits per table lookup) on
the tensors' device.

Output layout: three streams d0 (systematic), d1 (parity 1), d2 (parity 2),
each of length K + 4 including the 36.212 5.1.3.2.2 tail-bit permutation.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...utils.device import device_table
from .tables import qpp_interleaver

#: Number of trellis states (2^3 registers).
NOF_STATES = 8
#: Tail bits per stream appended by trellis termination.
TAIL = 4


class TurboTrellis:
    """Static transition tables for the LTE RSC constituent code.

    State encoding: s = (r1 << 2) | (r2 << 1) | r3 where r1 is the most
    recent register. Per (state, input) the tables give next state and
    parity output; ``prev_state``/``prev_parity`` are the time-reversed
    view used by the backward (beta) recursion.
    """

    def __init__(self):
        ns = np.zeros((NOF_STATES, 2), dtype=np.int32)
        par = np.zeros((NOF_STATES, 2), dtype=np.int32)
        for s in range(NOF_STATES):
            r1, r2, r3 = (s >> 2) & 1, (s >> 1) & 1, s & 1
            for u in (0, 1):
                a = u ^ r2 ^ r3            # feedback g0 = 1 + D^2 + D^3
                z = a ^ r1 ^ r3            # output   g1 = 1 + D + D^3
                ns[s, u] = (a << 2) | (r1 << 1) | r2
                par[s, u] = z
        self.next_state = ns
        self.parity = par
        # feedback bit that *terminates* (drives a=0): u_tail = r2 ^ r3
        self.tail_input = np.array(
            [((s >> 1) & 1) ^ (s & 1) for s in range(NOF_STATES)], dtype=np.int32
        )
        # reverse tables: prev_state[s', u] = s such that next_state[s,u] = s'
        ps = np.zeros((NOF_STATES, 2), dtype=np.int32)
        pp = np.zeros((NOF_STATES, 2), dtype=np.int32)
        for s in range(NOF_STATES):
            for u in (0, 1):
                sp = ns[s, u]
                ps[sp, u] = s
                pp[sp, u] = par[s, u]
        self.prev_state = ps
        self.prev_parity = pp


@functools.lru_cache(maxsize=1)
def trellis() -> TurboTrellis:
    return TurboTrellis()


@functools.lru_cache(maxsize=1)
def _byte_tables():
    """next_state8[8*256] and packed parity bytes par8[8*256] (MSB = the
    first bit's parity), indexed by state * 256 + input byte."""
    t = trellis()
    ns8 = np.zeros((NOF_STATES, 256), np.int64)
    par8 = np.zeros((NOF_STATES, 256), np.int64)
    for s in range(NOF_STATES):
        for byte in range(256):
            st = s
            out = 0
            for i in range(8):
                u = (byte >> (7 - i)) & 1
                out = (out << 1) | int(t.parity[st, u])
                st = int(t.next_state[st, u])
            ns8[s, byte] = st
            par8[s, byte] = out
    return ns8.reshape(-1), par8.reshape(-1)


def _rsc_encode(u: torch.Tensor):
    """One RSC over u [B, K] int64 0/1 (K % 8 == 0) ->
    (parity [B, K], x_tail [B, 3], z_tail [B, 3]), all int64."""
    dev = u.device
    t = trellis()
    ns8_np, par8_np = _byte_tables()
    ns8 = device_table("tcod_ns8", dev, lambda: ns8_np)
    par8 = device_table("tcod_par8", dev, lambda: par8_np)
    nsu = device_table("tcod_ns", dev, lambda: t.next_state.astype(np.int64))
    paru = device_table("tcod_par", dev, lambda: t.parity.astype(np.int64))
    tin = device_table("tcod_tin", dev, lambda: t.tail_input.astype(np.int64))

    b, k = u.shape
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], device=dev)
    byts = (u.reshape(b, k // 8, 8) * weights).sum(-1)         # [B, K/8]
    state = torch.zeros(b, dtype=torch.int64, device=dev)
    pbytes = torch.empty_like(byts)
    for i in range(k // 8):
        idx = state * 256 + byts[:, i]
        pbytes[:, i] = par8[idx]
        state = ns8[idx]
    shifts = torch.arange(7, -1, -1, device=dev)
    parity = ((pbytes[..., None] >> shifts) & 1).reshape(b, k)

    xt, zt = [], []
    for _ in range(3):
        ui = tin[state]
        xt.append(ui)
        zt.append(paru[state, ui])
        state = nsu[state, ui]
    return parity, torch.stack(xt, -1), torch.stack(zt, -1)


def turbo_encode(u: torch.Tensor) -> torch.Tensor:
    """Encode u [..., K] (0/1) -> d [..., 3, K+4] int8 (36.212 5.1.3.2).

    Stream tail layout per 36.212 5.1.3.2.2:
      d0: x_0..x_{K-1}, x_K,  z_{K+1}, x'_K,  z'_{K+1}
      d1: z_0..z_{K-1}, z_K,  x_{K+2}, z'_K,  x'_{K+2}
      d2: z'_0..z'_{K-1}, x_{K+1}, z_{K+2}, x'_{K+1}, z'_{K+2}
    """
    *lead, k = u.shape
    assert k % 8 == 0, k
    u = u.reshape(-1, k).to(torch.int64)
    b = u.shape[0]
    pi = device_table(("qpp", k), u.device,
                      lambda: qpp_interleaver(k).astype(np.int64))
    # both constituents in one trellis walk: natural and interleaved input
    z, x_t, z_t = _rsc_encode(torch.cat([u, u[:, pi]], dim=0))
    z1, z2 = z[:b], z[b:]
    x1t, x2t = x_t[:b], x_t[b:]
    z1t, z2t = z_t[:b], z_t[b:]

    d0 = torch.cat([u, x1t[:, 0:1], z1t[:, 1:2], x2t[:, 0:1], z2t[:, 1:2]], -1)
    d1 = torch.cat([z1, z1t[:, 0:1], x1t[:, 2:3], z2t[:, 0:1], x2t[:, 2:3]], -1)
    d2 = torch.cat([z2, x1t[:, 1:2], z1t[:, 2:3], x2t[:, 1:2], z2t[:, 2:3]], -1)
    d = torch.stack([d0, d1, d2], dim=-2).to(torch.int8)
    return d.reshape(*lead, 3, k + TAIL)
