"""PHICH: hybrid-ARQ indicator channel (36.211 6.9, 36.212 5.3.5).

Capability parity with lib/src/phy/phch/phich.c: the HI (1 = ACK) coded
as three equal bits (36.212 5.3.5), each BPSK-modulated (36.211 7.1.1:
bit b -> (1 - 2b)(1 + j)/sqrt(2)), spread by one of the 8 length-4
orthogonal sequences (normal CP) and scrambled with c_init =
(floor(n_s / 2) + 1)(2 N_ID + 1) 2^9 + N_ID (6.9.1), over the group's 3
REGs of symbol 0. Normal PHICH duration only (the reference's default).
Transmit diversity as 36.211 6.9.2 asks: SFBC on a 2-port cell; on a
4-port one SFBC-FSTD per quadruplet, whose port pairs alternate with
(i + n_group) mod 2 (ports 0, 2 then 1, 3 where it is even, 1, 3 then 0,
2 where it is odd, i the quadruplet's REG in the group).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.equalizer import combine_diversity, precode_diversity
from ..utils.cell import Cell
from ..utils.device import device_table
from ..utils.sequence import cinit_pcfich, gold_sequence
from .regs import nof_phich_groups, phich_regs, symbol_regs

#: Orthogonal sequences, normal CP (36.211 Table 6.9.1-2).
_W = np.array([
    [1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1], [1, -1, -1, 1],
    [1j, 1j, 1j, 1j], [1j, -1j, 1j, -1j], [1j, 1j, -1j, -1j],
    [1j, -1j, -1j, 1j],
], dtype=np.complex64)

NSF = 4
#: the BPSK symbol of HI bit 0 (NACK); bit 1 (ACK) is its negative
_BPSK0 = (1 + 1j) / np.sqrt(2)


def phich_resource(cell: Cell, prb_start: int, n_dmrs: int = 0,
                   ng: float = 1.0) -> tuple[int, int]:
    """(group, sequence) for a PUSCH's PHICH (36.213 9.1.2): derived from
    the lowest allocated PRB and the DMRS cyclic shift, so concurrent UEs
    on distinct PRB slices land on distinct resources."""
    n_group = nof_phich_groups(cell, ng)
    group = (prb_start + n_dmrs) % n_group
    seq = (prb_start // n_group + n_dmrs) % (2 * NSF)
    return group, seq


@functools.lru_cache(maxsize=256)
def _group_re_indices(cell: Cell, ng: float, group: int) -> np.ndarray:
    """The group's 12 REs in symbol 0 (flat index == subcarrier)."""
    regs0 = symbol_regs(cell, 0)
    idx = []
    for r in phich_regs(cell, ng)[group]:
        idx.extend(regs0[r])
    return np.asarray(idx, np.int64)


def _scramble_seq(cell: Cell, sf_idx: int) -> np.ndarray:
    """1 - 2 c(i), i < 12 (36.211 6.9.1: the PCFICH's c_init form)."""
    c = gold_sequence(cinit_pcfich(2 * sf_idx, cell.id), 12)
    return (1.0 - 2.0 * c).astype(np.float32)


def _group_idx(cell: Cell, ng: float, group, device) -> torch.Tensor:
    """The REs of ``group`` (an int, or an int tensor [1] on ``device``)
    from the table of every group's, uploaded once."""
    table = device_table(
        ("phich_re", cell, ng), device,
        lambda: np.stack([_group_re_indices(cell, ng, g)
                          for g in range(nof_phich_groups(cell, ng))]))
    return table[group].reshape(12)


def _fstd_alternate(ports: torch.Tensor, group) -> torch.Tensor:
    """[..., 4, 12] by port: the quadruplets i with (i + group) odd take
    ports 1, 0, 3, 2 in place of 0, 1, 2, 3 (36.211 6.9.2). Its own
    inverse, and the same for a 4-port channel as for the symbols.
    ``group`` an int, or an int tensor [1] on the device of ``ports``."""
    quads = ports.reshape(*ports.shape[:-1], 3, 4)         # [..., 4, 3, 4]
    odd = ((torch.arange(3, device=ports.device) + group) % 2 == 1)[:, None]
    return torch.where(odd, quads[..., [1, 0, 3, 2], :, :],
                       quads).reshape(ports.shape)


def phich_put(grid, ack, cell: Cell, sf_idx: int, group=0, seq_idx=0,
              ng: float = 1.0):
    """Add one HI, ACK (1) or NACK (0), to grid [..., P, nsymb, nre]: the
    one port, SFBC on 2 ports, SFBC-FSTD on 4 with the port pairs of
    36.211 6.9.2. ``ack``, ``group`` and ``seq_idx`` are ints, or int
    tensors [1] on the grid's device, read there and not on the host (so a
    CUDA graph that captured the put serves any HI). Returns a new grid."""
    # every sequence's NACK symbols, uploaded once; an ACK's are their
    # negation
    nack = device_table(("phich_nack", cell, sf_idx), grid.device,
                        lambda: (np.tile(_W, 3) * _scramble_seq(cell, sf_idx)
                                 * _BPSK0).astype(np.complex64)
                        )[seq_idx].reshape(12)
    if isinstance(ack, torch.Tensor):
        syms = torch.where(ack.bool(), -nack, nack)
    else:
        syms = -nack if ack else nack
    port_syms = precode_diversity(syms, cell.nof_ports)
    if cell.nof_ports == 4:
        port_syms = _fstd_alternate(port_syms, group)
    idx = _group_idx(cell, ng, group, grid.device)
    out = grid.clone()
    flat = out.view(*grid.shape[:-2], -1)
    flat[..., :cell.nof_ports, idx] += port_syms.to(grid.dtype)
    return out


def phich_decode(grid, h, cell: Cell, sf_idx: int, group: int = 0,
                 seq_idx: int = 0, ng: float = 1.0, noise_est=0.0):
    """Decode one HI: -> (ack [...] bool, metric [...]), the metric the
    despread symbol's projection on the ACK symbol -(1 + j)/sqrt(2)
    (positive <=> ACK).

    grid [..., nsymb, nre]; ``h``: [..., nsymb, nre] single-port or
    [..., P, nsymb, nre] (SFBC on 2 ports, SFBC-FSTD on 4, as
    ``phich_put`` sends them)."""
    idx = _group_idx(cell, ng, group, grid.device)
    y = grid[..., 0, :][..., idx]
    hh = h[..., 0, :][..., idx]                  # [..., 12] or [..., P, 12]
    if hh.dim() == y.dim() + 1 and hh.shape[-2] == 4:
        hh = _fstd_alternate(hh, group)
    x, _ = combine_diversity(y, hh, noise_est)
    scr = device_table(("phich_scr", cell.id, sf_idx), grid.device,
                       lambda: _scramble_seq(cell, sf_idx))
    w = device_table(("phich_w", seq_idx), grid.device,
                     lambda: np.tile(np.conj(_W[seq_idx]), 3))
    corr = torch.sum(x * scr * w, dim=-1) / 12.0
    metric = -(corr.real + corr.imag) / float(np.sqrt(2))
    return metric > 0, metric
