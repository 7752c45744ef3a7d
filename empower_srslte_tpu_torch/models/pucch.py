"""PUCCH formats 1/1a/1b and 2/2a/2b: uplink control channel (36.211 5.4).

Capability parity with lib/src/phy/phch/pucch.c: cyclic-shifted base
sequences with the cell-specific shift-hopping pattern, orthogonal covers
for format 1, DMRS-embedded slots, band-edge PRB mapping with slot
hopping, format 2 carrying an RM(20,O)-coded payload; coherent detection
at the eNB. Normal CP; delta_pucch_shift = 1 (the srsLTE default).

Counterpart of the JAX package's models/pucch.py:43-244. The encoders
build one subframe's grid on the host (numpy, as the UE composes one
subframe) and move it to the device. The decoders take a grid
[..., nsymb, nre] with any leading batch dims and stay on its device: one
gather of the 12 REs of every symbol of both slots with a static index
table, one product with the conjugate cyclic-shifted sequences (built on
the host once per config, ``device_table``), then the channel reference,
the data symbols, the energy and the format-2 LLRs as tensors. They make
no host read and return tensors, where the JAX decoders return Python
numbers.

Two reference quirks are kept because both ends of a link use them:
format 1 keeps the same resource in slot 1 (no remapping), and
``_alpha_seq`` takes the base sequence of group ``cell.id % 30`` with no
group hopping.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..runtime import trace
from ..utils.cell import Cell
from ..utils.device import device_table, resolve_device
from ..utils.sequence import gold_sequence
from .refsignal_ul import base_sequence
from .uci import rm_decode, rm_encode

#: Format 1 data symbols / DMRS symbols per slot (normal CP).
F1_DATA_SYMS = (0, 1, 5, 6)
F1_DMRS_SYMS = (2, 3, 4)
#: Format 2 data symbols / DMRS symbols per slot (normal CP).
F2_DATA_SYMS = (0, 2, 3, 5, 6)
F2_DMRS_SYMS = (1, 4)

#: Orthogonal covers for format 1 (36.211 Table 5.4.1-2) and its DMRS.
W_F1 = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1]], np.float32)
W_F1_DMRS = np.array([
    [1, 1, 1],
    [1, np.exp(2j * np.pi / 3), np.exp(4j * np.pi / 3)],
    [1, np.exp(4j * np.pi / 3), np.exp(2j * np.pi / 3)],
], np.complex64)

F2_FORMATS = ("2", "2a", "2b")


@functools.lru_cache(maxsize=512)
def n_cs_cell(cell: Cell) -> np.ndarray:
    """Cell-specific cyclic-shift pattern n_cs(ns, l) (36.211 5.4)."""
    nsym = cell.nsymb_slot
    c = gold_sequence(cell.id, 8 * nsym * 20).astype(np.int64)
    weights = (1 << np.arange(8)).astype(np.int64)
    return (c.reshape(20, nsym, 8) @ weights).astype(np.int32)


@dataclass(frozen=True)
class PucchConfig:
    cell: Cell
    sf_idx: int
    n_pucch: int = 0
    format: str = "1a"        # "1", "1a", "1b", "2", "2a", "2b"
    delta_shift: int = 1
    n_rb_2: int = 0           # PRBs reserved for format 2

    def prb(self, slot: int) -> int:
        """Band-edge PRB with slot hopping (36.211 5.4.3)."""
        if self.format in F2_FORMATS:
            m = self.n_pucch // 12
        else:
            c = 3  # normal CP
            m = self.n_rb_2 + self.n_pucch // (c * 12 // self.delta_shift)
        if (m + slot) % 2 == 0:
            return m // 2
        return self.cell.nof_prb - 1 - m // 2


def _f1_resources(cfg: PucchConfig, slot: int):
    """(cyclic shift index alpha0, orthogonal cover index) for format 1
    (36.211 5.4.1 resource mapping, delta_shift=1, no mixed PRB). Slot 1
    keeps slot 0's resource (no remapping), as the JAX package does."""
    c = 3
    n_prime = cfg.n_pucch % (c * 12 // cfg.delta_shift)
    oc = n_prime // 12
    shift = (n_prime * cfg.delta_shift) % 12
    return shift, oc


def _alpha_seq(cfg: PucchConfig, slot: int, l: int,
               extra_shift: int) -> np.ndarray:
    """r_alpha(n): base sequence with the per-symbol cyclic shift."""
    cell = cfg.cell
    ncs = n_cs_cell(cell)[2 * cfg.sf_idx + slot, l]
    u = cell.id % 30
    alpha_idx = (int(ncs) % 12 + extra_shift) % 12
    r = base_sequence(u, 0, 12)
    n = np.arange(12)
    return (np.exp(2j * np.pi * alpha_idx * n / 12) * r).astype(np.complex64)


def _shift(cfg: PucchConfig, slot: int) -> int:
    """The cyclic shift index the config adds in ``slot``."""
    if cfg.format in F2_FORMATS:
        return cfg.n_pucch % 12
    return _f1_resources(cfg, slot)[0]


def _f1_symbol(cfg: PucchConfig, bits) -> complex:
    """d(0): 1 for SR, BPSK for 1a, QPSK for 1b."""
    if cfg.format == "1":
        return 1.0 + 0j
    if cfg.format == "1a":
        return 1.0 - 2.0 * bits[0] + 0j
    return ((1.0 - 2.0 * bits[0]) + 1j * (1.0 - 2.0 * bits[1])) / np.sqrt(2)


def pucch_f1_encode(cfg: PucchConfig, bits: tuple[int, ...] = (1,), *,
                    device=None) -> torch.Tensor:
    """Format 1/1a/1b -> grid [nsymb, nre] contribution on ``device``
    (None = the CUDA card). Format 1 (SR): d = 1; 1a: BPSK on 1 ACK bit;
    1b: QPSK on 2 bits."""
    d = _f1_symbol(cfg, bits)
    cell = cfg.cell
    grid = np.zeros((cell.nsymb_sf, cell.nof_re), np.complex64)
    nsym = cell.nsymb_slot
    for slot in range(2):
        shift, oc = _f1_resources(cfg, slot)
        k0 = 12 * cfg.prb(slot)
        for i, l in enumerate(F1_DATA_SYMS):
            seq = _alpha_seq(cfg, slot, l, shift)
            grid[slot * nsym + l, k0:k0 + 12] += d * W_F1[oc, i] * seq
        for i, l in enumerate(F1_DMRS_SYMS):
            seq = _alpha_seq(cfg, slot, l, shift)
            grid[slot * nsym + l, k0:k0 + 12] += W_F1_DMRS[oc, i] * seq
    return torch.as_tensor(grid, device=resolve_device(device))


def _despread_tables(cfg: PucchConfig):
    """(flat RE indices [2, nsym, 12] int64, conj sequences [2, nsym, 12]
    complex64) of every symbol of both slots of ``cfg``'s PRBs."""
    cell = cfg.cell
    nsym = cell.nsymb_slot
    idx = np.zeros((2, nsym, 12), np.int64)
    seq = np.zeros((2, nsym, 12), np.complex64)
    for slot in range(2):
        k0 = 12 * cfg.prb(slot)
        shift = _shift(cfg, slot)
        for l in range(nsym):
            idx[slot, l] = (slot * nsym + l) * cell.nof_re + k0 \
                + np.arange(12)
            seq[slot, l] = np.conj(_alpha_seq(cfg, slot, l, shift))
    return idx, seq


def _despread(grid: torch.Tensor, cfg: PucchConfig) -> torch.Tensor:
    """z [..., 2, nsym]: each symbol's 12 REs correlated with its
    cyclic-shifted sequence, / 12 (cross-user terms of other shifts and
    covers cancel in the 12-RE sum)."""
    dev = grid.device
    idx = device_table(("pucch_idx", cfg), dev,
                       lambda: _despread_tables(cfg)[0])
    seq = device_table(("pucch_seq", cfg), dev,
                       lambda: _despread_tables(cfg)[1])
    flat = grid.reshape(*grid.shape[:-2], -1)
    return (flat[..., idx] * seq).sum(-1) / 12.0


def _f1_weights(cfg: PucchConfig) -> np.ndarray:
    """[2, 2, nsym] complex64: per slot, the DMRS weights whose sum with z
    is the channel reference h (conj cover / 3), and the data symbols'
    covers."""
    w = np.zeros((2, 2, cfg.cell.nsymb_slot), np.complex64)
    for slot in range(2):
        _, oc = _f1_resources(cfg, slot)
        for i, l in enumerate(F1_DMRS_SYMS):
            w[0, slot, l] = np.conj(W_F1_DMRS[oc, i]) / len(F1_DMRS_SYMS)
        for i, l in enumerate(F1_DATA_SYMS):
            w[1, slot, l] = W_F1[oc, i]
    return w


def pucch_f1_decode(grid: torch.Tensor, cfg: PucchConfig):
    """Coherent format-1 detection: grid [..., nsymb, nre] ->
    (d [...] complex64, energy [...] float32), where d is the
    channel-compensated symbol and energy the sum of |h|^2 over the
    data symbols of both slots (the presence statistic). Profiler range
    ``pucch.f1_decode``."""
    with trace.span("pucch.f1_decode"):
        z = _despread(grid, cfg)                           # [..., 2, nsym]
        w = device_table(("pucch_f1_w", cfg), grid.device,
                         lambda: _f1_weights(cfg))
        h = (z * w[0]).sum(-1)                             # [..., 2]
        num = (torch.conj(h) * (z * w[1]).sum(-1)).sum(-1)
        den = len(F1_DATA_SYMS) * (h.abs() ** 2).sum(-1)
        return num / den.clamp_min(1e-12), den


def pucch_f1_bits(d: torch.Tensor, fmt: str) -> torch.Tensor:
    """Hard decisions of ``pucch_f1_decode``'s d [...] -> int8 [..., n]:
    the ACK bit (1a), the two ACK bits (1b), or SR presence |d| > 0.5."""
    if fmt == "1a":
        bits = [d.real <= 0]
    elif fmt == "1b":
        bits = [d.real <= 0, d.imag <= 0]
    else:
        bits = [d.abs() > 0.5]
    return torch.stack(bits, dim=-1).to(torch.int8)


def _f2_ack_symbol(ack_bits: tuple) -> complex:
    """d(10) for formats 2a/2b (36.211 5.4.2/Table 5.4.2-1): BPSK for one
    ACK bit, QPSK for two."""
    if len(ack_bits) == 1:
        return 1.0 - 2.0 * ack_bits[0]
    b0, b1 = ack_bits
    return ((1 - 2 * b0) + 1j * (1 - 2 * b1)) / np.sqrt(2)


def pucch_f2_encode(cfg: PucchConfig, payload_bits, ack_bits: tuple = (),
                    *, device=None) -> torch.Tensor:
    """Format 2/2a/2b -> grid [nsymb, nre] on ``device`` (None = the CUDA
    card): RM(20,O)-coded payload, QPSK, 5 data symbols per slot. For
    2a/2b the second DMRS symbol of each slot is modulated by the ACK
    symbol d(10) (pucch.c formats 2a/2b)."""
    coded = rm_encode(np.asarray(payload_bits, np.int8)[None], 20)[0]
    d = ((1 - 2 * coded[0::2]) + 1j * (1 - 2 * coded[1::2])) / np.sqrt(2)
    d_ack = _f2_ack_symbol(tuple(ack_bits)) if ack_bits else 1.0
    cell = cfg.cell
    grid = np.zeros((cell.nsymb_sf, cell.nof_re), np.complex64)
    nsym = cell.nsymb_slot
    shift = cfg.n_pucch % 12
    di = 0
    for slot in range(2):
        k0 = 12 * cfg.prb(slot)
        for l in F2_DATA_SYMS:
            seq = _alpha_seq(cfg, slot, l, shift)
            grid[slot * nsym + l, k0:k0 + 12] += d[di] * seq
            di += 1
        for j, l in enumerate(F2_DMRS_SYMS):
            seq = _alpha_seq(cfg, slot, l, shift)
            mod = d_ack if j == 1 else 1.0
            grid[slot * nsym + l, k0:k0 + 12] += mod * seq
    return torch.as_tensor(grid, device=resolve_device(device))


def pucch_f2_soft(grid: torch.Tensor, cfg: PucchConfig, nof_ack: int = 0):
    """Format 2/2a/2b soft values: grid [..., nsymb, nre] ->
    (llrs [..., 20] float32, d_ack [...] complex64, energy [...] float32).
    The first DMRS symbol of each slot is the channel reference with
    2a/2b (the second carries d(10)), both otherwise; the LLRs are the
    channel-compensated QPSK symbols times sqrt(2), slot by slot, real
    then imaginary part."""
    z = _despread(grid, cfg)                               # [..., 2, nsym]
    r0, r1 = F2_DMRS_SYMS
    h = z[..., r0] if nof_ack else (z[..., r0] + z[..., r1]) / 2.0
    e = h.abs() ** 2                                       # [..., 2]
    hc = torch.conj(h) / e.clamp_min(1e-12)
    d_ack = (z[..., r1] * hc).sum(-1)
    data = device_table(("pucch_f2_data",), grid.device,
                        lambda: np.asarray(F2_DATA_SYMS, np.int64))
    d = z[..., data] * hc[..., None] * np.float32(np.sqrt(2))
    llrs = torch.stack([d.real, d.imag], dim=-1)           # [..., 2, 5, 2]
    return llrs.reshape(*llrs.shape[:-3], 20), d_ack, e.sum(-1)


def pucch_f2_decode(grid: torch.Tensor, cfg: PucchConfig, nof_bits: int,
                    nof_ack: int = 0, return_energy: bool = False):
    """Format 2/2a/2b decode -> payload bits [..., nof_bits] int8 (and the
    ACK bits [..., nof_ack] int8 when nof_ack > 0; and the coherent DMRS
    energy [...] when ``return_energy`` — the presence-detection
    statistic), in the JAX package's tuple order. The payload is the ML
    RM(20, nof_bits) decision over the 20 LLRs. Profiler range
    ``pucch.f2_decode``."""
    with trace.span("pucch.f2_decode"):
        llrs, d_ack, energy = pucch_f2_soft(grid, cfg, nof_ack)
        out = [rm_decode(llrs, 20, nof_bits)]
        if nof_ack:
            ack = [d_ack.real <= 0, d_ack.imag <= 0][:nof_ack]
            out.append(torch.stack(ack, dim=-1).to(torch.int8))
    if return_energy:
        out.append(energy)
    return out[0] if len(out) == 1 else tuple(out)
