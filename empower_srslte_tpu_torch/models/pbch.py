"""PBCH: physical broadcast channel (MIB), 36.211 6.6 / 36.212 5.3.1.

Capability parity with lib/src/phy/phch/pbch.c: MIB pack/unpack, CRC16
masked by the antenna-port count (port detection from the CRC mask,
pbch.c:156,425), tail-biting convolutional coding, rate matching to the
40 ms / 1920-bit PBCH allocation, one quarter per radio frame, and the
blind decode of the frame phase (SFN mod 4) and port count.

The blind decode stacks its 4 frame-phase hypotheses into one Viterbi
batch (one kernel launch per call on the card); the 3 port masks are
checked on each hypothesis' decision. Transmit diversity as 36.211
6.6.3 asks: SFBC on a 2-port cell, SFBC-FSTD on a 4-port one.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..ops.equalizer import combine_diversity, precode_diversity
from ..ops.fec.convcoder import conv_encode, viterbi_decode
from ..ops.fec.rm_conv import rm_conv_rx, rm_conv_tx
from ..ops.modem import Mod, demod_soft, modulate
from ..ops.scrambling import descramble_llrs, scramble_bits
from ..utils.bits import bits_to_uint, uint_to_bits
from ..utils.cell import Cell
from ..utils.crc import CRC16
from ..utils.device import device_table

#: Coded bits per 40 ms PBCH period (normal CP) and per radio frame.
PBCH_BITS = 1920
QUARTER = PBCH_BITS // 4
#: MIB (24) + CRC16 bits: the convolutional code word length K.
PBCH_K = 40

#: CRC masks per antenna-port count (36.212 Table 5.3.1.1-1).
PORT_MASKS = {1: 0x0000, 2: 0xFFFF, 4: 0x5555}

_BW_IDX = {6: 0, 15: 1, 25: 2, 50: 3, 75: 4, 100: 5}
_IDX_BW = {v: k for k, v in _BW_IDX.items()}


def mib_pack(nof_prb: int, phich_dur: int, phich_res: int,
             sfn: int) -> np.ndarray:
    """MIB -> 24 bits int8 (36.331 MasterInformationBlock)."""
    return np.concatenate([
        uint_to_bits(_BW_IDX[nof_prb], 3),
        uint_to_bits(phich_dur, 1),
        uint_to_bits(phich_res, 2),
        uint_to_bits((sfn >> 2) & 0xFF, 8),
        np.zeros(10, np.int8),
    ])


def mib_unpack(bits: np.ndarray) -> dict:
    return dict(
        nof_prb=_IDX_BW[bits_to_uint(bits[0:3])],
        phich_dur=bits_to_uint(bits[3:4]),
        phich_res=bits_to_uint(bits[4:6]),
        sfn_msb=bits_to_uint(bits[6:14]),
    )


@functools.lru_cache(maxsize=256)
def pbch_re_indices(cell: Cell) -> np.ndarray:
    """Flat (symbol * nof_re + k) indices of the 240 PBCH REs: slot-1
    symbols 0..3, central 72 subcarriers, skipping the CRS positions of 4
    antenna ports whatever the cell's count (36.211 6.6.4)."""
    nre = cell.nof_re
    mid = nre // 2
    vshift = cell.id % 6
    nsym = cell.nsymb_slot
    out = [(nsym + s) * nre + k for s in range(4)
           for k in range(mid - 36, mid + 36)
           if not (s < 2 and (k - vshift) % 3 == 0)]
    idx = np.asarray(out, np.int64)
    assert len(idx) == 240
    return idx


def _re_index_tensor(cell: Cell, device) -> torch.Tensor:
    return device_table(("pbch_re", cell), device,
                        lambda: pbch_re_indices(cell))


def _mask_bits(device) -> torch.Tensor:
    """[3, 16] int8 CRC masks in ``PORT_MASKS`` order (1, 2, 4 ports)."""
    return device_table(("pbch_masks",), device, lambda: np.stack(
        [uint_to_bits(m, 16) for m in PORT_MASKS.values()]))


def pbch_encode_period(mib_bits: torch.Tensor, cell: Cell) -> torch.Tensor:
    """24-bit MIB [..., 24] -> [..., 1920] scrambled coded bits of one
    40 ms period (srslte_pbch_encode: CRC16 XOR the port mask, tail-biting
    convolutional code, rate matching, scrambling by the cell ID)."""
    mask = _mask_bits(mib_bits.device)[list(PORT_MASKS).index(
        cell.nof_ports)]
    crc = CRC16.compute(mib_bits).to(torch.int8)
    payload = torch.cat([mib_bits.to(torch.int8),
                         torch.bitwise_xor(crc, mask.expand_as(crc))], dim=-1)
    return scramble_bits(rm_conv_tx(conv_encode(payload), PBCH_BITS),
                         cell.id)


def pbch_put(grid: torch.Tensor, mib_bits: torch.Tensor, cell: Cell,
             sfn: int) -> torch.Tensor:
    """Insert this frame's PBCH quarter into subframe-0 grids
    [..., P, nsymb, nre] -> new grid: the one port, SFBC on 2 ports,
    SFBC-FSTD on 4 (36.211 6.6.3; srslte_pbch_encode's layer map and
    diversity precoding)."""
    coded = pbch_encode_period(mib_bits, cell)
    q = sfn % 4
    syms = modulate(coded[..., q * QUARTER:(q + 1) * QUARTER], Mod.QPSK)
    idx = _re_index_tensor(cell, grid.device)
    out = grid.clone()
    flat = out.view(*grid.shape[:-2], -1)
    flat[..., :cell.nof_ports, idx] = precode_diversity(syms, cell.nof_ports)
    return out


def pbch_decode(grid: torch.Tensor, h: torch.Tensor, cell: Cell,
                noise_est=0.0):
    """Blind PBCH decode from subframe-0 grids (srslte_pbch_decode).

    grid [..., nsymb, nre] (one rx antenna); h the port-0 channel of the
    same shape, or [..., P, nsymb, nre] per port (SFBC on 2 ports,
    SFBC-FSTD on 4), at any bandwidth >= 6 PRB (the PBCH sits on the central
    72 subcarriers). Tries the 4 frame phases x 3 port masks; returns
    (mib_bits [..., 24] int8, sfn_mod4 [...], nof_ports [...], ok [...])
    of the first hypothesis whose CRC passes, phase-major as the JAX
    package orders them.
    """
    idx = _re_index_tensor(cell, grid.device)
    y = grid.reshape(*grid.shape[:-2], -1)[..., idx]
    hh = h.reshape(*h.shape[:-2], -1)[..., idx]
    x, csi = combine_diversity(y, hh, noise_est)
    llr480 = demod_soft(x, Mod.QPSK) * torch.repeat_interleave(csi, 2,
                                                               dim=-1)

    lead = llr480.shape[:-1]
    # the 4 frame phases as one batch [4, ..., 1920], phase-major
    buf = llr480.new_zeros((4, *lead, PBCH_BITS))
    for q in range(4):
        buf[q, ..., q * QUARTER:(q + 1) * QUARTER] = llr480
    bits = viterbi_decode(rm_conv_rx(descramble_llrs(buf, cell.id), PBCH_K))
    bits = bits.movedim(0, -2)                              # [..., 4, 40]
    tail = torch.bitwise_xor(bits[..., None, 24:],
                             _mask_bits(bits.device))       # [..., 4, 3, 16]
    head = bits[..., None, :24].expand(*tail.shape[:-1], 24)
    oks = CRC16.check(torch.cat([head, tail], dim=-1)).reshape(*lead, 12)
    best = torch.argmax(oks.to(torch.int32), dim=-1)        # first passing
    q = best // 3
    mib = torch.gather(bits[..., :24], -2,
                       q[..., None, None].expand(*lead, 1, 24))[..., 0, :]
    ports = device_table(("pbch_ports",), bits.device,
                         lambda: np.asarray(list(PORT_MASKS), np.int64))
    return mib, q, ports[best % 3], oks.any(-1)
