"""The JAX package's downlink brought to TS 36.211/36.212 for the tests that
hold the port to it.

The port's PHICH follows TS 36.211 6.9 and 36.212 5.3.5: the HI (1 = ACK)
is coded as three equal bits, each BPSK-modulated as (1 - 2b)(1 + j)/sqrt(2)
(7.1.1), so that ACK is -(1 + j)/sqrt(2), and scrambled with c_init =
(floor(n_s / 2) + 1)(2 N_ID + 1) 2^9 + N_ID (6.9.1). The JAX package sends
ACK as a real +1 and scrambles with the PDCCH's c_init. On a 4-port cell
the port sends the PDCCH (6.8.4), the PHICH (6.9.2, its port pairs
alternating on (i + n_group) mod 2) and the PBCH (6.6.3) on SFBC-FSTD,
where the JAX package sends SFBC on ports 0 and 1; and the DL-SCH splits
its E on N_L 2 for transmit diversity and one codeword on two layers
(36.212 5.1.4.1.2), where the JAX package's ``PdschConfig.plan`` takes 1.
``spec_downlink()`` replaces JAX's ``phich_put`` and ``phich_decode``,
its 4-port ``pdcch_encode``, ``pdcch_extract_llr``, ``pbch_put`` and
``pbch_decode``, and its plans' N_L, while it is open, by the
specification's, written here on top of the JAX package's own pieces (its
group REs, orthogonal sequences, Gold sequence, codes, layer mapper, SFBC
and SFBC-FSTD precoders and equalizers); the PHICH decode's metric is the
despread symbol's projection on the ACK symbol, as the port's. On 1 and 2
ports the PDCCH and PBCH stay JAX's own. Every other JAX stage stays as
it is, so the port stays held to it as tightly as before. The JAX caches
that could hold a program traced with the other side's stages are
cleared on entry and on exit.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from empower_srslte_tpu.models import pbch as jpbch
from empower_srslte_tpu.models import pdcch as jpdcch
from empower_srslte_tpu.models import pdsch as jpdsch
from empower_srslte_tpu.models import phich as jphich
from empower_srslte_tpu.models import ue_dl as jue_dl
from empower_srslte_tpu.ops.equalizer import (MimoType, eq_sfbc,
                                              eq_sfbc_fstd, layermap,
                                              precode_sfbc,
                                              precode_sfbc_fstd)
from empower_srslte_tpu.ops.modem import Mod, demod_soft, modulate
from empower_srslte_tpu.ops.scrambling import descramble_llrs
from empower_srslte_tpu.utils.bits import uint_to_bits
from empower_srslte_tpu.utils.crc import CRC16
from empower_srslte_tpu.utils.scatter import overlay, place
from empower_srslte_tpu.utils.sequence import (cinit_pcfich, cinit_pdcch,
                                               gold_sequence)

#: the JAX functions the specification's stand in for
JAX = {"pdcch_encode": jpdcch.pdcch_encode,
       "pdcch_extract_llr": jpdcch.pdcch_extract_llr,
       "pbch_put": jpbch.pbch_put, "pbch_decode": jpbch.pbch_decode,
       "plan": jpdsch.PdschConfig.plan}

#: the BPSK symbol of HI bit 0 (NACK); bit 1 (ACK) is its negative
BPSK0 = (1 + 1j) / np.sqrt(2)


def _scramble(cell, sf_idx: int) -> np.ndarray:
    """1 - 2 c(i), i < 12, c_init of 36.211 6.9.1."""
    c = gold_sequence(cinit_pcfich(2 * sf_idx, cell.id), 12)
    return (1.0 - 2.0 * c).astype(np.float32)


def _fstd_pairs(ports: list, group: int) -> list:
    """Per-port arrays [..., 12]: the quadruplets i with (i + group) odd
    take ports 1, 0, 3, 2 in place of 0, 1, 2, 3 (36.211 6.9.2); the same
    for the symbols and the channel."""
    return [jnp.concatenate([ports[p ^ ((i + group) & 1)][..., 4 * i:4 * i + 4]
                             for i in range(3)], axis=-1) for p in range(4)]


def phich_put(grid, ack: int, cell, sf_idx: int, group: int = 0,
              seq_idx: int = 0, ng: float = 1.0):
    """JAX's ``phich_put`` with the specification's symbols d(0..11), on
    SFBC-FSTD with alternating port pairs on a 4-port cell."""
    z = np.tile(jphich._W[seq_idx], 3) * _scramble(cell, sf_idx) * (
        -BPSK0 if ack else BPSK0)
    idx = jphich._group_re_indices(cell, ng, group)
    flat = grid.reshape(*grid.shape[:-3], grid.shape[-3], -1)
    zt = jnp.asarray(z.astype(np.complex64)).astype(grid.dtype)
    if cell.nof_ports == 4:
        ps = precode_sfbc_fstd(layermap([zt], 4))
        ps = _fstd_pairs([ps[..., p, :] for p in range(4)], group)
        rows = [overlay(flat[..., p, :], flat[..., p, jnp.asarray(idx)]
                        + ps[p], idx) for p in range(4)]
        flat = jnp.concatenate([r[..., None, :] for r in rows], axis=-2)
    elif cell.nof_ports >= 2:
        ps = precode_sfbc(jnp.stack([zt[0::2], zt[1::2]], axis=-2))
        rows = [overlay(flat[..., p, :], flat[..., p, jnp.asarray(idx)]
                        + ps[..., p, :], idx) for p in range(2)]
        flat = jnp.concatenate([r[..., None, :] for r in rows]
                               + [flat[..., 2:, :]], axis=-2)
    else:
        p0 = overlay(flat[..., 0, :], flat[..., 0, jnp.asarray(idx)] + zt,
                     idx)
        flat = jnp.concatenate([p0[..., None, :], flat[..., 1:, :]], axis=-2)
    return flat.reshape(grid.shape)


def phich_decode(grid, h, cell, sf_idx: int, group: int = 0,
                 seq_idx: int = 0, ng: float = 1.0, noise_est=0.0):
    """JAX's ``phich_decode`` on the specification's symbols: -> (ack,
    metric), the metric positive <=> ACK."""
    idx = jnp.asarray(jphich._group_re_indices(cell, ng, group))
    y = grid[..., 0, :][..., idx]
    if h.ndim == grid.ndim + 1 and h.shape[-3] == 4:
        hp = _fstd_pairs([h[..., p, 0, :][..., idx] for p in range(4)],
                         group)
        x, _ = eq_sfbc_fstd(y[..., None, :], *(a[..., None, :] for a in hp))
    elif h.ndim == grid.ndim + 1 and h.shape[-3] >= 2:
        x, _ = eq_sfbc(y[..., None, :], h[..., 0, 0, :][..., idx][..., None, :],
                       h[..., 1, 0, :][..., idx][..., None, :])
    else:
        if h.ndim == grid.ndim + 1:
            h = h[..., 0, :, :]
        hh = h[..., 0, :][..., idx]
        x = y * jnp.conj(hh) / jnp.maximum(jnp.abs(hh) ** 2 + noise_est,
                                           1e-12)
    w = jnp.asarray(np.tile(np.conj(jphich._W[seq_idx]), 3))
    corr = jnp.sum(x * jnp.asarray(_scramble(cell, sf_idx)) * w,
                   axis=-1) / 12.0
    metric = -(jnp.real(corr) + jnp.imag(corr)) / np.float32(np.sqrt(2))
    return metric > 0, metric


def pdcch_encode(dci_bits, rnti: int, cce: int, l: int, cell, cfi: int,
                 sf_idx: int, ng: float = 1.0):
    """JAX's ``pdcch_encode`` with SFBC-FSTD on a 4-port cell (36.211
    6.8.4): one DCI's symbols on its CCEs' quadruplets, layer-mapped onto
    4 layers and precoded."""
    if cell.nof_ports != 4:
        return JAX["pdcch_encode"](dci_bits, rnti, cce, l, cell, cfi,
                                   sf_idx, ng)
    e = l * jpdcch.BITS_PER_CCE
    crc = CRC16.jnp_compute(dci_bits).astype(jnp.int8)
    payload = jnp.concatenate(
        [dci_bits.astype(jnp.int8), jnp.bitwise_xor(
            crc, jnp.asarray(uint_to_bits(rnti & 0xFFFF, 16)))], axis=-1)
    coded = jpdcch.rm_conv_tx(jpdcch.conv_encode(payload), e)
    seq = gold_sequence(cinit_pdcch(2 * sf_idx, cell.id),
                        (cce + l) * jpdcch.BITS_PER_CCE)[
        cce * jpdcch.BITS_PER_CCE:]
    syms = modulate(jnp.bitwise_xor(coded, jnp.asarray(seq)), Mod.QPSK)
    idx = jpdcch._region_re_indices(cell, cfi, ng)[
        cce * jpdcch.RE_PER_CCE:(cce + l) * jpdcch.RE_PER_CCE]
    ps = precode_sfbc_fstd(layermap([syms], 4))
    flat_len = cell.nsymb_sf * cell.nof_re
    grid = jnp.stack([place(ps[..., p, :], idx, flat_len) for p in range(4)],
                     axis=-2)
    return grid.reshape(*syms.shape[:-1], 4, cell.nsymb_sf, cell.nof_re)


def pdcch_extract_llr(grid, h, cell, cfi: int, sf_idx: int, noise_est=0.0,
                      ng: float = 1.0):
    """JAX's ``pdcch_extract_llr`` with SFBC-FSTD combining on a 4-port
    channel."""
    if not (h.ndim == grid.ndim + 1 and h.shape[-3] == 4):
        return JAX["pdcch_extract_llr"](grid, h, cell, cfi, sf_idx,
                                        noise_est, ng)
    idx = jnp.asarray(jpdcch._region_re_indices(cell, cfi, ng))
    y = grid.reshape(*grid.shape[:-2], -1)[..., idx]
    hf = h.reshape(*h.shape[:-2], -1)
    x, csi = eq_sfbc_fstd(y[..., None, :], *(hf[..., p, :][..., idx][
        ..., None, :] for p in range(4)))
    llr = demod_soft(x, Mod.QPSK) * jnp.repeat(csi, 2, axis=-1)
    return descramble_llrs(llr, cinit_pdcch(2 * sf_idx, cell.id))


def pbch_put(grid, mib_bits, cell, sfn: int):
    """JAX's ``pbch_put`` with SFBC-FSTD on a 4-port cell (36.211
    6.6.3)."""
    if cell.nof_ports != 4:
        return JAX["pbch_put"](grid, mib_bits, cell, sfn)
    coded = jpbch.pbch_encode_period(mib_bits, cell)
    q = sfn % 4
    syms = modulate(coded[..., q * jpbch.QUARTER:(q + 1) * jpbch.QUARTER],
                    Mod.QPSK)
    ps = precode_sfbc_fstd(layermap([syms], 4))
    idx = jpbch.pbch_re_indices(cell)
    flat = grid.reshape(*grid.shape[:-3], grid.shape[-3], -1)
    rows = [overlay(flat[..., p, :], ps[..., p, :], idx) for p in range(4)]
    return jnp.stack(rows, axis=-2).reshape(grid.shape)


def pbch_decode(grid, h, cell, noise_est=0.0):
    """JAX's ``pbch_decode`` with SFBC-FSTD combining on a 4-port channel:
    the 4 frame phases x 3 port masks as JAX tries them."""
    if not (h.ndim == grid.ndim + 1 and h.shape[-3] == 4):
        return JAX["pbch_decode"](grid, h, cell, noise_est)
    idx = jnp.asarray(jpbch.pbch_re_indices(cell))
    y = grid.reshape(*grid.shape[:-2], -1)[..., idx]
    hf = h.reshape(*h.shape[:-2], -1)
    x, csi = eq_sfbc_fstd(y[..., None, :], *(hf[..., p, :][..., idx][
        ..., None, :] for p in range(4)))
    llr480 = demod_soft(x, Mod.QPSK) * jnp.repeat(csi, 2, axis=-1)
    lead = llr480.shape[:-1]
    outs_bits, outs_ok = [], []
    for q in range(4):
        buf = jnp.zeros((*lead, jpbch.PBCH_BITS), llr480.dtype)
        buf = buf.at[..., q * jpbch.QUARTER:(q + 1) * jpbch.QUARTER].set(
            llr480)
        bits = jpbch.viterbi_decode(jpbch.rm_conv_rx(
            descramble_llrs(buf, cell.id), 40), wrap=1)
        for mask in jpbch.PORT_MASKS.values():
            unmasked = jnp.concatenate(
                [bits[..., :24], jnp.bitwise_xor(
                    bits[..., 24:].astype(jnp.int8),
                    jnp.asarray(uint_to_bits(mask, 16)))], axis=-1)
            outs_ok.append(CRC16.jnp_check(unmasked))
            outs_bits.append(bits[..., :24])
    oks = jnp.stack(outs_ok, axis=-1)
    allbits = jnp.stack(outs_bits, axis=-2)
    best = jnp.argmax(oks, axis=-1)
    mib = jnp.take_along_axis(
        allbits, best[..., None, None].astype(jnp.int32), axis=-2)[..., 0, :]
    ports_tbl = jnp.asarray(list(jpbch.PORT_MASKS) * 4, jnp.int32)
    q_tbl = jnp.asarray(np.repeat(np.arange(4), 3), jnp.int32)
    return mib, q_tbl[best], ports_tbl[best], jnp.any(oks, axis=-1)


def plan(self, tbs: int, rv: int = 0, max_iterations: int = 5,
         decoder_impl: str = "auto"):
    """JAX's ``PdschConfig.plan`` with the E split's N_L of 36.212
    5.1.4.1.2: 2 for transmit diversity and for one codeword on two
    layers, else 1."""
    out = JAX["plan"](self, tbs, rv, max_iterations, decoder_impl)
    two = self.mimo is MimoType.DIVERSITY or (
        self.mimo is not MimoType.SINGLE and self.nof_codewords == 1
        and self.nof_layers == 2)
    return dataclasses.replace(out, n_layers=2) if two else out


def _clear() -> None:
    for cache in (jue_dl._phich_cache, jue_dl._pdcch_llr_cache,
                  jue_dl._pdsch_cache, jue_dl._front_cache,
                  jue_dl._mib_full_cache):
        cache.clear()
    jax.clear_caches()


@contextlib.contextmanager
def spec_downlink():
    """The JAX package's PHICH, 4-port PDCCH and PBCH and its plans' N_L
    replaced by the specification's while the block runs."""
    _clear()
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jphich, "phich_put", phich_put)
            mp.setattr(jphich, "phich_decode", phich_decode)
            mp.setattr(jpdcch, "pdcch_encode", pdcch_encode)
            mp.setattr(jpdcch, "pdcch_extract_llr", pdcch_extract_llr)
            mp.setattr(jpbch, "pbch_put", pbch_put)
            mp.setattr(jpbch, "pbch_decode", pbch_decode)
            mp.setattr(jpdsch.PdschConfig, "plan", plan)
            yield
    finally:
        _clear()
