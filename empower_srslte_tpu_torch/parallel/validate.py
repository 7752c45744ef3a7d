"""Sharding-validation pipeline shared by the chip smoke run and the
multi-process dry run.

Counterpart of the JAX package's ``parallel/validate.py``.
``build_uedl_mini`` returns the complete no-genie UE downlink chain —
eNB compose -> time samples -> OFDM FFT -> LS channel estimation off the
CRS -> pilot noise estimate -> PCFICH decode -> one PDCCH candidate
(Viterbi + CRC16-RNTI) -> PDSCH decode with the estimated channel — as a
per-shard step for ``parallel.mesh.smap`` over any mesh. It is the chain
the framework ships at the receiver (reference analog:
lib/examples/pdsch_ue.c main loop), built at 6 PRB so the CPU tests stay
fast.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..convert import decoder_impl_from_jax
from ..models.dci import format0_1a_size
from ..models.enb_dl import enb_dl_base_grid, enb_dl_gen_signal
from ..models.pcfich import pcfich_decode, pcfich_put
from ..models.pdcch import (BITS_PER_CCE, pdcch_encode, pdcch_extract_llr,
                            ue_search_candidates)
from ..models.pdsch import PdschConfig, pdsch_decode, pdsch_encode
from ..models.regs import pdcch_nof_cces
from ..ops.chest import chest_dl_ports
from ..ops.fec.convcoder import viterbi_decode
from ..ops.fec.rm_conv import rm_conv_rx
from ..ops.modem import Mod
from ..ops.ofdm import ofdm_rx_sf
from ..utils.bits import uint_to_bits
from ..utils.cell import Cell
from ..utils.crc import CRC16
from ..utils.device import resolve_device


def build_uedl_mini(seed: int = 0, device=None):
    """-> (local_step, tbs): ``local_step(tb_bits[..., tbs]) ->
    (bits[..., tbs], ok[...])`` runs eNB compose -> UE full receive on
    ``tb_bits``' device; deterministic in ``seed`` so every process builds
    identical steps. ``device`` (None: the card, raising without one)
    holds the step's constants; each call moves them to its input's
    device. The PDSCH decodes on the plan the JAX function names
    (``"xla"``: the plain windowed sweeps)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    cell = Cell(nof_prb=6, nof_ports=1, id=1)
    sf_idx, cfi, rnti = 1, 1, 0x5A5A
    cfg = PdschConfig(cell=cell, sf_idx=sf_idx, cfi=cfi, rnti=rnti,
                      mod=Mod.QPSK)
    tbs = 136                        # K=160 (windowed decoder eligible)
    plan = dataclasses.replace(cfg.plan(tbs),
                               decoder_impl=decoder_impl_from_jax("xla"))
    size1a = format0_1a_size(6)
    dci_bits = torch.as_tensor(rng.integers(0, 2, size1a).astype(np.int8),
                               device=dev)
    n_cce = pdcch_nof_cces(cell, cfi)
    dci_l, dci_cce = ue_search_candidates(rnti, sf_idx, n_cce)[0]
    mask16 = torch.as_tensor(uint_to_bits(rnti & 0xFFFF, 16), device=dev)

    def local_step(tb_bits):
        d = tb_bits.device
        grid = enb_dl_base_grid(cell, sf_idx, batch_shape=tb_bits.shape[:-1],
                                device=d)
        grid = pcfich_put(grid, cfi, cell, sf_idx)
        grid = grid + pdcch_encode(dci_bits.to(d), rnti, dci_cce, dci_l,
                                   cell, cfi, sf_idx)
        grid = grid + pdsch_encode(tb_bits, cfg, plan)
        samples = enb_dl_gen_signal(grid, cell)[..., 0, :]
        rx = ofdm_rx_sf(samples, cell)
        h, n0 = chest_dl_ports(rx, cell, sf_idx, (0,))
        h = h[..., 0, :, :]
        n0 = torch.clamp(n0[..., 0], min=1e-6)
        cfi_hat, _ = pcfich_decode(rx, h, cell, sf_idx,
                                   noise_est=n0[..., None])
        llr_c = pdcch_extract_llr(rx, h, cell, cfi, sf_idx,
                                  noise_est=n0[..., None])
        e = dci_l * BITS_PER_CCE
        seg = llr_c[..., dci_cce * BITS_PER_CCE:
                    dci_cce * BITS_PER_CCE + e]
        dbits = viterbi_decode(rm_conv_rx(seg, size1a + 16))
        unmasked = torch.cat(
            [dbits[..., :size1a],
             torch.bitwise_xor(dbits[..., size1a:], mask16.to(d))], dim=-1)
        dci_ok = CRC16.check(unmasked)
        bits, ok, _ = pdsch_decode(rx[..., None, :, :],
                                   h[..., None, None, :, :], cfg, plan,
                                   noise_est=n0[..., None])
        return bits, ok & (cfi_hat == cfi) & dci_ok

    return local_step, tbs
