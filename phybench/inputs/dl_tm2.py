"""A 4-port cell's transmit-diversity (TM2) downlink: the benchmark's
transmitter.

Built from ``phybench.frozen`` (a frozen copy of the port's encoders) and
importing nothing of the port. Its pieces: the frozen DL-SCH encoder on a
plan whose E split takes N_L 2 (TS 36.212 5.1.4.1.2: the layers of
transmit diversity), the frozen SFBC-FSTD PDSCH, the 4-port CRS and
PCFICH and the OFDM modulator. The PDCCH is composed here, from the
frozen convolutional code, rate matching, scrambling, QPSK, region table
and SFBC-FSTD precoder, as TS 36.211 6.8.4 sends it on 4 ports: the
frozen ``pdcch_encode`` sends 2-port SFBC on ports 0 and 1 of a 4-port
cell. It draws everything from one ``torch.Generator`` on the device:
the DCI bits, the TB bits, a flat 2x4 channel per subframe (every entry
of unit modulus, its phase uniform) and complex AWGN at ``snr_db`` of
the batch's mean sample power. A CPU test holds its control region and
PDSCH, RE for RE, to ``phybench.references.dl_tm2``, which shares none of
this code.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..frozen.models import dci as dci_mod
from ..frozen.models import pdsch as pdsch_mod
from ..frozen.models import ra
from ..frozen.models.pcfich import pcfich_put
from ..frozen.models.pdcch import BITS_PER_CCE, RE_PER_CCE, _region_idx
from ..frozen.models.refsignal import crs_pilots
from ..frozen.ops.equalizer import MimoType, layermap, precode_sfbc_fstd
from ..frozen.ops.fec.convcoder import conv_encode
from ..frozen.ops.fec.rm_conv import rm_conv_tx
from ..frozen.ops.modem import Mod, modulate
from ..frozen.ops.ofdm import ofdm_tx_sf
from ..frozen.utils.bits import uint_to_bits
from ..frozen.utils.cell import Cell
from ..frozen.utils.crc import CRC16
from ..frozen.utils.sequence import cinit_pdcch, gold_sequence

#: (format name -> payload size) of the DCI the transmitter sends
DCI_SIZES = {"1": dci_mod.format1_size, "1A": dci_mod.format0_1a_size}


def plan(conf: dict):
    """The configuration's PDSCH config and DL-SCH plan, worked out from
    its numbers: -> (PdschConfig, DlschPlan) of the frozen copy, the plan
    with N_L 2."""
    cell = Cell(nof_prb=conf["nof_prb"], nof_ports=conf["nof_ports"],
                id=conf["cell_id"])
    mod, tbs = ra.mcs_to_tbs(conf["mcs"], conf["nof_prb"])
    cfg = pdsch_mod.PdschConfig(
        cell=cell, sf_idx=conf["sf_idx"], cfi=conf["cfi"],
        rnti=conf["rnti"], mod=mod, mimo=MimoType.DIVERSITY,
        nof_layers=conf["nof_layers"], nof_codewords=conf["nof_codewords"])
    pl = cfg.plan(tbs, max_iterations=conf["max_iterations"])
    return cfg, dataclasses.replace(pl, n_layers=2)


def _base_grid(cell: Cell, sf_idx: int, n: int, device) -> torch.Tensor:
    """[n, ports, nsymb, nre] complex64, every port's CRS in place."""
    grid = torch.zeros((n, cell.nof_ports, cell.nsymb_sf * cell.nof_re),
                       dtype=torch.complex64, device=device)
    for p in range(cell.nof_ports):
        idx, syms, vals = crs_pilots(cell, sf_idx, p)
        flat = (syms[:, None] * cell.nof_re + idx).reshape(-1)
        grid[:, p, torch.as_tensor(flat.astype(np.int64), device=device)] = \
            torch.as_tensor(vals.reshape(-1), device=device)
    return grid.reshape(n, cell.nof_ports, cell.nsymb_sf, cell.nof_re)


def pdcch_ports(dci_bits, conf: dict, cell: Cell, device) -> torch.Tensor:
    """One DCI on the 4 ports' grid [4, nsymb, nre] (36.211 6.8, 36.212
    5.3.3): its CRC16 masked by the RNTI, the tail-biting code rate
    matched to L CCEs, scrambled from its first CCE on, QPSK, layer
    mapping onto 4 layers and SFBC-FSTD, at its CCEs' quadruplets."""
    cce, l, cfi = conf["dci_cce"], conf["dci_l"], conf["cfi"]
    mask = torch.as_tensor(uint_to_bits(conf["rnti"] & 0xFFFF, 16),
                           device=device)
    payload = torch.cat([dci_bits.to(torch.int8), torch.bitwise_xor(
        CRC16.compute(dci_bits).to(torch.int8), mask)])
    coded = rm_conv_tx(conv_encode(payload), l * BITS_PER_CCE)
    seq = gold_sequence(cinit_pdcch(2 * conf["sf_idx"], cell.id),
                        (cce + l) * BITS_PER_CCE)[cce * BITS_PER_CCE:]
    syms = modulate(torch.bitwise_xor(coded, torch.as_tensor(
        seq, device=device)), Mod.QPSK)
    idx = _region_idx(cell, cfi, 1.0, device)[
        cce * RE_PER_CCE:(cce + l) * RE_PER_CCE]
    grid = torch.zeros((4, cell.nsymb_sf * cell.nof_re),
                       dtype=torch.complex64, device=device)
    grid[:, idx] = precode_sfbc_fstd(layermap([syms], 4))
    return grid.reshape(4, cell.nsymb_sf, cell.nof_re)


def transmit(conf: dict, traffic: dict, n: int, gen: torch.Generator,
             device) -> dict:
    """``n`` subframes drawn from ``gen`` -> dict(samples [n, rx, sf_len]
    complex64, grid [n, 4, nsymb, nre] complex64 (the ports' grid before
    the channel), tb [n, tbs] int8, dci_bits [size] int8)."""
    cfg, pl = plan(conf)
    cell = cfg.cell
    size = DCI_SIZES[conf["dci_format"]](cell.nof_prb)
    bits = lambda *shape: torch.randint(0, 2, shape, generator=gen,
                                        device=device, dtype=torch.int8)
    dci_bits = bits(size)
    tb = bits(n, pl.tbs)
    rx, ports = conf["nof_rx"], cell.nof_ports
    phase = torch.rand((n, rx, ports), generator=gen, device=device,
                       dtype=torch.float64) * (2 * math.pi)
    h = torch.polar(torch.ones_like(phase), phase).to(torch.complex64)

    grid = _base_grid(cell, cfg.sf_idx, n, device)
    grid = pcfich_put(grid, cfg.cfi, cell, cfg.sf_idx)
    grid = grid + pdcch_ports(dci_bits, conf, cell, device)
    grid = grid + pdsch_mod.pdsch_encode(tb, cfg, pl)
    samples = ofdm_tx_sf(torch.einsum("brp,bpsk->brsk", h, grid), cell)
    p_sig = torch.mean(samples.abs() ** 2)
    sigma = torch.sqrt(p_sig * 10 ** (-traffic["snr_db"] / 10))
    noise = torch.randn(samples.shape, generator=gen, device=device,
                        dtype=torch.complex64)          # unit power
    return dict(samples=samples + sigma * noise, grid=grid, tb=tb,
                dci_bits=dci_bits)
