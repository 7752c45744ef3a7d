"""The 2x2 TM4 downlink's inputs: the benchmark's transmitter.

Built from ``phybench.frozen`` (a frozen copy of the port's encoders) and
importing nothing of the port. It draws everything from one
``torch.Generator`` on the device: the DCI bits, both codewords' TB bits,
a flat 2x2 channel per subframe (unit diagonal, ``offdiag`` off it,
uniform random phases) and complex AWGN at ``snr_db`` of the batch's mean
sample power. The plain receiver in ``phybench.references.dl_pdsch``
shares none of this code; that it decodes these subframes to the sent
bits is what shows the transmitter keeps to TS 36.211/36.212.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..frozen.models import dci as dci_mod
from ..frozen.models import pdsch as pdsch_mod
from ..frozen.models import ra
from ..frozen.models.pcfich import pcfich_put
from ..frozen.models.pdcch import pdcch_encode
from ..frozen.models.refsignal import crs_pilots
from ..frozen.ops.equalizer import MimoType
from ..frozen.ops.ofdm import ofdm_tx_sf
from ..frozen.utils.cell import Cell

#: (format name -> payload size) of the DCI the transmitter sends
DCI_SIZES = {"1": dci_mod.format1_size, "1A": dci_mod.format0_1a_size}


def plan(conf: dict):
    """The configuration's PDSCH config and DL-SCH plan, worked out from
    its numbers: -> (PdschConfig, DlschPlan) of the frozen copy."""
    cell = Cell(nof_prb=conf["nof_prb"], nof_ports=conf["nof_ports"],
                id=conf["cell_id"])
    mod, tbs = ra.mcs_to_tbs(conf["mcs"], conf["nof_prb"])
    cfg = pdsch_mod.PdschConfig(
        cell=cell, sf_idx=conf["sf_idx"], cfi=conf["cfi"],
        rnti=conf["rnti"], mod=mod, mimo=MimoType.SPATIAL_MUX,
        nof_layers=conf["nof_layers"], nof_codewords=conf["nof_codewords"],
        pmi=conf["pmi"])
    return cfg, cfg.plan(tbs, max_iterations=conf["max_iterations"])


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


def transmit(conf: dict, traffic: dict, n: int, gen: torch.Generator,
             device) -> dict:
    """``n`` subframes drawn from ``gen`` -> dict(samples [n, rx, sf_len]
    complex64, tb and tb2 [n, tbs] int8, dci_bits [size] int8)."""
    cfg, pl = plan(conf)
    cell = cfg.cell
    size = DCI_SIZES[conf["dci_format"]](cell.nof_prb)
    bits = lambda *shape: torch.randint(0, 2, shape, generator=gen,
                                        device=device, dtype=torch.int8)
    dci_bits = bits(size)
    tb, tb2 = bits(n, pl.tbs), bits(n, pl.tbs)
    rx, ports = conf["nof_rx"], cell.nof_ports
    phase = torch.rand((n, rx, ports), generator=gen, device=device,
                       dtype=torch.float64) * (2 * math.pi)
    mag = torch.full((rx, ports), float(traffic["offdiag"]),
                     dtype=torch.float64, device=device)
    mag.fill_diagonal_(1.0)
    h = torch.polar(mag.expand(n, rx, ports), phase).to(torch.complex64)

    grid = _base_grid(cell, cfg.sf_idx, n, device)
    grid = pcfich_put(grid, cfg.cfi, cell, cfg.sf_idx)
    grid = grid + pdcch_encode(dci_bits, cfg.rnti, conf["dci_cce"],
                               conf["dci_l"], cell, cfg.cfi, cfg.sf_idx)
    grid = grid + pdsch_mod.pdsch_encode(tb, cfg, pl, tb2, pl)
    samples = ofdm_tx_sf(torch.einsum("brp,bpsk->brsk", h, grid), cell)
    p_sig = torch.mean(samples.abs() ** 2)
    sigma = torch.sqrt(p_sig * 10 ** (-traffic["snr_db"] / 10))
    noise = torch.randn(samples.shape, generator=gen, device=device,
                        dtype=torch.complex64)          # unit power
    return dict(samples=samples + sigma * noise, tb=tb, tb2=tb2,
                dci_bits=dci_bits)
