"""The PUSCH with UCI's inputs: the benchmark's uplink transmitter.

The UL-SCH and UCI coding, the channel interleaver, the scrambling, the
modulation, the transform precoding and the DMRS are the frozen copy of
the port's encoders in ``phybench.frozen``, its DMRS given the n_PN(ns)
term of TS 36.211 5.5.2.1.1 that the port's leaves out. The SC-FDMA
modulation (TS 36.211 5.6) is written here: subcarrier k of the grid at
frequency k - 6 N_RB + 1/2 (no DC gap), and the half-subcarrier phase
starting from 0 at each symbol's useful part, where the port's shift is
one ramp over the subframe and its grid leaves the DC bin empty.

The UCI payload is part of the grant's plan: the HARQ-ACK bits and the RI
come from the configuration, the higher-layer subband CQI report (a
wideband CQI of 1-15 and a CQI per subband) is drawn from the seed. The
transmitter draws the TB bits and complex AWGN of ``n0`` per resource
element of the received grid (an unnormalised FFT, so ``n0 / fft_size``
per sample) from one ``torch.Generator`` on the device, through the flat
channel ``h``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..frozen.models import pusch as pusch_mod
from ..frozen.models import ra
from ..frozen.models import uci as uci_mod
from ..frozen.utils.cell import Cell


def uci_payload(conf: dict, gen: torch.Generator) -> dict:
    """The UCI the grant carries: ``ack`` and ``ri`` from the
    configuration, ``cqi_bits`` a higher-layer subband report drawn from
    the host generator ``gen``."""
    nsb = uci_mod.cqi_nof_subbands(conf["nof_prb"])
    draws = torch.randint(0, 16, (nsb + 1,), generator=gen).tolist()
    wb = 1 + draws[0] % 15
    cqi = uci_mod.cqi_pack_hl_subband(wb, np.asarray(draws[1:]),
                                      conf["nof_prb"])
    return dict(ack=tuple(conf["ack"]), ri=conf["ri"],
                cqi_bits=tuple(int(b) for b in cqi))


def plan(conf: dict, payload: dict):
    """The configuration's PUSCH config and UCI plan, worked out from its
    numbers: -> (PuschConfig, UciPlan) of the frozen copy."""
    cell = Cell(nof_prb=conf["nof_prb"], nof_ports=1, id=conf["cell_id"])
    mod, tbs = ra.mcs_to_tbs(conf["mcs"], conf["n_prb"], dl=False)
    cfg = pusch_mod.PuschConfig(cell=cell, sf_idx=conf["sf_idx"],
                                rnti=conf["rnti"], mod=mod,
                                prb_start=conf["prb_start"],
                                n_prb=conf["n_prb"])
    data = pusch_mod.UciData(**payload)
    return cfg, pusch_mod.UciPlan(cfg, tbs, data,
                                  max_iterations=conf["max_iterations"])


def sc_fdma_mod(grid: torch.Tensor, nof_prb: int, fft: int) -> torch.Tensor:
    """grid [..., 14, 12 N_RB] -> samples [..., sf_len] (TS 36.211 5.6)."""
    nre = 12 * nof_prb
    bins = torch.as_tensor((np.arange(nre) - nre // 2) % fft,
                           device=grid.device)
    spec = grid.new_zeros((*grid.shape[:-1], fft))
    spec[..., bins] = grid
    half = torch.as_tensor(np.exp(1j * np.pi * np.arange(fft) / fft)
                           .astype(np.complex64), device=grid.device)
    sym = torch.fft.ifft(spec, dim=-1) * half              # [..., 14, fft]
    cp0, cp = 160 * fft // 2048, 144 * fft // 2048
    pieces = []
    for i in range(14):
        c = cp0 if i % 7 == 0 else cp
        # the prefix continues the symbol backwards: the half subcarrier
        # turns its sign over the N samples it reaches back
        pieces += [-sym[..., i, fft - c:], sym[..., i, :]]
    return torch.cat(pieces, dim=-1)


def transmit(conf: dict, traffic: dict, payload: dict, n: int,
             gen: torch.Generator, device) -> dict:
    """``n`` subframes drawn from ``gen`` -> dict(samples [n, sf_len]
    complex64 at the eNB antenna, tb [n, tbs] int8)."""
    cfg, pl = plan(conf, payload)
    cell = cfg.cell
    tb = torch.randint(0, 2, (n, pl.tbs), generator=gen, device=device,
                       dtype=torch.int8)
    grid = pusch_mod.pusch_encode_uci(tb, cfg, pl)
    x = sc_fdma_mod(grid, cell.nof_prb, cell.fft_size) * complex(*traffic["h"])
    noise = torch.randn(x.shape, generator=gen, device=device,
                        dtype=torch.complex64)          # unit power
    sigma = math.sqrt(traffic["n0"] / cell.fft_size)
    return dict(samples=x + sigma * noise, tb=tb)
