"""UE downlink receiver: FFT -> chest -> PCFICH -> PDCCH blind search ->
grant -> PDSCH decode.

Capability parity with lib/src/phy/ue/ue_dl.c (srslte_ue_dl_decode_rnti,
ue_dl.c:467-618): the receive path from time-domain subframe samples to
decoded transport blocks.

* ``ue_dl_decode`` decodes one subframe for one RNTI, resolving CFI and
  DCI grants on the host (formats 1, 1A, 1C and 2; every transmission
  mode; PHICH; HARQ softbuffers, on the float32 or the int8 LLR lane).
* ``ue_mib_acquire`` / ``ue_mib_decode`` read the MIB from a subframe-0
  capture at the cell's rate or at 1.92 Msps (ue_mib.c).
* ``ue_dl_tm4_batch`` is the batched no-genie 20 MHz 2x2 TM4 receiver —
  the chain of the JAX package's full-chain benchmark (bench.py
  ``bench_uedl(mimo=True)``): every stage runs once over the whole batch
  of subframes, with both DCI sizes blind-searched in one Viterbi batch
  each and both codewords in one turbo batch; ``ue_dl_tm2_batch`` is
  the same body on transmit diversity over 2 or 4 ports. On the card
  its fixed-shape stages replay from CUDA graphs (``runtime.graphs``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.chest import chest_dl_ports
from ..ops.equalizer import MimoType
from ..ops.modem import Mod
from ..ops.ofdm import ofdm_rx_sf
from ..runtime import graphs, trace
from ..utils.cell import Cell
from ..utils.device import as_samples
from . import dci as dci_mod
from . import ra
from .pbch import mib_unpack, pbch_decode
from .pcfich import pcfich_decode
from .pdcch import control_rx, pdcch_blind_decode
from .pdsch import PdschConfig, pdsch_decode
from .phich import phich_decode


@dataclass
class UeDlResult:
    """One subframe's decode outcome (per decoded grant)."""

    cfi: int
    dci: object | None = None
    tb_bits: np.ndarray | None = None
    crc_ok: bool = False
    noise_est: float = 0.0
    snr_db: float = 0.0          # wideband chest SNR (feeds CQI reports)
    cce: int = 0                 # first CCE of the grant's PDCCH
    cw: int = 0                  # codeword index (format 2 grants)
    #: UL HARQ indicator when one was expected this subframe (ul_harq.cc)
    phich_ack: bool | None = None


def estimate_channel(grid, cell: Cell, sf_idx: int):
    """Per-port channel estimates: grid [..., nsymb, nre] ->
    h [..., P, nsymb, nre] and the port-0 pilot noise estimate [...]."""
    h, noise = chest_dl_ports(grid, cell, sf_idx, range(cell.nof_ports))
    return h, noise[..., 0]


def ue_dl_decode(samples, cell: Cell, sf_idx: int, rnti: int,
                 mimo: MimoType = MimoType.SINGLE,
                 max_iterations: int = 5,
                 harq_state: dict | None = None,
                 phich: tuple[int, int] | None = None,
                 llr_int8: bool = False) -> list[UeDlResult]:
    """Decode one subframe for one RNTI (single rx antenna).

    samples [sf_sample_len] complex64 (on the device to decode on) ->
    list of per-grant results.

    ``harq_state``: caller-owned dict pid -> {"ndi", "soft"} carrying
    per-process softbuffers across retransmissions (srsue dl_harq.cc +
    softbuffer.c): an un-toggled NDI reuses the combined LLRs, a CRC
    failure stores them back. Common RNTIs keep no HARQ state.
    ``phich``: (group, seq) of an expected UL HARQ indicator
    (srslte_ue_dl_decode_phich, ue_dl.c:934) -> every result carries
    ``phich_ack``.
    ``llr_int8``: decode the PDSCH on the 8-bit LLR lane (byte demod
    scales, int8 de-rate-matching and int8 softbuffers).
    SI/P/RA-RNTIs search formats 1A and 1C (1A sized by N_prb_1A), other
    RNTIs 1A, 1 and, on cells of 2 or more ports, 2. ``mimo`` is the
    scheme of format 1/1A/1C grants; their PDSCH sees all the cell's
    ports.
    """
    grid = ofdm_rx_sf(samples[None], cell)                 # [1, S, K]
    h, n0 = estimate_channel(grid, cell, sf_idx)           # [1, P, S, K]
    noise = float(n0[0])
    h_ctrl = h[0] if cell.nof_ports >= 2 else h[0, 0]
    cfi = int(pcfich_decode(grid, h, cell, sf_idx, noise_est=noise)[0][0])
    hpow = float(torch.mean(h[0].abs() ** 2))
    snr_db = float(10.0 * np.log10(max(hpow, 1e-12) / max(noise, 1e-12)))

    phich_ack = None
    if phich is not None:
        ack, _ = phich_decode(grid, h_ctrl[None], cell, sf_idx,
                              group=phich[0], seq_idx=phich[1],
                              noise_est=noise)
        phich_ack = bool(ack[0])

    # common search space RNTIs monitor formats 1A and 1C (ue_dl.c)
    common_ss = rnti in (0xFFFF, 0xFFFE) or 1 <= rnti <= 0x3C
    sizes = (dci_mod.format0_1a_size(cell.nof_prb),
             dci_mod.format1_size(cell.nof_prb))
    if common_ss:
        sizes = sizes + (dci_mod.format1c_size(cell.nof_prb),)
    f2_size = None
    if cell.nof_ports >= 2 and not common_ss:
        f2_size = dci_mod.format2_size(cell.nof_prb)
        sizes = sizes + (f2_size,)
    hits = pdcch_blind_decode(grid[0], h_ctrl, cell, cfi, sf_idx, rnti,
                              sizes, noise_est=noise)

    grid_a = grid[:, None]                                 # [1, A=1, S, K]
    h_a = h[:, None]                                       # [1, 1, P, S, K]
    results: list[UeDlResult] = []
    common = dict(cfi=cfi, noise_est=noise, snr_db=snr_db)
    for hit in hits:
        d = None
        if len(hit.payload) == sizes[0]:
            d = dci_mod.unpack_format1a(hit.payload, cell.nof_prb)
            if d is None:
                d_ul = dci_mod.unpack_format0(hit.payload, cell.nof_prb)
                if d_ul is not None:
                    results.append(UeDlResult(dci=d_ul, cce=hit.cce,
                                              **common))
                continue
        elif len(hit.payload) == sizes[1]:
            d = dci_mod.unpack_format1(hit.payload, cell.nof_prb)
        elif common_ss and len(hit.payload) == sizes[2]:
            d1c = dci_mod.unpack_format1c(hit.payload, cell.nof_prb)
            if d1c is None:
                continue
            tbs = int(ra.tbs_format1c_table()[d1c.i_tbs])
            cfg = PdschConfig(cell=cell, sf_idx=sf_idx, cfi=cfi, rnti=rnti,
                              mod=Mod.QPSK, mimo=mimo,
                              prb_mask=d1c.prb_mask,
                              prb_mask_slot1=d1c.prb_mask_slot1,
                              llr_int8=llr_int8)
            plan = cfg.plan(tbs, rv=0, max_iterations=max_iterations)
            bits, ok, _ = pdsch_decode(grid_a, h_a, cfg, plan,
                                       noise_est=noise)
            results.append(UeDlResult(
                dci=d1c, tb_bits=bits[0].cpu().numpy(), crc_ok=bool(ok[0]),
                cce=hit.cce, **common))
            continue
        if f2_size is not None and len(hit.payload) == f2_size:
            d2 = dci_mod.unpack_format2(hit.payload, cell.nof_prb)
            if d2 is None:
                continue
            try:
                mod2, tbs0 = ra.mcs_to_tbs(d2.mcs[0], d2.n_prb)
                _, tbs1 = ra.mcs_to_tbs(d2.mcs[1], d2.n_prb)
            except ValueError:
                continue     # reserved MCS: a false-positive blind decode
            cfg = PdschConfig(cell=cell, sf_idx=sf_idx, cfi=cfi, rnti=rnti,
                              mod=mod2, mimo=MimoType.SPATIAL_MUX,
                              nof_layers=2, nof_codewords=2, pmi=d2.pmi,
                              prb_mask=d2.prb_mask, llr_int8=llr_int8)
            plan0 = cfg.plan(tbs0, rv=d2.rv[0], max_iterations=max_iterations)
            plan1 = cfg.plan(tbs1, rv=d2.rv[1], max_iterations=max_iterations)
            bits2, ok2, _ = pdsch_decode(grid_a, h_a, cfg, plan0,
                                         noise_est=noise, plan2=plan1)
            for cw in range(2):
                results.append(UeDlResult(
                    dci=d2, tb_bits=bits2[cw][0].cpu().numpy(),
                    crc_ok=bool(ok2[cw][0]), cce=hit.cce, cw=cw, **common))
            continue
        if d is None:
            continue
        try:
            if common_ss and d.format == "1A":
                # SI/P/RA-RNTI 1A grants size the TBS with N_prb_1A from
                # the TPC LSB, not the allocation (36.212 5.3.3.1.3)
                mod, tbs = Mod.QPSK, ra.mcs_to_tbs(d.mcs, d.n_prb_1a)[1]
            else:
                mod, tbs = ra.mcs_to_tbs(d.mcs, d.n_prb)
        except ValueError:
            continue         # reserved MCS / empty allocation
        cfg = PdschConfig(cell=cell, sf_idx=sf_idx, cfi=cfi, rnti=rnti,
                          mod=mod, mimo=mimo, prb_mask=d.prb_mask,
                          llr_int8=llr_int8)
        plan = cfg.plan(tbs, rv=d.rv, max_iterations=max_iterations)
        soft_in, hst = None, None
        if harq_state is not None and not common_ss:
            hst = harq_state.setdefault(d.harq_pid,
                                        {"ndi": None, "soft": None})
            if hst["ndi"] == d.ndi and hst["soft"] is not None:
                soft_in = hst["soft"]      # retransmission: combine
            else:
                hst["ndi"] = d.ndi
                hst["soft"] = None
        bits, ok, new_soft = pdsch_decode(grid_a, h_a, cfg, plan,
                                          noise_est=noise,
                                          softbuffers=soft_in)
        ok_b = bool(ok[0])
        if hst is not None:
            hst["soft"] = None if ok_b else list(new_soft)
        results.append(UeDlResult(dci=d, tb_bits=bits[0].cpu().numpy(),
                                  crc_ok=ok_b, cce=hit.cce, **common))
    if not results:
        results.append(UeDlResult(**common))
    for r in results:
        r.phich_ack = phich_ack
    return results


def _mib_result(bits, q, ports, ok) -> dict | None:
    if not bool(ok[0]):
        return None
    mib = mib_unpack(bits[0].cpu().numpy())
    mib["sfn_mod4"] = int(q[0])
    mib["nof_ports"] = int(ports[0])
    return mib


def ue_mib_acquire(samples, cell_geom: Cell, cell_id: int, *,
                   device=None) -> dict | None:
    """MIB from a full-rate subframe-0 capture [sf_sample_len]: FFT at the
    receiver's geometry, the central 6 PRB (72 subcarriers), CRS channel
    estimate of a 6-PRB 1-port cell, blind PBCH decode with the port-0
    channel (ue_mib.c runs at 1.92 Msps; after the FFT the central 72
    subcarriers are the same). -> dict(nof_prb, phich_dur, phich_res,
    sfn_msb, sfn_mod4, nof_ports, sfn), or None when no hypothesis
    passes its CRC."""
    samples = as_samples(samples, device)
    cell6 = Cell(nof_prb=6, id=cell_id, nof_ports=1)
    grid = ofdm_rx_sf(samples[None], cell_geom)[0]
    mid = cell_geom.nof_re // 2
    g6 = grid[..., mid - 36:mid + 36]
    h, n0 = estimate_channel(g6[None], cell6, 0)
    mib = _mib_result(*pbch_decode(g6[None], h[0, 0][None], cell6,
                                   noise_est=n0[0]))
    if mib is not None:
        mib["sfn"] = (mib["sfn_msb"] << 2) | mib["sfn_mod4"]
    return mib


def ue_mib_decode(samples, cell_id: int, *, device=None) -> dict | None:
    """MIB from a subframe-0 capture at 1.92 Msps (ue_mib.c): CRS channel
    estimate on the 6-PRB grid, blind PBCH decode. -> the dict of
    ``ue_mib_acquire`` without ``sfn``, or None."""
    samples = as_samples(samples, device)
    cell = Cell(nof_prb=6, id=cell_id, nof_ports=1)
    grid = ofdm_rx_sf(samples[None], cell)[0]
    h, n0 = estimate_channel(grid[None], cell, 0)
    return _mib_result(*pbch_decode(grid[None], h[0, 0][None], cell,
                                    noise_est=n0[0]))


@dataclass
class DlBatchResult:
    """Per-subframe outcome of a batched downlink receiver call
    (``ue_dl_tm4_batch``, ``ue_dl_tm2_batch``)."""

    cfi: torch.Tensor            # [B] decoded CFI
    dci_hits: torch.Tensor       # [B] CRC16-RNTI passes over both sizes
    tb_bits: tuple               # per codeword [B, tbs] int8
    crc_ok: tuple                # per codeword [B] bool
    iterations: list             # turbo iteration count per turbo call


#: the name the TM4 entry's callers know its result by
Tm4BatchResult = DlBatchResult


#: the batched receivers' stage chains on the card, by configuration,
#: plan and batch (``runtime.graphs.Stages``)
_CHAINS: dict = {}


def _chain(samples, cfg: PdschConfig, plan):
    """The stages of a batched call on ``samples``: on the card the chain
    of its configuration, plan and batch (captured on its first call),
    else ``EAGER``."""
    if samples.device.type != "cuda":
        return graphs.EAGER
    key = (cfg, plan, samples.shape, samples.dtype, samples.device)
    return _CHAINS.setdefault(key, graphs.Stages()).start()


def _chest_noise(grid, cell: Cell, sf_idx: int):
    """-> (h [B, rx, port, S, K] of every CRS port, the rx-0, port-0
    noise estimate [B])."""
    h, noise = chest_dl_ports(grid, cell, sf_idx,
                              tuple(range(cell.nof_ports)))
    return h, torch.clamp(noise[:, 0, 0], min=1e-7)


def _ue_dl_batch(root: str, samples, cfg: PdschConfig, plan,
                 stages=None) -> DlBatchResult:
    """The batched receiver's one body, under the root range ``root``:
    every stage once over the batch, on the configuration's ports
    (``cfg.cell.nof_ports``) and codewords (``cfg.nof_codewords``, the
    two in one DL-SCH decode). The stages before the first host read and
    the DL-SCH's CRCs and reassembly run through ``stages`` (by default
    ``_chain``'s: on the card replayed from CUDA graphs)."""
    if stages is None:
        stages = _chain(samples, cfg, plan)
    with trace.root(root, samples.device):
        cell, sf_idx, cfi = cfg.cell, cfg.sf_idx, cfg.cfi
        grid = stages("ue_dl.ofdm_rx", ofdm_rx_sf, samples,
                      cell)                                # [B, rx, S, K]
        h, n0 = stages("ue_dl.chest_noise", _chest_noise, grid, cell, sf_idx)
        # rx 0's PCFICH and PDCCH (ranges ue_dl.pdcch_llr and
        # ue_dl.pdcch_blind_search: one kernel launch each on the card)
        cfi_hat, n_det = control_rx(
            grid[:, 0], h[:, 0], cell, cfi, sf_idx, cfg.rnti,
            tuple(sorted({dci_mod.format1_size(cell.nof_prb),
                          dci_mod.format0_1a_size(cell.nof_prb)})), n0,
            stages=stages)
        iters: list = []
        two = cfg.nof_codewords == 2
        bits, ok, _ = pdsch_decode(
            grid, h, cfg, plan, noise_est=n0[:, None],
            plan2=plan if two else None, iters_out=iters, stages=stages)
        if not two:
            bits, ok = (bits,), (ok,)
        return DlBatchResult(stages.keep(cfi_hat), stages.keep(n_det),
                             tuple(bits), tuple(ok), iters)


def ue_dl_tm4_batch(samples, cfg: PdschConfig, plan) -> DlBatchResult:
    """The no-genie 2x2 TM4 receiver over a batch of subframes.

    samples [B, rx=2, sf_len] complex64 -> OFDM FFT -> CRS channel
    estimate per (rx, port) and pilot noise estimate on rx 0 (one
    ``chest_dl_ports``: one kernel launch on the card) -> PCFICH on
    rx 0 (SFBC) and the PDCCH LLRs of the whole region (SFBC) -> blind
    search of every candidate for both monitored DCI sizes (formats 1A
    and 1), CRC16 with the RNTI mask (``pdcch.control_rx``: two kernel
    launches on the card) -> 2x2 MMSE PDSCH decode of both codewords
    (one DL-SCH decode, both codewords stacked).

    The whole call runs in the range ``ue_dl.tm4_batch`` (its self time
    is the receiver's glue), each stage in a range named ``ue_dl.<stage>``
    (the PCFICH with the PDCCH LLRs in ``ue_dl.pdcch_llr``,
    ``pdsch.eq_demod`` and ``dlsch.*`` inside the PDSCH decode, and
    ``turbo.stop_read`` around each early-stop read), all through
    ``runtime.trace``: ``profile_main_path`` and the benchmark read them
    from one ``torch.profiler`` trace.
    """
    return _ue_dl_batch("ue_dl.tm4_batch", samples, cfg, plan)


def ue_dl_tm2_batch(samples, cfg: PdschConfig, plan) -> DlBatchResult:
    """The no-genie transmit-diversity (TM2) receiver over a batch of
    subframes: ``ue_dl_tm4_batch``'s stages on the cell's 2 or 4 ports
    and one codeword, combined by SFBC or SFBC-FSTD (``cfg.mimo``
    ``DIVERSITY``; 36.211 6.3.4.3), its E split on N_L 2 (36.212
    5.1.4.1.2). The whole call runs in the root range ``ue_dl.tm2_batch``
    and its stages in the ranges ``ue_dl_tm4_batch`` names.
    """
    return _ue_dl_batch("ue_dl.tm2_batch", samples, cfg, plan)
