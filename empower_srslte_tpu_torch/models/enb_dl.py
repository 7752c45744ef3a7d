"""eNB downlink subframe composition, and the test transmitters.

Capability parity with lib/src/phy/enb/enb_dl.c: an empty grid with the
CRS placed (put_base, enb_dl.c:323-388), the control and shared channels
added by their own modules, then iFFT to time-domain samples (gen_signal,
enb_dl.c:389). Batched: every function takes/returns leading batch dims.

``enb_dl_tx_batch`` is the eNB's batched downlink transmitter: a batch of
subframes of one grant, from TBs to the antenna ports' samples, through
``enb_dl_compose``, the one composer, which ``enb_dl_subframe`` runs at
batch 1.

``tm4_stimulus`` builds the main path's receive samples: a batch of
20 MHz 2x2 TM4 two-codeword subframes with PCFICH, one DCI and PDSCH,
through a per-subframe 2x2 channel and AWGN — the same construction and
the same numpy random draws as the JAX package's full-chain UE receiver
benchmark (bench.py ``bench_uedl(mimo=True)``). ``enb_dl_subframe``
composes one subframe of any cell; ``genie_stimulus`` builds PDSCH batches
through a genie channel (the benchmark's "20mimo" construction) and
``tm2_frame_stimulus`` a radio frame of a 4-port TM2 cell with PHICH, a
format 1C grant and a HARQ retransmission. ``put_sync_signals`` places
PSS/SSS (the composers leave them out; the acquisition stimuli add them):
``cold_boot_stimulus`` builds a UE's first 26 subframes of a cell as raw
IQ (timing, CFO, noise), ``pbch_batch_stimulus`` subframe-0 grids of a
2-port PBCH, and ``one_rx_tm4_stimulus`` a format-2 subframe at a
one-antenna UE.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.ofdm import ofdm_tx_sf
from ..runtime import graphs, trace
from ..utils.cell import Cell
from ..utils.device import device_table, host_ints, resolve_device
from . import ra
from .refsignal import crs_pilots


@functools.lru_cache(maxsize=256)
def _crs_scatter(cell: Cell, sf_idx: int):
    """Per-port flat indices + values for CRS insertion."""
    out = []
    ports = {1: (0,), 2: (0, 1), 4: (0, 1, 2, 3)}[cell.nof_ports]
    for p in ports:
        idx, syms, vals = crs_pilots(cell, sf_idx, p)
        flat = (syms[:, None] * cell.nof_re + idx).reshape(-1)
        out.append((flat.astype(np.int64), vals.reshape(-1)))
    return out


def put_crs(grid, cell: Cell, sf_idx: int):
    """Insert CRS for all ports: grid [..., P, nsymb, nre] -> new grid."""
    out = grid.clone()
    flat = out.view(*grid.shape[:-2], -1)
    for p, (idx, vals) in enumerate(_crs_scatter(cell, sf_idx)):
        if p >= grid.shape[-3]:
            break
        key = ("crs", cell, sf_idx, p)
        flat[..., p, device_table(key + ("i",), grid.device,
                                  lambda: idx)] = \
            device_table(key + ("v",), grid.device, lambda: vals)
    return out


def put_sync_signals(grid, cell: Cell, sf_idx: int):
    """Insert PSS (last symbol of slot 0) and SSS (the one before) on port
    0 in subframes 0 and 5 (enb_dl.c put_base; 36.211 6.11), FDD:
    grid [..., P, nsymb, nre] -> new grid."""
    if sf_idx not in (0, 5):
        return grid
    from ..ops.sync import pss_freq, sss_freq, sync_re_indices

    nre, nsym = cell.nof_re, cell.nsymb_slot
    k = sync_re_indices(cell)
    out = grid.clone()
    flat = out.view(*grid.shape[:-2], -1)
    for sym, key, build in (
            (nsym - 1, ("pss", cell.n_id_2), lambda: pss_freq(cell.n_id_2)),
            (nsym - 2, ("sss", cell.n_id_1, cell.n_id_2, sf_idx),
             lambda: sss_freq(cell.n_id_1, cell.n_id_2, sf_idx))):
        idx = device_table(("sync_re", nre, sym), grid.device,
                           lambda sym=sym: sym * nre + k)
        flat[..., 0, idx] = device_table(key, grid.device, build)
    return out


def enb_dl_base_grid(cell: Cell, sf_idx: int, batch_shape=(), device=None):
    """Empty per-port grid with CRS placed (put_base analog)."""
    grid = torch.zeros((*batch_shape, cell.nof_ports, cell.nsymb_sf,
                        cell.nof_re), dtype=torch.complex64,
                       device=resolve_device(device))
    return put_crs(grid, cell, sf_idx)


def enb_dl_gen_signal(grid, cell: Cell):
    """Per-port grids -> time samples [..., P, sf_sample_len]
    (srslte_enb_dl_gen_signal, enb_dl.c:389)."""
    return ofdm_tx_sf(grid, cell)


#: the main path's stimulus: 20 MHz, MCS 25 (64QAM, TBS 57336), cfi 1,
#: AWGN at 30 dB of the mean signal power, numpy draws from seed 7
TM4_NOF_PRB, TM4_MCS, TM4_CFI, TM4_SNR_DB, TM4_SEED = 100, 25, 1, 30.0, 7


def enb_dl_tm4(tb, tb2, h2, noise, cfg, plan, dci_bits, dci_cce: int,
               dci_l: int):
    """2x2 TM4 subframes through a per-subframe channel plus AWGN.

    tb, tb2 [B, tbs] 0/1; h2 [B, rx, port] complex64 flat channel;
    noise [B, rx, sf_len] complex64 unit-variance-per-component draws;
    dci_bits [size] 0/1. Returns samples [B, rx, sf_len] complex64:
    base grid + PCFICH + PDCCH + PDSCH, mixed by h2 in the frequency
    domain, iFFT per antenna, AWGN at ``TM4_SNR_DB`` of the mean
    power.
    """
    from .pcfich import pcfich_put
    from .pdcch import pdcch_encode
    from .pdsch import pdsch_encode

    cell, sf_idx, cfi = cfg.cell, cfg.sf_idx, cfg.cfi
    grid = enb_dl_base_grid(cell, sf_idx, batch_shape=(tb.shape[0],),
                            device=tb.device)
    grid = pcfich_put(grid, cfi, cell, sf_idx)
    grid = grid + pdcch_encode(dci_bits, cfg.rnti, dci_cce, dci_l, cell,
                               cfi, sf_idx)
    grid = grid + pdsch_encode(tb, cfg, plan, tb2, plan)
    grid = torch.einsum("brp,bpsk->brsk", h2, grid)
    samples = enb_dl_gen_signal(grid, cell)
    p_sig = torch.mean(samples.abs() ** 2)
    sigma = torch.sqrt(p_sig * 10 ** (-TM4_SNR_DB / 10) / 2)
    return samples + sigma * noise


def tm4_draws(batch: int, tbs: int, dci_size: int, sf_len: int) -> dict:
    """The stimulus' random draws (numpy), in the JAX benchmark's order:
    DCI bits, both TBs, channel phases (a well-conditioned diagonal-
    dominant 2x2: unit diagonal, 0.35 off-diagonal, random phases), then
    the real and imaginary noise [batch, 2, sf_len]."""
    rng = np.random.default_rng(TM4_SEED)
    dci_bits = rng.integers(0, 2, dci_size).astype(np.int8)
    tb = rng.integers(0, 2, size=(batch, tbs)).astype(np.int8)
    tb2 = rng.integers(0, 2, size=(batch, tbs)).astype(np.int8)
    ph = rng.uniform(0, 2 * np.pi, size=(batch, 2, 2))
    mag = np.where(np.eye(2, dtype=bool)[None], 1.0, 0.35)
    h2 = (mag * np.exp(1j * ph)).astype(np.complex64)
    nshape = (batch, 2, sf_len)
    nz_re = rng.normal(size=nshape).astype(np.float32)
    nz_im = rng.normal(size=nshape).astype(np.float32)
    return dict(dci_bits=dci_bits, tb=tb, tb2=tb2, h2=h2, nz_re=nz_re,
                nz_im=nz_im)


@dataclass
class Tm4Stimulus:
    """The main path's input and what it must decode to."""

    cfg: object                  # PdschConfig (cell, sf_idx, cfi, RNTI)
    plan: object                 # DlschPlan (both codewords)
    samples: torch.Tensor        # [B, rx, sf_len] complex64
    tb: torch.Tensor             # [B, tbs] int8, codeword 0
    tb2: torch.Tensor            # [B, tbs] int8, codeword 1


def tm4_stimulus(batch: int, *, device=None) -> Tm4Stimulus:
    """Build ``batch`` 2x2 TM4 two-codeword subframes (cell id 1, sf_idx 1,
    RNTI 0x1234, one format-1 DCI at L=4, CCE 0) at the ``TM4_*``
    settings, drawing bits, channel and noise in the JAX benchmark's
    order."""
    from .dci import format1_size
    from .pdsch import PdschConfig
    from ..ops.equalizer import MimoType

    dev = resolve_device(device)
    sf_idx, rnti = 1, 0x1234
    cell = Cell(nof_prb=TM4_NOF_PRB, nof_ports=2, id=1)
    mod, tbs = ra.mcs_to_tbs(TM4_MCS, TM4_NOF_PRB)
    cfg = PdschConfig(cell=cell, sf_idx=sf_idx, cfi=TM4_CFI, rnti=rnti,
                      mod=mod, mimo=MimoType.SPATIAL_MUX, nof_layers=2,
                      nof_codewords=2)
    plan = cfg.plan(tbs)
    d = tm4_draws(batch, tbs, format1_size(TM4_NOF_PRB), cell.sf_sample_len)
    noise = torch.complex(torch.as_tensor(d["nz_re"], device=dev),
                          torch.as_tensor(d["nz_im"], device=dev))
    del d["nz_re"], d["nz_im"]
    tb_t = torch.as_tensor(d["tb"], device=dev)
    tb2_t = torch.as_tensor(d["tb2"], device=dev)
    samples = enb_dl_tm4(tb_t, tb2_t, torch.as_tensor(d["h2"], device=dev),
                         noise, cfg, plan,
                         torch.as_tensor(d["dci_bits"], device=dev), 0, 4)
    return Tm4Stimulus(cfg, plan, samples, tb_t, tb2_t)


def enb_dl_compose(cell: Cell, sf_idx: int, cfi: int, batch: int, *,
                   dcis=(), phichs=(), pdschs=(), device=None,
                   stages=graphs.EAGER):
    """``batch`` subframes' per-port grids [batch, P, nsymb, nre], in
    enb_dl.c's order (put_base, put_pcfich, put_phich, put_pdcch_dl /
    put_pdcch_ul, put_pdsch): CRS, the CFI, each HI of ``phichs`` as
    (ack, group, seq) and each DCI of ``dcis`` as (bits, rnti, cce, L),
    the same in every subframe, in the range ``enb_dl.control_tx`` (a
    stage of ``stages``); then each PDSCH of ``pdschs`` as (tb [batch,
    tbs], PdschConfig, DlschPlan, tb2 [batch, tbs] or None), written onto
    the ports its scheme uses (``pdsch_encode``'s ``dlsch.*`` and
    ``pdsch.map`` ranges). On the card the control region reads nothing
    back to the host: the HIs' and DCIs' values go to the card in one
    copy a call from pinned memory, its tables are uploaded once, and
    every DCI goes into one launch of the PDCCH kernel
    (``pdcch_encode_at``)."""
    from .pdsch import pdsch_encode

    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:  # the bits name the card
        dev = torch.device("cuda", torch.cuda.current_device())
    bits, values = _control_values(cell, cfi, dcis, phichs, dev)
    grid = stages("enb_dl.control_tx", _control_region, cell, sf_idx, cfi,
                  batch, len(phichs), dev, values, *bits)
    for tb, cfg, plan, tb2 in pdschs:
        pdsch_encode(tb, cfg, plan, tb2, None if tb2 is None else plan,
                     grid=grid)
    return grid


def _control_values(cell: Cell, cfi: int, dcis, phichs, device):
    """The control region's per-call values, checked: -> (each DCI's bits
    on ``device``, int32 [HIs + DCIs, 3] on the host (``host_ints``):
    each HI's (ack, group, seq), then each DCI's (rnti, cce, L))."""
    from .pdcch import tx_dcis
    from .phich import NSF
    from .regs import nof_phich_groups

    n_group = nof_phich_groups(cell, 1.0)
    for ack, group, seq in phichs:
        if ack not in (0, 1) or not 0 <= group < n_group \
                or not 0 <= seq < 2 * NSF:
            raise ValueError(f"HI {(ack, group, seq)}: ack 0 or 1, group "
                             f"below {n_group}, sequence below {2 * NSF}")
    dcis = tx_dcis([(b if isinstance(b, torch.Tensor) and b.device == device
                     else torch.as_tensor(b, device=device), *at)
                    for b, *at in dcis], cell, cfi, (), device)
    return ([b for b, *_ in dcis],
            host_ints([*phichs, *(at for _, *at in dcis)], device))


def _control_region(cell: Cell, sf_idx: int, cfi: int, batch: int,
                    n_hi: int, device, values, *bits):
    """``enb_dl_compose``'s control region [batch, P, nsymb, nre] on
    ``device``, of the ``_control_values`` ``values`` (copied there with
    no wait, if a chain has not) and ``bits``, which it reads there."""
    from .pcfich import pcfich_put
    from .pdcch import pdcch_encode_at
    from .phich import phich_put

    values = values.to(device, non_blocking=True)
    grid = pcfich_put(enb_dl_base_grid(cell, sf_idx, (1,), device), cfi,
                      cell, sf_idx)
    for hi in values[:n_hi]:
        grid = phich_put(grid, hi[0:1], cell, sf_idx, hi[1:2], hi[2:3])
    pdcch_encode_at(grid, list(bits), values[n_hi:], cell, cfi, sf_idx)
    return grid.expand(batch, -1, -1, -1).contiguous()


#: the batched transmitter's control-range chains on the card, by cell,
#: subframe, CFI, batch, the number of HIs and the DCIs' sizes and types
#: (``runtime.graphs.Stages``)
_CHAINS: dict = {}


def _control_chain(cell: Cell, sf_idx: int, cfi: int, batch: int, dcis,
                   phichs, device):
    """The control range of a batched call: on the card the chain of its
    shapes (captured on its first call; every call copies its HIs' and
    DCIs' values and bits into the chain's buffers, so a chain serves any
    RNTIs, CCEs, levels, ACKs and PHICH resources), else ``EAGER``."""
    if device.type != "cuda":
        return graphs.EAGER
    key = (cell, sf_idx, cfi, batch, len(phichs),
           tuple((np.shape(b), str(getattr(b, "dtype", None)))
                 for b, *_ in dcis), device)
    return _CHAINS.setdefault(key, graphs.Stages(device)).start()


def enb_dl_tx_batch(tb, cfg, plan, *, tb2=None, dcis=(), phichs=()):
    """The eNB's downlink transmitter over a batch of subframes of one
    grant: tb (and tb2, the second codeword's) [B, tbs] 0/1 -> the antenna
    ports' samples [B, ports, sf_len] complex64.

    ``cfg`` (PdschConfig) gives the cell, subframe, CFI and the PDSCH's
    scheme, ``plan`` (DlschPlan) each codeword's DL-SCH; ``dcis`` (bits,
    rnti, cce, L) and ``phichs`` (ack, group, seq) are one a call, the
    same in every subframe. The call runs ``enb_dl_compose`` then
    ``enb_dl_gen_signal`` in the range ``enb_dl.tx_batch`` (its self time
    is the transmitter's glue); its stages in ``enb_dl.control_tx`` (on
    the card replayed from a CUDA graph, ``_control_chain``),
    ``dlsch.crc_attach``, ``dlsch.turbo_encode``, ``dlsch.rate_match``,
    ``pdsch.map`` and ``enb_dl.ofdm_tx``."""
    with trace.root("enb_dl.tx_batch", tb.device):
        cell, batch = cfg.cell, tb.shape[0]
        grid = enb_dl_compose(
            cell, cfg.sf_idx, cfg.cfi, batch, dcis=dcis, phichs=phichs,
            pdschs=[(tb, cfg, plan, tb2)], device=tb.device,
            stages=_control_chain(cell, cfg.sf_idx, cfg.cfi, batch, dcis,
                                  phichs, tb.device))
        with trace.span("enb_dl.ofdm_tx"):
            return enb_dl_gen_signal(grid, cfg.cell)


def enb_dl_subframe(cell: Cell, sf_idx: int, cfi: int, *, dcis=(),
                    phichs=(), pdschs=(), device=None):
    """One subframe's per-port grid [P, nsymb, nre]: ``enb_dl_compose`` at
    batch 1, each PDSCH of ``pdschs`` as (tb_bits [tbs], PdschConfig,
    DlschPlan) of one codeword."""
    dev = resolve_device(device)
    return enb_dl_compose(
        cell, sf_idx, cfi, 1, dcis=dcis, phichs=phichs,
        pdschs=[(torch.as_tensor(tb, device=dev)[None], cfg, plan, None)
                for tb, cfg, plan in pdschs], device=dev)[0]


@dataclass
class GenieStimulus:
    """A genie-channel PDSCH batch: what ``pdsch_decode`` receives, with
    the channel it is given, and the TBs it must decode to."""

    cfg: object                  # PdschConfig
    plan: object                 # DlschPlan (every codeword)
    y: torch.Tensor              # [B, rx, nsymb, nre] complex64
    h: torch.Tensor              # [B, rx, P, nsymb, nre] complex64
    tbs: list                    # per codeword [B, tbs] int8
    n0: float                    # noise per received RE


def genie_stimulus(cfg, plan, batch: int, n0: float, *, seed: int = 0,
                   device=None) -> GenieStimulus:
    """``batch`` PDSCH subframes of ``cfg`` (one TB per codeword) through
    an i.i.d. complex normal channel h [B, rx=2, port, nsymb, nre] (unit
    variance per component) plus AWGN of ``n0`` per RE: the construction
    of the JAX package's "20mimo" receiver benchmark (bench.py:160-172).
    For TM2 (``MimoType.DIVERSITY``) h is drawn once per (PRB, symbol) and
    held over the PRB's 12 subcarriers: SFBC combines a pair (a quad with
    SFBC-FSTD) of REs under one channel, which an i.i.d.-per-RE draw would
    break. TB bits, h and noise are drawn on the device from ``seed``."""
    from .pdsch import pdsch_encode
    from ..ops.equalizer import MimoType

    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    cell = cfg.cell
    tbs = [torch.randint(0, 2, (batch, plan.tbs), generator=g, device=dev,
                         dtype=torch.int8)
           for _ in range(cfg.nof_codewords)]
    extra = (tbs[1], plan) if cfg.nof_codewords == 2 else ()
    ports = pdsch_encode(tbs[0], cfg, plan, *extra)     # [B, P, S, K]

    def cn(*shape):
        return torch.complex(torch.randn(shape, generator=g, device=dev),
                             torch.randn(shape, generator=g, device=dev))

    n_rx, n_tx = 2, ports.shape[1]
    if cfg.mimo is MimoType.DIVERSITY:
        h = torch.repeat_interleave(
            cn(batch, n_rx, n_tx, cell.nsymb_sf, cell.nof_prb), 12, dim=-1)
    else:
        h = cn(batch, n_rx, n_tx, cell.nsymb_sf, cell.nof_re)
    y = torch.einsum("brpsk,bpsk->brsk", h, ports) \
        + float(np.sqrt(n0 / 2)) * cn(batch, n_rx, cell.nsymb_sf,
                                      cell.nof_re)
    return GenieStimulus(cfg, plan, y, h, tbs, n0)


#: the 4-port TM2 frame: Cell(100 PRB, 4 ports, id 1), cfi 2, C-RNTI
#: 0x1234 with a format 1 grant (MCS 16) on SFBC-FSTD in every subframe,
#: an SI-RNTI format 1C grant (i_tbs 9, 4 PRB) in sf 5, one PHICH; SNR
#: 25 dB, the HARQ pair (sf 2 rv 0, sf 3 rv 2) at FRAME_HARQ_SNR_DB
FRAME_NOF_PRB, FRAME_CFI, FRAME_MCS, FRAME_SEED = 100, 2, 16, 11
FRAME_SNR_DB, FRAME_SI_SF, FRAME_HARQ_SFS = 25.0, 5, (2, 3)
#: per-subframe SNR of the HARQ pair: the rv 0 copy alone fails on the
#: int8 lane, the two combined decode (chosen on the CPU with the port)
FRAME_HARQ_SNR_DB = 5.0
#: flat per-port gains of the one rx antenna's channel
FRAME_GAINS = (0.9 + 0.3j, -0.4 + 0.8j, 0.7 - 0.6j, 0.2 + 0.9j)
#: the UL allocation whose PHICH the UE expects (lowest PRB)
FRAME_UL_PRB_START = 8


@dataclass
class DlFrame:
    """Ten subframes of the TM2 frame and what each must decode to."""

    cell: Cell
    rnti: int
    samples: torch.Tensor        # [10, sf_len] complex64, one rx antenna
    tb: list                     # per subframe [tbs] int8 (C-RNTI grant)
    si_tb: torch.Tensor          # [tbs] int8 (SI-RNTI grant, FRAME_SI_SF)
    phich: tuple                 # (group, seq) of the expected PHICH
    acks: list                   # per subframe the PHICH bit sent
    snr_db: list                 # per subframe


def tm2_frame_stimulus(*, device=None) -> DlFrame:
    """A radio frame (sf 0-9) of the 4-port TM2 cell at the ``FRAME_*``
    settings as time samples at one rx antenna. Every subframe carries
    PCFICH, the C-RNTI's format 1 grant (HARQ process sf % 8; sf 3
    retransmits sf 2's TB with rv 2 under its process and NDI) and a
    PHICH; sf 5 also carries an SI-RNTI format 1C grant, whose PRBs the
    C-RNTI's allocation leaves free in every subframe. Bits and noise are
    numpy draws from ``FRAME_SEED``."""
    from . import dci as dci_mod
    from .pdcch import ue_search_candidates
    from .pdsch import PdschConfig
    from .phich import phich_resource
    from .regs import pdcch_nof_cces
    from ..ops.equalizer import MimoType
    from ..ops.modem import Mod

    dev = resolve_device(device)
    rng = np.random.default_rng(FRAME_SEED)
    cell = Cell(nof_prb=FRAME_NOF_PRB, nof_ports=4, id=1)
    rnti, si_rnti, cfi = 0x1234, 0xFFFF, FRAME_CFI
    n_cce = pdcch_nof_cces(cell, cfi)
    step = ra.type2_n_rb_step(cell.nof_prb)
    si_bits = dci_mod.pack_format1c(cell.nof_prb, 0, step, 9)
    si = dci_mod.unpack_format1c(si_bits, cell.nof_prb)
    si_prbs = np.asarray(si.prb_mask) | np.asarray(si.prb_mask_slot1)
    rbg = ra.rbg_size(cell.nof_prb)
    n_rbg = -(-cell.nof_prb // rbg)
    bitmap = sum(1 << (n_rbg - 1 - r) for r in range(n_rbg)
                 if not si_prbs[r * rbg:(r + 1) * rbg].any())
    mask = ra.prb_mask_type0(cell.nof_prb, bitmap)
    mod, tbs = ra.mcs_to_tbs(FRAME_MCS, sum(mask))
    si_tbs = int(ra.tbs_format1c_table()[si.i_tbs])
    phich = phich_resource(cell, FRAME_UL_PRB_START)
    gains = torch.tensor(FRAME_GAINS, dtype=torch.complex64, device=dev)

    tb_list, acks, snrs, samples = [], [], [], []
    si_tb = torch.as_tensor(rng.integers(0, 2, si_tbs).astype(np.int8),
                            device=dev)
    for sf in range(10):
        retx = sf == FRAME_HARQ_SFS[1]
        pid = (FRAME_HARQ_SFS[0] if retx else sf) % 8
        ndi = (sf // 8) & 1
        rv = 2 if retx else 0
        tb = tb_list[-1] if retx else torch.as_tensor(
            rng.integers(0, 2, tbs).astype(np.int8), device=dev)
        ack = int(rng.integers(0, 2))
        cfg = PdschConfig(cell=cell, sf_idx=sf, cfi=cfi, rnti=rnti, mod=mod,
                          mimo=MimoType.DIVERSITY, nof_layers=4,
                          prb_mask=mask)
        bits = dci_mod.pack_format1(cell.nof_prb, bitmap, FRAME_MCS,
                                    harq_pid=pid, ndi=ndi, rv=rv)
        # the C-RNTI's PDCCH: an L=4 candidate clear of the SI's CCEs 0-3
        l, cce = next(c for c in ue_search_candidates(rnti, sf, n_cce)
                      if c[0] == 4 and c[1] >= 4)
        dcis = [(bits, rnti, cce, l)]
        pdschs = [(tb, cfg, cfg.plan(tbs, rv=rv))]
        if sf == FRAME_SI_SF:
            si_cfg = PdschConfig(cell=cell, sf_idx=sf, cfi=cfi, rnti=si_rnti,
                                 mod=Mod.QPSK, mimo=MimoType.DIVERSITY,
                                 nof_layers=4, prb_mask=si.prb_mask,
                                 prb_mask_slot1=si.prb_mask_slot1)
            dcis.append((si_bits, si_rnti, 0, 4))
            pdschs.append((si_tb, si_cfg, si_cfg.plan(si_tbs)))
        grid = enb_dl_subframe(cell, sf, cfi, dcis=dcis,
                               phichs=[(ack, *phich)], pdschs=pdschs,
                               device=dev)
        # flat per-port gains at the one rx antenna, AWGN at ``snr`` of
        # the mean received power
        x = torch.einsum("p,pt->t", gains, enb_dl_gen_signal(grid, cell))
        snr = FRAME_HARQ_SNR_DB if sf in FRAME_HARQ_SFS else FRAME_SNR_DB
        sigma = torch.sqrt(torch.mean(x.abs() ** 2) * 10 ** (-snr / 10) / 2)
        nz = rng.normal(size=(2, cell.sf_sample_len)).astype(np.float32)
        samples.append(x + sigma * torch.complex(
            torch.as_tensor(nz[0], device=dev),
            torch.as_tensor(nz[1], device=dev)))
        tb_list.append(tb)
        acks.append(ack)
        snrs.append(snr)
    return DlFrame(cell, rnti, torch.stack(samples), tb_list, si_tb, phich,
                   acks, snrs)


#: the one-rx-antenna TM4 subframe: Cell(15 PRB, 2 ports, id 7), sf 1,
#: cfi 2, C-RNTI 0x1234 with a format 2 grant over every RBG (MCS 4 on
#: both codewords, PMI 0), flat port gains at the UE's one antenna, and
#: complex noise of amplitude ONE_RX_NOISE per component; seed 5
ONE_RX_NOF_PRB, ONE_RX_SF, ONE_RX_CFI, ONE_RX_MCS = 15, 1, 2, 4
ONE_RX_GAINS = (1.0 + 0.0j, 0.45 - 0.62j)
ONE_RX_NOISE, ONE_RX_SEED, ONE_RX_CELL_ID = 0.01, 5, 7


def one_rx_tm4_grant():
    """The one-rx TM4 subframe's grant: (cell, rnti, DCI bits, (L, cce),
    PdschConfig, DlschPlan of each codeword). The PDCCH candidate is the
    search space's largest."""
    from . import dci as dci_mod
    from .pdcch import ue_search_candidates
    from .pdsch import PdschConfig
    from .regs import pdcch_nof_cces
    from ..ops.equalizer import MimoType

    cell = Cell(nof_prb=ONE_RX_NOF_PRB, nof_ports=2, id=ONE_RX_CELL_ID)
    rnti = 0x1234
    n_rbg = -(-cell.nof_prb // ra.rbg_size(cell.nof_prb))
    bits = dci_mod.pack_format2(cell.nof_prb, (1 << n_rbg) - 1,
                                (ONE_RX_MCS, ONE_RX_MCS), pmi=0)
    d = dci_mod.unpack_format2(bits, cell.nof_prb)
    mod, tbs = ra.mcs_to_tbs(ONE_RX_MCS, d.n_prb)
    cfg = PdschConfig(cell=cell, sf_idx=ONE_RX_SF, cfi=ONE_RX_CFI, rnti=rnti,
                      mod=mod, mimo=MimoType.SPATIAL_MUX, nof_layers=2,
                      nof_codewords=2, pmi=d.pmi, prb_mask=d.prb_mask)
    cand = max(ue_search_candidates(rnti, ONE_RX_SF,
                                    pdcch_nof_cces(cell, ONE_RX_CFI)))
    return cell, rnti, bits, cand, cfg, cfg.plan(tbs)


def one_rx_tm4_draws(tbs: int, sf_len: int) -> dict:
    """The subframe's numpy draws: both TBs, then the real and imaginary
    noise [2, sf_len]."""
    rng = np.random.default_rng(ONE_RX_SEED)
    tb = rng.integers(0, 2, (2, tbs)).astype(np.int8)
    nz = rng.normal(size=(2, sf_len)).astype(np.float32)
    return dict(tb=tb, nz=nz)


def one_rx_tm4_stimulus(*, device=None):
    """The one-rx TM4 subframe as samples at the UE's one antenna:
    (cell, rnti, samples [sf_len] complex64, TBs [2, tbs] int8)."""
    dev = resolve_device(device)
    cell, rnti, bits, (l, cce), cfg, plan = one_rx_tm4_grant()
    d = one_rx_tm4_draws(plan.tbs, cell.sf_sample_len)
    tb = torch.as_tensor(d["tb"], device=dev)
    grid = enb_dl_subframe(cell, ONE_RX_SF, ONE_RX_CFI,
                           dcis=[(bits, rnti, cce, l)], device=dev)
    from .pdsch import pdsch_encode

    grid = grid + pdsch_encode(tb[:1], cfg, plan, tb[1:], plan)[0]
    gains = torch.tensor(ONE_RX_GAINS, dtype=torch.complex64, device=dev)
    x = torch.einsum("p,pt->t", gains, enb_dl_gen_signal(grid, cell))
    nz = torch.as_tensor(d["nz"], device=dev)
    return cell, rnti, x + ONE_RX_NOISE * torch.complex(nz[0], nz[1]), tb


#: the cold-boot capture: a UE's first 26 subframes (what the stack buffers
#: before its search) of Cell(100 PRB, 1 port, id 301), from SFN 36 sf 4,
#: after COLD_LEAD_IN samples of noise alone (at 30.72 Msps, scaled to
#: the rate of another bandwidth); cfi 2 and CRS everywhere,
#: PSS/SSS in sf 0 and 5, the MIB (phich duration 0, resource 1) in every
#: sf 0, and a C-RNTI format 1 grant over every PRB (MCS 16) in SFN 37 sf
#: 3. CFO 0.2 subcarrier (3 kHz) over the whole capture, AWGN 20 dB below
#: the mean power of the subframes; numpy draws from COLD_SEED
COLD_NOF_PRB, COLD_CELL_ID, COLD_CFI, COLD_MCS = 100, 301, 2, 16
COLD_NOF_SF, COLD_SFN, COLD_SF0, COLD_LEAD_IN = 26, 36, 4, 12345
COLD_CFO, COLD_SNR_DB, COLD_SEED, COLD_RNTI = 0.2, 20.0, 17, 0x1234
COLD_DATA_SFN, COLD_DATA_SF, COLD_PHICH = 37, 3, (0, 1)


@dataclass
class ColdBootCapture:
    """The cold-boot capture and what acquisition must find in it."""

    cell: Cell
    samples: torch.Tensor        # [N] complex64, one rx antenna
    sf0_offset: int              # first sample of the first whole frame
    first_sfn: int               # that frame's SFN
    tb: torch.Tensor             # the data grant's TB [tbs] int8
    rnti: int


def cold_boot_stimulus(*, nof_prb: int = COLD_NOF_PRB,
                       device=None) -> ColdBootCapture:
    """Build the ``COLD_*`` capture with the port's transmitter (at
    another bandwidth when ``nof_prb`` is given)."""
    from . import dci as dci_mod
    from .pbch import mib_pack, pbch_put
    from .pdcch import ue_search_candidates
    from .pdsch import PdschConfig
    from .regs import pdcch_nof_cces
    from ..ops.sync import cfo_correct

    dev = resolve_device(device)
    rng = np.random.default_rng(COLD_SEED)
    cell = Cell(nof_prb=nof_prb, nof_ports=1, id=COLD_CELL_ID)
    mask = (True,) * cell.nof_prb
    n_rbg = -(-cell.nof_prb // ra.rbg_size(cell.nof_prb))
    mod, tbs = ra.mcs_to_tbs(COLD_MCS, cell.nof_prb)
    tb = torch.as_tensor(rng.integers(0, 2, tbs).astype(np.int8), device=dev)
    dci_bits = dci_mod.pack_format1(cell.nof_prb, (1 << n_rbg) - 1, COLD_MCS)
    l, cce = max(ue_search_candidates(COLD_RNTI, COLD_DATA_SF,
                                      pdcch_nof_cces(cell, COLD_CFI)))
    sfs = []
    for i in range(COLD_NOF_SF):
        sfn, sf = divmod(COLD_SFN * 10 + COLD_SF0 + i, 10)
        grant = {}
        if (sfn, sf) == (COLD_DATA_SFN, COLD_DATA_SF):
            cfg = PdschConfig(cell=cell, sf_idx=sf, cfi=COLD_CFI,
                              rnti=COLD_RNTI, mod=mod, prb_mask=mask)
            grant = dict(dcis=[(dci_bits, COLD_RNTI, cce, l)],
                         pdschs=[(tb, cfg, cfg.plan(tbs))])
        grid = put_sync_signals(
            enb_dl_subframe(cell, sf, COLD_CFI, device=dev, **grant),
            cell, sf)
        if sf == 0:
            grid = pbch_put(grid, torch.as_tensor(
                mib_pack(cell.nof_prb, *COLD_PHICH, sfn), device=dev),
                cell, sfn)
        sfs.append(enb_dl_gen_signal(grid, cell)[0])
    x = torch.cat(sfs)
    sigma = torch.sqrt(torch.mean(x.abs() ** 2)
                       * 10 ** (-COLD_SNR_DB / 10) / 2)
    lead_in = COLD_LEAD_IN * cell.sf_sample_len // 30720
    x = torch.cat([x.new_zeros(lead_in), x])
    # the transmitter's carrier sits COLD_CFO subcarriers above the UE's
    x = cfo_correct(x, -COLD_CFO, cell.fft_size)
    nz = torch.as_tensor(rng.normal(size=(2, x.numel())).astype(np.float32),
                         device=dev)
    first_sf0 = -(COLD_SF0 % 10) % 10
    return ColdBootCapture(
        cell=cell, samples=x + sigma * torch.complex(nz[0], nz[1]),
        sf0_offset=lead_in + first_sf0 * cell.sf_sample_len,
        first_sfn=COLD_SFN + 1, tb=tb, rnti=COLD_RNTI)


#: the PBCH batch: subframe-0 grids of Cell(100 PRB, 2 ports, id 301) at
#: SFNs 0, 1, ..., flat per-port gains at one rx antenna (magnitudes 1 and
#: 0.7, random phases per grid), AWGN PBCH_SNR_DB below a PBCH RE's
#: received power; draws on the device from PBCH_SEED
PBCH_NOF_PRB, PBCH_PORTS, PBCH_SNR_DB, PBCH_SEED = 100, 2, 10.0, 19


@dataclass
class PbchBatch:
    """Subframe-0 grids at one rx antenna and the MIB each carries."""

    cell: Cell
    y: torch.Tensor              # [B, nsymb, nre] complex64
    sfn: torch.Tensor            # [B] int64
    mib: torch.Tensor            # [B, 24] int8


def pbch_batch_stimulus(batch: int, *, device=None) -> PbchBatch:
    """``batch`` subframe-0 grids (CRS, PSS/SSS, PBCH; MIB of 100 PRB,
    phich (0, 1)) of the ``PBCH_*`` cell at SFNs 0..batch-1 through the
    ``PBCH_*`` channel."""
    from .pbch import mib_pack, pbch_put

    dev = resolve_device(device)
    g = torch.Generator(device=dev).manual_seed(PBCH_SEED)
    cell = Cell(nof_prb=PBCH_NOF_PRB, nof_ports=PBCH_PORTS, id=COLD_CELL_ID)
    sfn = torch.arange(batch, device=dev)
    mib = torch.as_tensor(np.stack([mib_pack(cell.nof_prb, 0, 1, s)
                                    for s in range(batch)]), device=dev)
    grid = put_sync_signals(enb_dl_base_grid(cell, 0, (batch,), device=dev),
                            cell, 0)
    for q in range(4):
        sel = (sfn % 4 == q).nonzero()[:, 0]
        grid[sel] = pbch_put(grid[sel], mib[sel], cell, q)
    phase = 2 * np.pi * torch.rand((batch, PBCH_PORTS), generator=g,
                                   device=dev)
    mag = torch.tensor([1.0, 0.7], device=dev)
    gains = torch.polar(mag.expand_as(phase), phase)
    y = torch.einsum("bp,bpsk->bsk", gains, grid)
    # SFBC sends each PBCH RE at half power per port
    sigma = torch.sqrt((gains.abs() ** 2).sum(-1) / 2
                       * 10 ** (-PBCH_SNR_DB / 10) / 2)[:, None, None]
    nz = torch.randn((2, *y.shape), generator=g, device=dev)
    return PbchBatch(cell, y + sigma * torch.complex(nz[0], nz[1]), sfn, mib)
