"""UE uplink subframe generation and the eNB's uplink front end
(lib/src/phy/ue/ue_ul.c, enb_ul.c parity).

Counterpart of the JAX package's models/ue_ul.py:26-88: composes PUSCH
(with or without UCI), PUCCH and SRS into the UL grid, SC-FDMA modulates
it (TS 36.211 5.6: ``ops.ofdm.sc_fdma_tx_sf``), applies CFO
pre-compensation and timing advance, and on the eNB side demodulates back
to the grid. ``enb_ul_pusch_batch`` is the eNB's batched PUSCH-with-UCI
receiver. ``ue_ul_pusch_jit`` is the JAX package's cached PUSCH-subframe
generator; the port has no jit, so it caches a plain closure.

``ul_uci_stimulus`` builds the uplink path's receive samples: a batch of
20 MHz PUSCH subframes with UCI through a flat channel and AWGN;
``ul_stimulus`` the same grant, or the stack's Msg3 grant, without UCI.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.ofdm import sc_fdma_rx_sf, sc_fdma_tx_sf
from ..ops.sync import cfo_correct
from ..runtime import trace
from ..utils.cell import Cell
from ..utils.device import resolve_device
from .pucch import F2_FORMATS, pucch_f1_encode, pucch_f2_encode
from .pusch import UciPlan, pusch_decode_uci, pusch_encode, pusch_encode_uci
from .refsignal_ul import srs_chest, srs_put


def ue_ul_generate(cell: Cell, *, pusch: tuple | None = None,
                   pucch: tuple | None = None, srs: dict | None = None,
                   cfo: float = 0.0, timing_advance: int = 0,
                   device=None) -> torch.Tensor:
    """Build one UL subframe per leading index.

    pusch: (tb_bits[..., tbs], PuschConfig, DlschPlan | UciPlan) or None;
           with a UciPlan the subframe carries multiplexed CQI/RI/ACK
    pucch: (PucchConfig, bits tuple or payload array[, ACK bits]) or
           None; formats 2a/2b take the ACK bits third
    srs:   dict(n_prb_srs=..., prb_start=..., comb=..., cyclic_shift=...)
    cfo:   pre-compensated carrier offset in subcarrier spacings (the
           samples are rotated by exp(+j 2 pi cfo n / fft))
    timing_advance: samples the subframe is sent early (a cyclic roll)
    Without PUSCH the grid starts empty, on ``device`` (None = the CUDA
    card); with it, on the TB bits' device. Returns time samples
    [..., sf_sample_len] complex64.
    """
    if pusch is not None:
        tb, cfg, plan = pusch
        grid = (pusch_encode_uci(tb, cfg, plan) if isinstance(plan, UciPlan)
                else pusch_encode(tb, cfg, plan))
    else:
        grid = torch.zeros((cell.nsymb_sf, cell.nof_re),
                           dtype=torch.complex64,
                           device=resolve_device(device))
    if pucch is not None:
        pcfg, payload, *rest = pucch
        if pcfg.format in F2_FORMATS:
            ack = tuple(rest[0]) if rest else ()
            grid = grid + pucch_f2_encode(pcfg, payload, ack,
                                          device=grid.device)
        else:
            grid = grid + pucch_f1_encode(pcfg, tuple(payload),
                                          device=grid.device)
    if srs is not None:
        grid = srs_put(grid, cell, **srs)
    samples = sc_fdma_tx_sf(grid, cell)
    if cfo:
        samples = cfo_correct(samples, -cfo, cell.fft_size)
    if timing_advance:
        samples = torch.roll(samples, -timing_advance, dims=-1)
    return samples


@functools.lru_cache(maxsize=None)
def ue_ul_pusch_jit(cell: Cell, cfg, plan, timing_advance: int = 0):
    """Cached PUSCH-subframe generator for one (config, plan), as the JAX
    package's (a ``jax.jit`` there; the port has no jit, so this is the
    plain closure). Call as ``fn(tb_bits)`` -> time samples."""
    return lambda tb: ue_ul_generate(cell, pusch=(tb, cfg, plan),
                                     timing_advance=timing_advance)


def enb_ul_receive_grid(samples: torch.Tensor, cell: Cell) -> torch.Tensor:
    """eNB side: SC-FDMA demodulation to the UL grid [..., nsymb, nre]
    (srslte_enb_ul_fft analog; TS 36.211 5.6; profiler range
    ``enb_ul.fft``)."""
    with trace.span("enb_ul.fft"):
        return sc_fdma_rx_sf(samples, cell)


@dataclass
class PuschBatchResult:
    """Per-subframe outcome of ``enb_ul_pusch_batch``."""

    tb_bits: torch.Tensor        # [B, tbs] int8
    crc_ok: torch.Tensor         # [B] bool
    ack: tuple                   # one [B] int8 per HARQ-ACK bit
    ri: torch.Tensor | None      # [B] int8, or None without an RI
    cqi_bits: torch.Tensor | None  # [B, O] int8, or None without a CQI
    cqi_ok: torch.Tensor | None  # [B] bool: the CQI's CRC8 (a long CQI)
    iterations: list             # turbo iteration count per turbo call


def enb_ul_pusch_batch(samples: torch.Tensor, cfg, plan: UciPlan,
                       noise_est) -> PuschBatchResult:
    """The eNB's PUSCH-with-UCI receiver over a batch of subframes at one
    rx antenna: samples [B, sf_len] complex64 -> ``enb_ul_receive_grid``
    (SC-FDMA) -> ``pusch_decode_uci`` (DMRS channel estimate, per-RE
    MMSE, transform de-precoding, UCI demultiplexing, HARQ-ACK / RI / CQI
    decode, UL-SCH decode), with ``noise_est`` the noise per RE.

    The whole call runs in the root range ``enb_ul.pusch_batch`` (its self
    time is the receiver's glue); the stages in ``enb_ul.fft``,
    ``pusch.chest``, ``pusch.eq_demod``, ``pusch.uci_demux``,
    ``uci.cqi_decode``, ``dlsch.*`` and ``turbo.stop_read``.
    """
    with trace.root("enb_ul.pusch_batch", samples.device):
        grid = enb_ul_receive_grid(samples, cfg.cell)
        iters: list = []
        out = pusch_decode_uci(grid, cfg, plan, noise_est=noise_est,
                               iters_out=iters)
        return PuschBatchResult(out["tb"], out["crc_ok"], out["ack"],
                                out["ri"], out["cqi_bits"], out["cqi_ok"],
                                iters)


#: the uplink path's grant: the JAX benchmark's 20 MHz uplink
#: (bench.py rx_20ul: 96 PRB from PRB 0, MCS 20, 16QAM, TBS 40576, cell id
#: 1, sf 1, RNTI 0x1234, flat channel 0.95+0.1j) carrying the stack's UCI
#: (two HARQ-ACK bits, a 1-bit RI and the higher-layer subband CQI report)
UL_NOF_PRB, UL_N_PRB, UL_MCS, UL_SEED = 100, 96, 20, 7
UL_H = complex(0.95, 0.1)
#: (first PRB, PRBs, MCS) of ``UL_*``'s grant, and of the JAX stack's Msg3
#: grant (stack/params.py:20-21: TBS 256, one code block of K 280, a K
#: with no turbo window)
UL_GRANT, MSG3_GRANT = (0, UL_N_PRB, UL_MCS), (10, 4, 4)


@dataclass
class UlStimulus:
    """The uplink path's input and what it must decode to."""

    cfg: object                  # PuschConfig
    plan: object                 # UciPlan (ul_uci_stimulus) or DlschPlan
    samples: torch.Tensor        # [B, sf_len] complex64 at the eNB antenna
    tb: torch.Tensor             # [B, tbs] int8


def _ul_grant(grant=UL_GRANT):
    """``grant`` (first PRB, PRBs, MCS) on the ``UL_*`` cell:
    -> (PuschConfig, TBS)."""
    from . import ra
    from .pusch import PuschConfig

    prb_start, n_prb, mcs = grant
    cell = Cell(nof_prb=UL_NOF_PRB, nof_ports=1, id=1)
    mod, tbs = ra.mcs_to_tbs(mcs, n_prb, dl=False)
    return PuschConfig(cell=cell, sf_idx=1, rnti=0x1234, mod=mod,
                       prb_start=prb_start, n_prb=n_prb), tbs


def _ul_batch(cfg, plan, batch: int, n0: float, rng, dev) -> UlStimulus:
    """``batch`` subframes of ``plan`` on the grant ``cfg`` through the flat
    channel ``UL_H`` plus AWGN of ``n0`` per resource element of the
    received grid; TB bits, then the noise, drawn from ``rng``.

    The noise is added to the time samples: ``sc_fdma_rx_sf`` is an
    unnormalized FFT, so white noise of variance s2 per sample has
    variance fft_size * s2 per grid RE; s2 = n0 / fft_size."""
    cell = cfg.cell
    tb = torch.as_tensor(rng.integers(0, 2, size=(batch, plan.tbs))
                         .astype(np.int8), device=dev)
    x = ue_ul_generate(cell, pusch=(tb, cfg, plan)) * UL_H
    sigma = float(np.sqrt(n0 / cell.fft_size / 2))
    nshape = (batch, cell.sf_sample_len)
    noise = torch.complex(
        torch.as_tensor(rng.normal(size=nshape).astype(np.float32),
                        device=dev),
        torch.as_tensor(rng.normal(size=nshape).astype(np.float32),
                        device=dev))
    return UlStimulus(cfg, plan, x + sigma * noise, tb)


def ul_uci_stimulus(batch: int, n0: float, *, device=None) -> UlStimulus:
    """``batch`` PUSCH+UCI subframes at the ``UL_*`` settings through the
    flat channel ``UL_H`` plus AWGN of ``n0`` per resource element of the
    received grid, for ``pusch_decode_uci``. The subband CQIs, TB bits and
    the noise are numpy draws from ``UL_SEED``."""
    from .pusch import UciData
    from .uci import cqi_nof_subbands, cqi_pack_hl_subband

    dev = resolve_device(device)
    cfg, tbs = _ul_grant()
    rng = np.random.default_rng(UL_SEED)
    wb = int(rng.integers(1, 16))
    sbs = rng.integers(0, 16, cqi_nof_subbands(UL_NOF_PRB))
    uci_data = UciData(ack=(1, 0), ri=1, cqi_bits=tuple(
        int(b) for b in cqi_pack_hl_subband(wb, sbs, UL_NOF_PRB)))
    plan = UciPlan(cfg, tbs, uci_data, decoder_impl="windowed")
    return _ul_batch(cfg, plan, batch, n0, rng, dev)


def ul_stimulus(batch: int, n0: float, *, grant=UL_GRANT,
                device=None) -> UlStimulus:
    """``batch`` PUSCH subframes without UCI on ``grant`` (``UL_GRANT`` or
    ``MSG3_GRANT``), as ``ul_uci_stimulus`` builds them, for
    ``pusch_decode`` (the plan is the UL-SCH's ``DlschPlan``, windowed
    decoder). TB bits and the noise are numpy draws from ``UL_SEED``."""
    cfg, tbs = _ul_grant(grant)
    plan = cfg.plan(tbs, decoder_impl="windowed")
    return _ul_batch(cfg, plan, batch, n0, np.random.default_rng(UL_SEED),
                     resolve_device(device))


# --- the busy uplink control TTI (PUCCH + SRS) ------------------------------

#: PRB pairs of the PUCCH format-2 region (pucch-ConfigCommon nRB-CQI, the
#: JAX stack's PUCCH_N_RB_2); format 1 resources sit in the next pair in
CTRL_N_RB_2 = 1
#: the TTI's PUCCH users: (name, format, n_pucch). The SR and four ACK
#: users share format 1's first PRB pair on orthogonal (cyclic shift,
#: cover) resources; the CQI, RI and CQI+ACK users share the format-2
#: pair on cyclic shifts 0, 3 and 6
CTRL_UES = (("sr", "1", 0), ("ack_1a", "1a", 2), ("ack_1b", "1b", 7),
            ("ack_1a_2", "1a", 14), ("ack_1b_2", "1b", 27),
            ("cqi", "2", 0), ("ri", "2", 3), ("cqi_ack", "2b", 6))
#: the user whose UE pre-compensates a timing advance (samples) and a
#: carrier offset (subcarrier spacings) that its channel then applies
CTRL_TA_UE, CTRL_TA, CTRL_CFO = "cqi_ack", 16, 0.05
#: payload variants; subframe b carries variant b % CTRL_VARIANTS. The SR
#: user sends its format-1 PUCCH only in the even variants (on-off keying)
CTRL_VARIANTS = 4
#: the JAX stack's SR decision (stack/enb.py:48,478): an SR is present when
#: the coherent format-1 energy exceeds this and Re(d) exceeds 0.5
CTRL_SR_ENERGY = 1.0
CTRL_SF, CTRL_SNR_DB, CTRL_SEED = 1, 10.0, 41


@dataclass
class UlControl:
    """The control TTI batch and what the eNB must decode from it."""

    cell: Cell
    samples: torch.Tensor        # [B, sf_len] complex64 at the eNB antenna
    pucch: dict                  # name -> PucchConfig
    sent: dict                   # name -> int8 [B, n]: f1 bits, f2 payload;
                                 #   "<name>_ack": a 2a/2b user's ACK bits
    srs: dict                    # srs_put / srs_chest keyword arguments
    srs_gain: torch.Tensor       # [B] complex64, the SRS user's flat gain
    n0: float                    # noise per grid RE


def _ctrl_payload(name: str, v: int):
    """(PUCCH payload, ACK bits) of user ``name`` in payload variant v;
    the SR user's payload (0,) means it sends nothing."""
    from .uci import cqi_pack_wideband, ri_pack

    lo, hi = v & 1, (v >> 1) & 1
    return {"sr": ((1 - lo,), ()), "ack_1a": ((lo,), ()),
            "ack_1b": ((hi, lo), ()), "ack_1a_2": ((1 - lo,), ()),
            "ack_1b_2": ((lo, hi), ()),
            "cqi": (cqi_pack_wideband(3 + 4 * v), ()),
            "ri": (ri_pack(1 + lo), ()),
            "cqi_ack": (cqi_pack_wideband(15 - 4 * v), (hi, lo))}[name]


def ctrl_ta_channel(samples: torch.Tensor, cell: Cell) -> torch.Tensor:
    """The ``CTRL_TA_UE`` user's channel: a cyclic delay of ``CTRL_TA``
    samples, then a carrier offset of ``CTRL_CFO`` (the rotation
    exp(-j 2 pi cfo n / fft)): what that UE's pre-compensation undoes."""
    return cfo_correct(torch.roll(samples, CTRL_TA, dims=-1), CTRL_CFO,
                       cell.fft_size)


def ul_control_stimulus(batch: int, *, nof_prb: int = 100,
                        device=None) -> UlControl:
    """``batch`` uplink subframes (sf ``CTRL_SF``) of a busy TTI on
    Cell(nof_prb, 1 port, id 1): every ``CTRL_UES`` user's PUCCH and a
    comb-0 SRS over all PRBs but the two PUCCH pairs, each user's
    ``ue_ul_generate`` output through its own flat gain per subframe,
    summed as the JAX stack's air sums UEs, plus AWGN of ``CTRL_SNR_DB``
    below a unit-power RE. The ``CTRL_TA_UE`` user pre-compensates
    ``CTRL_TA`` samples of timing advance and ``CTRL_CFO`` of carrier
    offset, which its channel applies (a cyclic delay, then the offset),
    so its signal arrives aligned only if both are undone with the right
    signs. Payloads cycle through ``CTRL_VARIANTS`` variants, the SR user
    silent in the odd ones; gains are
    numpy draws from ``CTRL_SEED``, the noise a torch draw on the card."""
    from ..ops.channel import awgn
    from .pucch import PucchConfig

    dev = resolve_device(device)
    cell = Cell(nof_prb=nof_prb, nof_ports=1, id=1)
    rng = np.random.default_rng(CTRL_SEED)
    srs = dict(n_prb_srs=nof_prb - 4, prb_start=2, comb=0)
    users = [(name, PucchConfig(cell=cell, sf_idx=CTRL_SF, n_pucch=n,
                                format=fmt, n_rb_2=CTRL_N_RB_2))
             for name, fmt, n in CTRL_UES]
    variant = torch.arange(batch, device=dev) % CTRL_VARIANTS
    gains = (rng.uniform(0.7, 1.3, (batch, len(users) + 1))
             * np.exp(2j * np.pi * rng.random((batch, len(users) + 1))))
    gains = torch.as_tensor(gains.astype(np.complex64), device=dev)

    x = gains[:, -1:] * ue_ul_generate(cell, srs=srs, device=dev)
    sent = {}
    for u, (name, cfg) in enumerate(users):
        per_v, bits_v, ack_v = [], [], []
        for v in range(CTRL_VARIANTS):
            payload, ack = _ctrl_payload(name, v)
            kw = {"cfo": CTRL_CFO, "timing_advance": CTRL_TA} \
                if name == CTRL_TA_UE else {}
            s = ue_ul_generate(cell, pucch=(cfg, payload, ack), device=dev,
                               **kw)
            if cfg.format == "1" and not payload[0]:
                s = torch.zeros_like(s)
            per_v.append(ctrl_ta_channel(s, cell) if kw else s)
            bits_v.append(np.asarray(payload, np.int8))
            ack_v.append(np.asarray(ack, np.int8))
        x = x + gains[:, u:u + 1] * torch.stack(per_v)[variant]
        sent[name] = torch.as_tensor(np.stack(bits_v), device=dev)[variant]
        if ack_v[0].size:
            sent[name + "_ack"] = torch.as_tensor(
                np.stack(ack_v), device=dev)[variant]
    n0 = 10 ** (-CTRL_SNR_DB / 10)
    gen = torch.Generator(device=dev).manual_seed(CTRL_SEED)
    return UlControl(cell, awgn(gen, x, n0 / cell.fft_size),
                     dict(users), sent, srs, gains[:, -1], n0)


def ul_control_receive(samples: torch.Tensor, st: UlControl) -> dict:
    """The eNB's control decode of ``ul_control_stimulus``'s TTI: the UL
    grid, then every user's PUCCH decode on its config (format 1 by the
    stack's SR rule, ``CTRL_SR_ENERGY``), then the SRS LS estimate.
    -> name -> decoded int8 bits [B, n] (as ``st.sent``), and
    "srs_h" [B, M_sc] complex64."""
    from .pucch import (F2_FORMATS, pucch_f1_bits, pucch_f1_decode,
                        pucch_f2_decode)

    grid = enb_ul_receive_grid(samples, st.cell)
    out = {}
    for name, cfg in st.pucch.items():
        if cfg.format in F2_FORMATS:
            nof_ack = st.sent[name + "_ack"].shape[-1] \
                if name + "_ack" in st.sent else 0
            res = pucch_f2_decode(grid, cfg, st.sent[name].shape[-1],
                                  nof_ack=nof_ack)
            if nof_ack:
                out[name], out[name + "_ack"] = res
            else:
                out[name] = res
        else:
            d, energy = pucch_f1_decode(grid, cfg)
            if cfg.format == "1":
                out[name] = ((energy > CTRL_SR_ENERGY) & (d.real > 0.5)) \
                    .to(torch.int8)[..., None]
            else:
                out[name] = pucch_f1_bits(d, cfg.format)
    out["srs_h"] = srs_chest(grid, st.cell, **st.srs)
    return out
