"""DL-SCH transport-channel processing (36.212 5.3.2).

Capability parity with lib/src/phy/phch/sch.c: TB encode (CRC24A attach ->
segmentation -> per-CB CRC24B -> turbo encode -> rate matching ->
concatenation, sch.c:188-298) and decode_tb_cb (per-CB de-rate-matching
with HARQ soft combining -> iterative turbo decode with CRC early stop ->
reassembly -> TB CRC, sch.c:307-422).

A frozen ``DlschPlan`` captures every static dimension (segmentation,
per-CB K/E/F, RV). Encoding takes the code blocks of each K together:
one gather segments them, one turbo encode and one rate-matching gather
per K, over all leading dims (the reference encodes CBs serially).
Decoding is one path at every batch size: the code blocks of each K are
de-rate-matched straight into the turbo decoder's inputs
(``derm_to_decoder``: one kernel launch on the card) and decoded as ONE
batched turbo call over all leading dims x code blocks (the reference
decodes CBs serially with a per-CB early stop; here the early stop waits
for the whole batch).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.fec.cbsegm import CbSegm, cbsegm
from ..ops.fec.rate_matching import RateMatchTurbo, derm_to_decoder
from ..ops.fec.turbo_decoder import TurboDecoder
from ..ops.fec.turbo_encoder import turbo_encode
from ..runtime import trace
from ..runtime.graphs import EAGER
from ..utils.crc import CRC24A, CRC24B
from ..utils.device import device_table


def _cb_e_sizes(g: int, c: int, qm: int, n_layers: int) -> tuple[int, ...]:
    """Per-CB rate-matching output size E (36.212 5.1.4.1.2)."""
    g_prime = g // (qm * n_layers)
    gamma = g_prime % c
    e_minus = qm * n_layers * (g_prime // c)
    e_plus = qm * n_layers * (-(-g_prime // c))
    return tuple(e_minus if i < c - gamma else e_plus for i in range(c))


def _pick_window(k: int) -> int | None:
    """Turbo window length: the divisor of K closest to 256 that is a
    multiple of 16 (the renormalization group) and >= 48; None (one
    window over the whole trellis) when K has no such divisor."""
    best = None
    for w in range(48, min(k, 769), 16):
        if k % w == 0 and (best is None or abs(w - 256) < abs(best - 256)):
            best = w
    return best


@dataclass(frozen=True)
class DlschPlan:
    """Static per-grant transport channel plan."""

    tbs: int                 # transport block payload bits
    g: int                   # total codeword bits after rate matching
    qm: int                  # modulation order (bits/symbol)
    rv: int = 0              # redundancy version
    n_layers: int = 1        # layers carrying this codeword
    max_iterations: int = 5
    #: iterate only until every CB passes its CRC (sch.c:382 early stop,
    #: batched); False = fixed max_iterations
    early_stop: bool = True
    #: turbo constituent decoder: "nii" (ops/fec/turbo_nii.py),
    #: "windowed" (ops/fec/turbo_win.py) or "xla" (the plain sweeps);
    #: see ``TurboDecoder.impl``
    decoder_impl: str = "nii"

    @functools.cached_property
    def segm(self) -> CbSegm:
        return cbsegm(self.tbs)

    @functools.cached_property
    def e_sizes(self) -> tuple[int, ...]:
        return _cb_e_sizes(self.g, self.segm.c, self.qm, self.n_layers)

    @functools.cached_property
    def cb_plans(self):
        """Per-CB (k, e, f, offset_in_codeword)."""
        out = []
        off = 0
        for i, (k, e) in enumerate(zip(self.segm.cb_sizes, self.e_sizes)):
            f = self.segm.f if i == 0 else 0
            out.append((k, e, f, off))
            off += e
        assert off == self.g, (off, self.g)
        return tuple(out)

    @functools.cached_property
    def k_groups(self) -> dict:
        """{K: ((CB index, e, f, offset), ...)}: the code blocks of each
        size, in order (K- before K+)."""
        out: dict = {}
        for idx, (k, e, f, off) in enumerate(self.cb_plans):
            out.setdefault(k, []).append((idx, e, f, off))
        return {k: tuple(v) for k, v in out.items()}

    def rm(self, k: int, f: int) -> RateMatchTurbo:
        return RateMatchTurbo(k, f=f)

    def decoder(self, k: int) -> TurboDecoder:
        return TurboDecoder(k=k, iterations=self.max_iterations,
                            window=_pick_window(k), impl=self.decoder_impl)


def filler_prior(llrs: torch.Tensor, plan: DlschPlan):
    """The known-zero LLR of the filler bits, or None for ``FILLER_LLR``.

    A float32 decode keeps the fixed 1e4. A bfloat16 decode (the filler
    code block's decoder resolves to bfloat16) takes the JAX package's
    fused-path rule (empower_srslte_tpu/models/sch.py:592-613): 1e4 would
    put a common offset of ~1e4 * F / 2 on the metrics inside each
    16-row renormalization group, and its bfloat16 ulp would swamp the
    real LLRs. The prior is ``c_f * mean|llrs|`` per codeword, in
    float32, with ``c_f = min(8, 128 / F)``; on the int8 lane it stays
    127 (``RateMatchTurbo.rx``). -> a float32 tensor over the leading
    dims of ``llrs``, or None."""
    k, _e, f, _off = plan.cb_plans[0]
    if f == 0 or llrs.dtype == torch.int8 \
            or plan.decoder(k).metric_dtype != torch.bfloat16:
        return None
    c_f = min(8.0, 128.0 / f)
    return c_f * llrs.abs().to(torch.float32).mean(-1)


def _segment_table(plan: DlschPlan, k: int) -> np.ndarray:
    """[code blocks of size k, k - 24 (k when C is 1)] int64: each
    block's payload as positions in [0] ++ TB ++ CRC24A, 0 for its
    leading filler bits (36.212 5.1.2)."""
    segm = plan.segm
    rows, pos = [], 0
    for kk, _e, f, _off in plan.cb_plans:
        payload = kk - f - (24 if segm.c > 1 else 0)
        if kk == k:
            rows.append(np.concatenate([np.zeros(f, np.int64),
                                        np.arange(pos, pos + payload) + 1]))
        pos += payload
    return np.stack(rows)


def _rm_table(plan: DlschPlan, k: int) -> np.ndarray:
    """The bit selection of the code blocks of size k (36.212 5.1.4.1.2)
    as positions in their d [blocks, 3, K+4] flattened: [sum of E]."""
    members = plan.k_groups[k]
    return np.concatenate([
        j * 3 * (k + 4) + plan.rm(k, f).tx_indices(plan.rv, e)
        for j, (_idx, e, f, _off) in enumerate(members)]).astype(np.int64)


def dlsch_encode(tb_bits, plan: DlschPlan) -> torch.Tensor:
    """Encode tb_bits[..., tbs] -> codeword bits [..., G] int8
    (encode_tb_off, sch.c:188-298); a list of such tensors (codewords of
    one plan) is stacked on a new leading axis. The code blocks of each K
    go together: the CRCs and segmentation (one gather a K) in the range
    ``dlsch.crc_attach``, one turbo encode a K in ``dlsch.turbo_encode``,
    one bit-selection gather a K in ``dlsch.rate_match``. The K- blocks
    precede the K+ ones, so the groups' outputs in turn are the codeword's
    blocks in natural order."""
    segm = plan.segm
    with trace.span("dlsch.crc_attach"):
        if isinstance(tb_bits, (list, tuple)):
            tb_bits = torch.stack(tb_bits)
        lead = tb_bits.shape[:-1]
        dev = tb_bits.device
        tb_crc = CRC24A.compute(tb_bits).to(torch.int8)
        padded = torch.cat([torch.zeros((*lead, 1), dtype=torch.int8,
                                        device=dev),
                            tb_bits.to(torch.int8), tb_crc], dim=-1)
        blocks = {}
        for k in plan.k_groups:
            cb = padded[..., device_table(("dlsch_segment", plan, k), dev,
                                          lambda k=k: _segment_table(plan,
                                                                     k))]
            if segm.c > 1:
                cb = torch.cat([cb, CRC24B.compute(cb).to(torch.int8)],
                               dim=-1)
            blocks[k] = cb                                 # [..., n, k]

    with trace.span("dlsch.turbo_encode"):
        coded = {k: turbo_encode(cb) for k, cb in blocks.items()}

    with trace.span("dlsch.rate_match"):
        out = [d.reshape(*lead, -1)[..., device_table(
                   ("dlsch_rm", plan, k), dev,
                   lambda k=k: _rm_table(plan, k))]
               for k, d in coded.items()]
        return out[0] if len(out) == 1 else torch.cat(out, dim=-1)


def _crc_reassembly(plan: DlschPlan, *decoded) -> tuple:
    """The turbo decoder's hard bits, one tensor [..., C_k, K] a K in
    ``plan.k_groups``' order -> (TB bits [..., tbs], crc_ok [...]: the TB
    CRC24A and every code block's CRC24B passed)."""
    segm = plan.segm
    cb_bits = [None] * segm.c
    tb_ok = None
    for (k, members), dec in zip(plan.k_groups.items(), decoded):
        if segm.c > 1:
            # every code block of this K in one check: [..., C_k]
            ok = CRC24B.check(dec).all(dim=-1)
            tb_ok = ok if tb_ok is None else tb_ok & ok
        for j, (idx, _e, f, _off) in enumerate(members):
            b = dec[..., j, :]
            cb_bits[idx] = b[..., f:k - 24] if segm.c > 1 else b[..., f:]

    full = torch.cat(cb_bits, dim=-1)                      # [..., tbs + 24]
    # the all-zero word is a valid turbo codeword whose CRC trivially
    # passes; a decoder collapsing to it must not report success
    ok = CRC24A.check(full) & torch.any(full != 0, dim=-1)
    return full[..., :plan.tbs], ok if tb_ok is None else ok & tb_ok


def dlsch_decode(llrs: torch.Tensor, plan: DlschPlan, softbuffers=None,
                 iters_out: list | None = None, stages=EAGER):
    """Decode llrs[..., G] -> (tb_bits[..., tbs], crc_ok[...], softbuffers).

    Mirrors decode_tb / decode_tb_cb (sch.c:307-437): per-CB
    de-rate-match with HARQ combining into ``softbuffers`` (list of
    per-CB tensors [..., 3*(K+4)], or None) straight into the turbo
    decoder's inputs (``derm_to_decoder``, one call per K), one batched
    turbo decode per K, one CRC check of the code blocks of each K,
    reassembly, TB CRC. ``iters_out`` (a list) receives each turbo call's
    iteration count. The three steps run in the profiler ranges
    ``dlsch.derm``, ``dlsch.turbo_decode`` and ``dlsch.crc_reassembly``,
    the last as a stage of ``stages`` (``runtime.graphs``). The filler
    bits' prior is ``filler_prior``.
    """
    segm = plan.segm
    stop_crc = (CRC24B if segm.c > 1 else CRC24A) if plan.early_stop else None

    with trace.span("dlsch.derm"):
        prior = filler_prior(llrs, plan)
        fed = {}
        for k, members in plan.k_groups.items():
            sb = (torch.stack([softbuffers[idx] for idx, *_ in members],
                              dim=-2)
                  if softbuffers is not None else None)
            fed[k] = derm_to_decoder(
                llrs, tuple((e, f, off) for _idx, e, f, off in members),
                plan.rv, plan.decoder(k), softbuffer=sb, prior=prior)

    with trace.span("dlsch.turbo_decode"):
        decoded = [plan.decoder(k).decode_prepared(
                       *inputs, crc=stop_crc, iters_out=iters_out)[0]
                   for k, (_soft, inputs) in fed.items()]

    bits, ok = stages("dlsch.crc_reassembly", _crc_reassembly, plan,
                      *decoded)
    new_soft = [None] * segm.c
    for k, members in plan.k_groups.items():
        for j, (idx, *_rest) in enumerate(members):
            new_soft[idx] = fed[k][0][..., j, :]
    return stages.keep(bits), stages.keep(ok), new_soft
