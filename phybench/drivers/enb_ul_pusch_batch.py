"""Driver of the port's batched eNB PUSCH-with-UCI receiver.

One call is ``empower_srslte_tpu_torch.models.ue_ul.enb_ul_pusch_batch(
samples, cfg, plan, n0)`` on ``subframes_per_call`` subframes of the
pool at one rx antenna, then one copy to the host of its CRC flags,
HARQ-ACK bits, RIs, and a flag a subframe that is set where the CQI
report's bits differ from the sent ones or its CRC8 failed. The TB bits
stay on the card, where ``tally`` compares them with the sent bits after
the call's clock has stopped.

The UCI payload is one a run: the configuration's HARQ-ACK bits and RI,
and a CQI report drawn from the seed (``inputs.ul_pusch.uci_payload``).
The window counts ``ack_wrong``, ``ri_wrong`` and ``cqi_wrong``, the
subframes whose HARQ-ACK, RI or CQI differs from what was sent.

The check reads the port's soft output through one hook: the public
``pusch_decode_uci`` (``models/pusch.py``) as ``models.ue_ul`` calls it,
whose ``softbuffers`` result is the UL-SCH's de-rate-matched LLRs, a list
over code blocks of [B, 3 (K+4)].
"""

from __future__ import annotations

import torch

from empower_srslte_tpu_torch.models import pusch as port_pusch
from empower_srslte_tpu_torch.models import ra as port_ra
from empower_srslte_tpu_torch.models import ue_ul as port_ue_ul
from empower_srslte_tpu_torch.utils.cell import Cell

from ..drivers_common import PoolDriver
from ..inputs import ul_pusch as inputs
from ..references import spec, ul_pusch


def port_plan(conf: dict, payload: dict):
    """The port's own PuschConfig and UciPlan for the configuration and
    the run's UCI payload."""
    cell = Cell(nof_prb=conf["nof_prb"], nof_ports=1, id=conf["cell_id"])
    mod, tbs = port_ra.mcs_to_tbs(conf["mcs"], conf["n_prb"], dl=False)
    cfg = port_pusch.PuschConfig(
        cell=cell, sf_idx=conf["sf_idx"], rnti=conf["rnti"], mod=mod,
        prb_start=conf["prb_start"], n_prb=conf["n_prb"])
    uci = port_pusch.UciData(
        cqi_bits=payload["cqi_bits"], ri=payload["ri"], ack=payload["ack"],
        i_offset_cqi=conf["i_offset_cqi"], i_offset_ri=conf["i_offset_ri"],
        i_offset_ack=conf["i_offset_ack"])
    return cfg, port_pusch.UciPlan(cfg, tbs, uci,
                                   max_iterations=conf["max_iterations"],
                                   decoder_impl=conf["turbo_decoder"])


class Driver(PoolDriver):
    """The uplink cells: one UL-SCH codeword a subframe."""

    codewords = 1

    def build(self, gen: torch.Generator):
        conf = self.conf
        self.entry = port_ue_ul.enb_ul_pusch_batch
        host = torch.Generator()
        host.manual_seed(gen.initial_seed())
        self.payload = inputs.uci_payload(conf, host)
        self.cfg, self.plan = port_plan(conf, self.payload)
        self.tbs, self.n0 = conf["tbs"], self.traffic["n0"]
        stated = conf["precision"]["turbo_metric"]
        for name, tbs in (("the port", self.plan.tbs),
                          ("the transmitter",
                           inputs.plan(conf, self.payload)[1].tbs)):
            if tbs != self.tbs:
                raise ValueError(f"{conf['name']}: TBS {self.tbs} stated, "
                                 f"{tbs} in {name}'s plan")
        for k, _c, _dt in self.segments():
            dt = str(self.plan.data_plan.decoder(k).metric_dtype
                     ).removeprefix("torch.")
            if dt != stated:
                raise ValueError(f"{conf['name']}: turbo metrics in {stated} "
                                 f"stated, the port runs {dt} at K {k}")
        self.sent_cqi = torch.tensor(self.payload["cqi_bits"],
                                     dtype=torch.int8, device=self.device)
        return lambda n: inputs.transmit(conf, self.traffic, self.payload, n,
                                         gen, self.device)

    def sent(self, part: dict) -> dict:
        return dict(samples=part["samples"], tb=part["tb"][None])

    def run(self, samples):
        out = self.entry(samples, self.cfg, self.plan, self.n0)
        cqi_bad = (out.cqi_bits != self.sent_cqi).any(-1) | ~out.cqi_ok
        flags = torch.cat([out.crc_ok.to(torch.int64)]
                          + [a.to(torch.int64) for a in out.ack]
                          + [out.ri.to(torch.int64),
                             cqi_bad.to(torch.int64)]).cpu()
        return dict(bits=out.tb_bits[None], flags=flags, cqi=out.cqi_bits,
                    iterations=list(out.iterations))

    def host_answers(self, res, n: int) -> dict:
        f, a = res["flags"], len(self.payload["ack"])
        return dict(crc=f[:n].view(1, n), ack=f[n:(1 + a) * n].view(a, n),
                    ri=f[(1 + a) * n:(2 + a) * n].view(1, n),
                    cqi_bad=f[(2 + a) * n:].view(1, n))

    def window_counts(self, res, n: int) -> dict:
        a = self.host_answers(res, n)
        ack = torch.tensor(self.payload["ack"], dtype=torch.int64)[:, None]
        return dict(ack_wrong=int((a["ack"] != ack).any(0).sum()),
                    ri_wrong=int((a["ri"] != self.payload["ri"]).sum()),
                    cqi_wrong=int(a["cqi_bad"].sum()))

    def finals(self, res, n: int) -> dict:
        """The call's answers: CRC [1, n], bits [1, n, tbs], HARQ-ACK
        [bits, n], RI [1, n], the CQI check [1, n] and the CQI bits
        [n, O] (on the card)."""
        a = self.host_answers(res, n)
        return dict(crc=a["crc"].bool(), bits=res["bits"], ack=a["ack"],
                    ri=a["ri"], cqi_bad=a["cqi_bad"], cqi=res["cqi"])

    def hooks(self, sink: dict):
        def soft(args, kwargs, result):
            sink["soft"] = torch.stack(list(result["softbuffers"]),
                                       dim=-2)[None]
        return [(port_ue_ul, "pusch_decode_uci", soft)]

    def reference(self, samples, lower: bool) -> dict:
        ref = ul_pusch.receive(samples, self.conf, self.n0,
                               len(self.payload["cqi_bits"]), lower=lower)
        return dict(soft=ref["soft"][None], crc=ref["crc"][None],
                    bits=ref["bits"][None])

    def segments(self) -> list:
        """(K, code blocks of that K, metric dtype) of the UL-SCH, in the
        order its decode runs its turbo calls."""
        _c, ks, _f = spec.segmentation(self.conf["tbs"])
        dt = self.conf["precision"]["turbo_metric"]
        return [(k, ks.count(k), dt) for k in sorted(set(ks))]
