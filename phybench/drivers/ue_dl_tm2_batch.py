"""Driver of the port's batched transmit-diversity (TM2) UE downlink
receiver on a 4-port cell.

One call is ``empower_srslte_tpu_torch.models.ue_dl.ue_dl_tm2_batch(
samples, cfg, plan)`` on ``subframes_per_call`` subframes of the pool,
then one copy of its CFIs, DCI hit counts and CRC flags to the host; the
TB bits stay on the card, where ``tally`` compares them with the sent
bits after the call's clock has stopped. It follows the TM4 driver with
one codeword: the same tallies (``wrong_tbs``, ``cfi_wrong``,
``dci_missed``) and the same hook on the port's soft output, the public
``pdsch_decode`` as ``models.ue_dl`` calls it, whose third result is the
codeword's de-rate-matched LLRs.

It refuses to start unless the port's plan, and the transmitter's, give
the configuration's TBS, its code blocks' E (TS 36.212 5.1.4.1.2 at
N_L 2) and bfloat16 turbo metrics.
"""

from __future__ import annotations

import torch

from empower_srslte_tpu_torch.models import pdsch as port_pdsch
from empower_srslte_tpu_torch.models import ra as port_ra
from empower_srslte_tpu_torch.models import ue_dl as port_ue_dl
from empower_srslte_tpu_torch.ops.equalizer import MimoType
from empower_srslte_tpu_torch.utils.cell import Cell

from ..inputs import dl_tm2 as inputs
from ..references import dl_tm2
from . import ue_dl_tm4_batch


def port_plan(conf: dict):
    """The port's own PdschConfig and DlschPlan for the configuration."""
    cell = Cell(nof_prb=conf["nof_prb"], nof_ports=conf["nof_ports"],
                id=conf["cell_id"])
    mod, tbs = port_ra.mcs_to_tbs(conf["mcs"], conf["nof_prb"])
    cfg = port_pdsch.PdschConfig(
        cell=cell, sf_idx=conf["sf_idx"], cfi=conf["cfi"], rnti=conf["rnti"],
        mod=mod, mimo=MimoType.DIVERSITY, nof_layers=conf["nof_layers"],
        nof_codewords=conf["nof_codewords"])
    return cfg, cfg.plan(tbs, max_iterations=conf["max_iterations"])


class Driver(ue_dl_tm4_batch.Driver):
    """The TM2 cells: one codeword a subframe."""

    codewords = 1

    def build(self, gen: torch.Generator):
        conf = self.conf
        self.cfg, self.plan = port_plan(conf)
        self.tbs = conf["tbs"]
        stated = conf["precision"]["turbo_metric"]
        e = tuple(conf["code_blocks"]["e"])
        for name, pl in (("the port", self.plan),
                         ("the transmitter", inputs.plan(conf)[1])):
            if pl.tbs != self.tbs:
                raise ValueError(f"{conf['name']}: TBS {self.tbs} stated, "
                                 f"{pl.tbs} in {name}'s plan")
            if tuple(pl.e_sizes) != e:
                raise ValueError(f"{conf['name']}: code blocks' E {e} "
                                 f"stated, {tuple(pl.e_sizes)} in {name}'s "
                                 f"plan")
        for k, _c, _dt in self.segments():
            dt = str(self.plan.decoder(k).metric_dtype).removeprefix("torch.")
            if dt != stated:
                raise ValueError(f"{conf['name']}: turbo metrics in {stated} "
                                 f"stated, the port runs {dt} at K {k}")
        return lambda n: inputs.transmit(conf, self.traffic, n, gen,
                                         self.device)

    def sent(self, part: dict) -> dict:
        return dict(samples=part["samples"], tb=part["tb"][None])

    def run(self, samples):
        out = port_ue_dl.ue_dl_tm2_batch(samples, self.cfg, self.plan)
        flags = torch.cat([out.cfi.to(torch.int64),
                           out.dci_hits.to(torch.int64),
                           out.crc_ok[0].to(torch.int64)]).cpu()
        return dict(bits=torch.stack(out.tb_bits), flags=flags,
                    iterations=list(out.iterations))

    def host_answers(self, res, n: int) -> dict:
        f = res["flags"]
        return dict(cfi=f[:n], dci_hits=f[n:2 * n], crc=f[2 * n:].view(1, n))

    def hooks(self, sink: dict):
        def soft(args, kwargs, result):
            sink["soft"] = torch.stack(list(result[2]), dim=-2)[None]
        return [(port_ue_dl, "pdsch_decode", soft)]

    def reference(self, samples, lower: bool) -> dict:
        return dl_tm2.receive(samples, self.conf, lower=lower)
