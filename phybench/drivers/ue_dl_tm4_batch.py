"""Driver of the port's batched 2x2 TM4 UE downlink receiver.

One call is ``empower_srslte_tpu_torch.models.ue_dl.ue_dl_tm4_batch(
samples, cfg, plan)`` on ``subframes_per_call`` subframes of the pool,
then one copy of its CFIs, DCI hit counts and CRC flags to the host. The
TB bits stay on the card, where ``tally`` compares them with the sent
bits after the call's clock has stopped.

The check reads the port's soft output through one hook: the public
``pdsch_decode`` (``models/pdsch.py``) as ``models.ue_dl`` calls it,
whose third result is each codeword's de-rate-matched LLRs, a list over
code blocks of [B, 3 (K+4)].
"""

from __future__ import annotations

import torch

from empower_srslte_tpu_torch.models import pdsch as port_pdsch
from empower_srslte_tpu_torch.models import ra as port_ra
from empower_srslte_tpu_torch.models import ue_dl as port_ue_dl
from empower_srslte_tpu_torch.ops.equalizer import MimoType
from empower_srslte_tpu_torch.utils.cell import Cell

from ..drivers_common import PoolDriver
from ..inputs import dl_tm4 as inputs
from ..references import dl_pdsch, spec


def port_plan(conf: dict):
    """The port's own PdschConfig and DlschPlan for the configuration."""
    cell = Cell(nof_prb=conf["nof_prb"], nof_ports=conf["nof_ports"],
                id=conf["cell_id"])
    mod, tbs = port_ra.mcs_to_tbs(conf["mcs"], conf["nof_prb"])
    cfg = port_pdsch.PdschConfig(
        cell=cell, sf_idx=conf["sf_idx"], cfi=conf["cfi"], rnti=conf["rnti"],
        mod=mod, mimo=MimoType.SPATIAL_MUX, nof_layers=conf["nof_layers"],
        nof_codewords=conf["nof_codewords"], pmi=conf["pmi"])
    return cfg, cfg.plan(tbs, max_iterations=conf["max_iterations"])


class Driver(PoolDriver):
    """The downlink cells: two codewords a subframe."""

    codewords = 2

    def build(self, gen: torch.Generator):
        conf = self.conf
        self.cfg, self.plan = port_plan(conf)
        self.tbs = conf["tbs"]
        stated = conf["precision"]["turbo_metric"]
        for name, tbs in (("the port", self.plan.tbs),
                          ("the transmitter", inputs.plan(conf)[1].tbs)):
            if tbs != self.tbs:
                raise ValueError(f"{conf['name']}: TBS {self.tbs} stated, "
                                 f"{tbs} in {name}'s plan")
        for k, _c, _dt in self.segments():
            dt = str(self.plan.decoder(k).metric_dtype).removeprefix("torch.")
            if dt != stated:
                raise ValueError(f"{conf['name']}: turbo metrics in {stated} "
                                 f"stated, the port runs {dt} at K {k}")
        return lambda n: inputs.transmit(conf, self.traffic, n, gen,
                                         self.device)

    def sent(self, part: dict) -> dict:
        return dict(samples=part["samples"],
                    tb=torch.stack([part["tb"], part["tb2"]]))

    def run(self, samples):
        out = port_ue_dl.ue_dl_tm4_batch(samples, self.cfg, self.plan)
        flags = torch.cat([out.cfi.to(torch.int64),
                           out.dci_hits.to(torch.int64),
                           out.crc_ok[0].to(torch.int64),
                           out.crc_ok[1].to(torch.int64)]).cpu()
        return dict(bits=torch.stack(out.tb_bits), flags=flags,
                    iterations=list(out.iterations))

    def host_answers(self, res, n: int) -> dict:
        f = res["flags"]
        return dict(cfi=f[:n], dci_hits=f[n:2 * n], crc=f[2 * n:].view(2, n))

    def window_counts(self, res, n: int) -> dict:
        a = self.host_answers(res, n)
        return dict(cfi_wrong=int((a["cfi"] != self.conf["cfi"]).sum()),
                    dci_missed=int((a["dci_hits"] == 0).sum()))

    def finals(self, res, n: int) -> dict:
        """The call's answers: CFI [n], DCI hits [n], CRC [2, n], bits
        [2, n, tbs]."""
        a = self.host_answers(res, n)
        return dict(cfi=a["cfi"], dci_hits=a["dci_hits"],
                    crc=a["crc"].bool(), bits=res["bits"])

    def hooks(self, sink: dict):
        def soft(args, kwargs, result):
            sink["soft"] = torch.stack([torch.stack(list(s), dim=-2)
                                        for s in result[2]])
        return [(port_ue_dl, "pdsch_decode", soft)]

    def reference(self, samples, lower: bool) -> dict:
        return dl_pdsch.receive(samples, self.conf, lower=lower)

    def segments(self) -> list:
        """(K, code blocks of that K, metric dtype) of a codeword, in the
        order the DL-SCH decode runs its turbo calls."""
        _c, ks, _f = spec.segmentation(self.conf["tbs"])
        dt = self.conf["precision"]["turbo_metric"]
        return [(k, ks.count(k), dt) for k in sorted(set(ks))]
