"""Driver of the port's batched eNB downlink transmitter.

One call is ``empower_srslte_tpu_torch.models.enb_dl.enb_dl_tx_batch(tb,
cfg, plan, tb2=..., dcis=..., phichs=...)`` on ``subframes_per_call``
subframes' TB pairs of the pool, then a wait for the card: the antenna
ports' samples [B, 2, sf_len] are then ready for the radio (their copy to
it is not timed). The pool's TBs are drawn on the card from the seed; the
downlink DCI's payload and the HARQ indicator from the seed, one a run;
the format-0 DCI is the port's packing of the configuration's uplink
grant, and the HARQ indicator sits at the port's PHICH resource of it.

A transmitter decodes nothing: each call reports zero turbo iterations.
Over every call, after the call's clock has stopped and on the card, the
subframes whose samples are not bit for bit those the same pool entry
gave in its first call (the warm-up's) count their two TBs as ``wrong``
(the harness's ``wrong_tbs``); ``mbps`` counts the bits of the others.

The check, on the check entry's ``check_subframes`` rows, against
``phybench.references.dl_tx`` (the subframe composed from the
specification in float64): ``gap.samples``, the largest |difference| of
the port's samples (its call in the window) over the reference's largest
magnitude; ``diff.re``, the REs of every port, channel and signal where
the reference's FFT of the port's samples lies at least the signal's
decision radius from the reference's grid; ``replay``, subframes of a
replayed call whose samples differ from its call in the window.
"""

from __future__ import annotations

import random

import torch

from empower_srslte_tpu_torch.models import dci as port_dci
from empower_srslte_tpu_torch.models import enb_dl as port_enb_dl
from empower_srslte_tpu_torch.models import pdsch as port_pdsch
from empower_srslte_tpu_torch.models import phich as port_phich
from empower_srslte_tpu_torch.models import ra as port_ra
from empower_srslte_tpu_torch.ops.equalizer import MimoType
from empower_srslte_tpu_torch.utils.cell import Cell

from ..compare import MISSING
from ..references import dl_tx


def port_plan(conf: dict):
    """The port's own PdschConfig and DlschPlan for the configuration."""
    cell = Cell(nof_prb=conf["nof_prb"], nof_ports=conf["nof_ports"],
                id=conf["cell_id"])
    mod, tbs = port_ra.mcs_to_tbs(conf["mcs"], conf["nof_prb"])
    cfg = port_pdsch.PdschConfig(
        cell=cell, sf_idx=conf["sf_idx"], cfi=conf["cfi"], rnti=conf["rnti"],
        mod=mod, mimo=MimoType.SPATIAL_MUX, nof_layers=conf["nof_layers"],
        nof_codewords=conf["nof_codewords"], pmi=conf["pmi"])
    return cfg, cfg.plan(tbs)


def sample_gap(ours, ref) -> float:
    """max |ours - ref| / max |ref| of complex samples; ``MISSING`` when
    the shapes disagree or the difference is not finite."""
    if ours is None or tuple(ours.shape) != tuple(ref.shape):
        return MISSING
    diff = float((ours.to(torch.complex128) - ref).abs().max())
    if diff != diff or diff == float("inf"):
        return MISSING
    scale = float(ref.abs().max())
    return diff / scale if scale > 0 else diff


class Driver:
    """The transmitter cell: two codewords a subframe."""

    codewords = 2

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        self.conf, self.traffic, self.device = conf, traffic, device
        self.cfg, self.plan = port_plan(conf)
        self.tbs = conf["tbs"]
        self._refuse_another_grant()
        cell = self.cfg.cell
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        host = torch.Generator()
        host.manual_seed(seed)
        self.per = traffic["subframes_per_call"]
        total, chunk = traffic["pool_subframes"], traffic["draw_subframes"]
        self.tb = torch.cat([torch.randint(
            0, 2, (2, chunk, self.tbs), generator=gen, device=device,
            dtype=torch.int8) for _ in range(total // chunk)], dim=1)
        self.dl_dci = torch.randint(
            0, 2, (port_dci.format1_size(cell.nof_prb),), generator=host,
            dtype=torch.int8)
        self.hi = int(torch.randint(0, 2, (1,), generator=host))
        ul_dci = torch.as_tensor(port_dci.pack_format0(
            cell.nof_prb, conf["ul_prb_start"], conf["ul_n_prb"],
            conf["ul_mcs"], dmrs=conf["n_dmrs"]))
        self.dcis = [
            (self.dl_dci.to(device), conf["rnti"], conf["dci_cce"],
             conf["dci_l"]),
            (ul_dci.to(device), conf["rnti"], conf["ul_dci_cce"],
             conf["ul_dci_l"])]
        self.phichs = [(self.hi, *port_phich.phich_resource(
            cell, conf["ul_prb_start"], conf["n_dmrs"], conf["phich_ng"]))]
        self.n_calls = total // self.per
        pick = random.Random(seed)
        self.check_entries = sorted(pick.sample(range(self.n_calls),
                                                traffic["check_calls"]))
        #: the subframes of each check entry the reference composes
        self.check_rows = {j: sorted(pick.sample(
            range(self.per), min(self.per, traffic["check_subframes"])))
            for j in self.check_entries}
        self.first: dict = {}
        self.kept: dict = {}
        self.log: list = []

    def _refuse_another_grant(self) -> None:
        """The program runs the configuration's grant or not at all: its
        TBS, code blocks and G as stated and as the reference has them."""
        conf, plan = self.conf, self.plan
        segm = plan.segm
        want = (conf["tbs"], conf["code_blocks"]["count"],
                conf["code_blocks"]["k"], conf["g"],
                dl_tx.pdsch_g(conf, conf["nof_codewords"]))
        got = (plan.tbs, segm.c, max(segm.cb_sizes), plan.g, plan.g)
        if len(set(segm.cb_sizes)) != 1 or got != want:
            raise ValueError(
                f"{conf['name']}: TBS, code blocks, K and G {want[:4]} "
                f"stated (G {want[4]} in the reference), the port's plan "
                f"resolves {got[:4]}")

    def rows(self, i: int) -> slice:
        return slice(i * self.per, (i + 1) * self.per)

    def call(self, i: int):
        """One timed call on pool entry ``i``: the port's transmitter,
        then the wait for the card."""
        rows = self.rows(i)
        out = port_enb_dl.enb_dl_tx_batch(
            self.tb[0, rows], self.cfg, self.plan, tb2=self.tb[1, rows],
            dcis=self.dcis, phichs=self.phichs)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        self.first.setdefault(i, out)
        return dict(samples=out, iterations=[0])

    def tally(self, i: int, res) -> None:
        """Log call ``i``: which subframes' samples equal the entry's first
        call's (on the card, not waited for)."""
        same = (res["samples"] == self.first[i]).reshape(self.per, -1) \
            .all(-1)
        self.log.append((same, None, {}, res["iterations"]))
        if i in self.check_entries:
            self.kept.setdefault(i, res["samples"])

    def totals(self) -> dict:
        """The window's TB counts: ``attempted`` (two a subframe),
        ``wrong`` (those of subframes whose samples changed), ``delivered``
        and their ``bits``; no other count."""
        same = torch.cat([e.reshape(-1) for e, *_ in self.log]).cpu()
        attempted = 2 * int(same.numel())
        wrong = 2 * int((~same).sum())
        return dict(attempted=attempted, delivered=attempted - wrong,
                    wrong=wrong, bits=(attempted - wrong) * self.tbs,
                    counts={})

    def reference(self, rows_tb, lower: bool) -> dict:
        return dl_tx.transmit([rows_tb[0], rows_tb[1]], self.conf,
                              self.dl_dci.numpy(), self.hi, lower=lower)

    def check(self, lower: bool = False) -> dict:
        """For each check entry: the reference on its check rows, the
        port's samples of its call in the window (with ``lower`` the
        control's: the reference in bfloat16) held to them, and a replay
        of the call. -> ``gap.samples`` (the largest over the entries),
        ``diff.re`` and ``replay`` (summed)."""
        out = {"gap.samples": 0.0, "diff.re": 0, "replay": 0}
        for j in self.check_entries:
            if j not in self.kept:
                self.tally(j, self.call(j))
            rows = self.check_rows[j]
            tb = self.tb[:, self.rows(j)][:, rows].cpu()
            ref = self.reference(tb, lower=False)
            if lower:
                ours = self.reference(tb, lower=True)["samples"]
            else:
                again = self.call(j)["samples"]
                out["replay"] += int((again != self.kept[j]).reshape(
                    self.per, -1).any(-1).sum())
                del again
                ours = self.kept[j][rows].cpu()
            out["gap.samples"] = max(out["gap.samples"],
                                     sample_gap(ours, ref["samples"]))
            out["diff.re"] += dl_tx.decided_apart(ours, ref,
                                                  self.conf["nof_prb"])
            del ours, ref
        return out
