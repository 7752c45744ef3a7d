"""What every driver shares: the pool of inputs drawn from the seed, the
tally of the window's answers against the sent ones, and the check of the
port's answers and soft output against the plain reference.

A subclass gives ``build`` (the port's plan, ``tbs``, and a function
drawing ``n`` subframes), ``sent`` (samples and TB bits [codewords, n,
tbs] of one draw), ``run`` (one timed call), ``host_answers``,
``window_counts``, ``finals``, ``hooks`` (the taps that record the
port's soft output of a replayed call), ``reference`` and ``segments``
(see each driver).
"""

from __future__ import annotations

import random

import torch

from .compare import gap, tb_diff
from .observe import tapped


class PoolDriver:
    codewords = 1

    def __init__(self, conf: dict, traffic: dict, seed: int, device):
        self.conf, self.traffic, self.device = conf, traffic, device
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        draw = self.build(gen)
        self.per = traffic["subframes_per_call"]
        total, chunk = traffic["pool_subframes"], traffic["draw_subframes"]
        parts = [self.sent(draw(chunk)) for _ in range(total // chunk)]
        self.samples = torch.cat([p["samples"] for p in parts])
        self.tb = torch.cat([p["tb"] for p in parts], dim=1)
        del parts
        self.n_calls = total // self.per
        pick = random.Random(seed)
        self.check_entries = sorted(pick.sample(range(self.n_calls),
                                                traffic["check_calls"]))
        #: the subframes of each check entry that the reference decodes
        self.check_rows = {j: sorted(pick.sample(
            range(self.per), min(self.per, traffic["check_subframes"])))
            for j in self.check_entries}
        self.kept: dict = {}
        self.log: list = []

    def rows(self, i: int) -> slice:
        return slice(i * self.per, (i + 1) * self.per)

    def call(self, i: int):
        """One timed call on pool entry ``i``: the port's receiver and its
        answers on the host."""
        return self.run(self.samples[self.rows(i)])

    def tally(self, i: int, res) -> None:
        """Log call ``i``'s answers: which TBs equal the sent bits (on the
        card, not waited for), and the host's flags."""
        equal = (res["bits"] == self.tb[:, self.rows(i)]).all(-1)
        self.log.append((equal, self.host_answers(res, self.per)["crc"],
                         self.window_counts(res, self.per),
                         res["iterations"]))
        if i in self.check_entries:
            self.kept[i] = self.finals(res, self.per)

    def totals(self) -> dict:
        """The window's TB counts: ``attempted``, ``delivered`` (CRC
        passed and the bits equal the sent ones), ``wrong`` (CRC passed,
        bits differ), ``bits`` delivered, and ``counts``, each of the
        driver's window counts summed (compared, with limit 0)."""
        equal = torch.cat([e.reshape(-1) for e, *_ in self.log]).cpu()
        crc = torch.cat([c.reshape(-1) for _e, c, *_ in self.log]).bool()
        out = dict(attempted=int(equal.numel()),
                   delivered=int((equal & crc).sum()),
                   wrong=int((~equal & crc).sum()), counts={})
        out["bits"] = out["delivered"] * self.tbs
        for _e, _c, counts, _i in self.log:
            for name, v in counts.items():
                out["counts"][name] = out["counts"].get(name, 0) + v
        return out

    def check(self, lower: bool = False) -> dict:
        """For each check entry: replay it through the port with the
        hooks on, and run the plain reference on its check rows.
        -> readings: ``gap.soft`` (the largest over the entries, of the
        de-rate-matched LLRs of the check rows), ``diff.tb`` (TBs of the
        check rows whose answer differs from the reference's) and
        ``replay`` (answers of the replay that differ from the window's
        call on the same input), summed over the entries. With ``lower``
        the control, the reference at the precision below the
        configuration's, takes the port's place."""
        out = {"gap.soft": 0.0, "diff.tb": 0, "replay": 0}
        for j in self.check_entries:
            if j not in self.kept:
                self.tally(j, self.call(j))
            rows = self.check_rows[j]
            samples = self.samples[self.rows(j)][rows].cpu().numpy()
            ref = self.reference(samples, lower=False)
            if lower:
                ours = self.reference(samples, lower=True)
            else:
                sink: dict = {}
                with tapped(self.hooks(sink)):
                    res = self.call(j)
                fin = self.finals(res, self.per)
                out["replay"] += sum(
                    int((fin[k] != self.kept[j][k]).reshape(
                        fin[k].shape[0], -1).any(-1).sum()) for k in fin)
                soft = sink.get("soft")
                if soft is not None and soft.shape[1] != self.per:
                    soft = None          # not one row a subframe: missing
                kept = self.kept[j]
                ours = dict(soft=None if soft is None
                            else soft[:, rows].float().cpu().numpy(),
                            crc=kept["crc"][:, rows].numpy(),
                            bits=kept["bits"][:, rows].cpu().numpy())
            out["gap.soft"] = max(out["gap.soft"],
                                  gap(ours["soft"], ref["soft"]))
            out["diff.tb"] += tb_diff(ours["crc"], ours["bits"],
                                      ref["crc"], ref["bits"])
            del ours, ref
        return out

    def turbo_work(self, iterations: list, n: int) -> list:
        """(K, code blocks, iterations, metric dtype) of each turbo call
        of one call on ``n`` subframes, from the configuration's
        segmentation and precision and the iterations the receiver
        returned."""
        return [(k, self.codewords * n * c, it, dt)
                for (k, c, dt), it in zip(self.segments(), iterations)]
