"""The port's eNB downlink transmitter held to TS 36.211/36.212 through the
benchmark's plain transmitter ``phybench/references/dl_tx.py``, on the CPU
at 6 and 25 PRB.

The reference composes the subframe from the specification in float64 and
imports nothing of the port. ``enb_dl_tx_batch``'s samples lie within 1e-5
of the reference's largest magnitude and decide, RE for RE, the
reference's constellation points, with two codewords and with one; the
port's PHICH is the specification's (36.211 6.9.1-6.9.3, 7.1.1; 36.212
5.3.5) for ACK and NACK in every group and sequence at N_g 1/6 and 1 and
in every subframe, and ``phich_decode`` reads back what ``phich_put``
sends. The DL-SCH's encode per K is bit for bit the per-block encode it
replaced, and what the port gave before both changes
(``tests/enb_dl_cases.py``) is unchanged: the composer's grids but at the
PHICH's REs, two-codeword PDSCH grids, and ``ue_dl_tm4_batch``'s answers
and de-rate-matched LLRs on the benchmark's tiny downlink waveform. Every
op of an ``enb_dl_tx_batch`` call that would launch a kernel lies in
exactly one stage range, none in its root range alone.
"""

import hashlib
import json
import math
import pathlib

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from empower_srslte_tpu_torch.models import dci, enb_dl, phich, ra
from empower_srslte_tpu_torch.models.pdsch import PdschConfig, pdsch_encode
from empower_srslte_tpu_torch.models.regs import nof_phich_groups
from empower_srslte_tpu_torch.models.sch import DlschPlan, dlsch_encode
from empower_srslte_tpu_torch.ops.equalizer import MimoType
from empower_srslte_tpu_torch.ops.fec.turbo_encoder import turbo_encode
from empower_srslte_tpu_torch.utils.cell import Cell
from empower_srslte_tpu_torch.utils.crc import CRC24A, CRC24B
from phybench.observe import tapped
from phybench.references import dl_tx, spec

from tests import enb_dl_cases as cases

DATA = pathlib.Path(__file__).resolve().parent / "data"
PHYBENCH = pathlib.Path(__file__).resolve().parent.parent / "phybench"
#: (MCS, CFI, UL grant's first PRB and PRBs, DCI level) of each bandwidth
GRANTS = {6: (25, 2, 1, 4, 2), 25: (27, 2, 2, 21, 4)}
#: the stage ranges of an ``enb_dl_tx_batch`` call
STAGES = {"enb_dl.control_tx", "dlsch.crc_attach", "dlsch.turbo_encode",
          "dlsch.rate_match", "pdsch.map", "enb_dl.ofdm_tx"}
#: CPU ops that launch no kernel on a card (views and metadata)
NO_LAUNCH = {"aten::slice", "aten::view", "aten::select", "aten::reshape",
             "aten::as_strided", "aten::unsqueeze", "aten::expand",
             "aten::alias", "aten::detach", "aten::lift_fresh",
             "aten::empty", "aten::unbind", "aten::squeeze", "aten::t",
             "aten::transpose", "aten::permute", "aten::_reshape_alias",
             "aten::view_as_real", "aten::resolve_conj"}


@pytest.fixture(scope="module")
def before():
    with np.load(DATA / "enb_dl_before.npz") as z:
        return {k: z[k] for k in z.files}


def _conf(prb: int) -> dict:
    mcs, cfi, ul_start, ul_n, level = GRANTS[prb]
    conf = {"nof_prb": prb, "nof_ports": 2, "cell_id": 1, "sf_idx": 1,
            "cfi": cfi, "rnti": 0x1234, "nof_layers": 2, "pmi": 0,
            "mcs": mcs, "dci_l": level, "dci_cce": 0,
            "ul_prb_start": ul_start, "ul_n_prb": ul_n, "ul_mcs": 20,
            "ul_dci_l": level, "n_dmrs": 0, "phich_ng": 1.0}
    lay = dl_tx.control_layout(conf)
    conf["ul_dci_cce"] = next(
        c for c in dl_tx.ue_candidates(0x1234, 1, lay["n_cce"], level)
        if c >= level)
    return conf


def _sent(prb: int, ncw: int, batch: int = 2):
    """The port's inputs of ``batch`` subframes of the grant of
    ``_conf(prb)``: (conf, cfg, plan, TBs, DCIs, PHICHs, dl payload, HI)."""
    conf = _conf(prb)
    cell = Cell(nof_prb=prb, nof_ports=2, id=1)
    mod, tbs = ra.mcs_to_tbs(conf["mcs"], prb)
    cfg = PdschConfig(cell=cell, sf_idx=1, cfi=conf["cfi"], rnti=0x1234,
                      mod=mod, mimo=MimoType.SPATIAL_MUX, nof_layers=2,
                      nof_codewords=ncw)
    g = torch.Generator().manual_seed(prb * 10 + ncw)
    tb = [torch.randint(0, 2, (batch, tbs), generator=g, dtype=torch.int8)
          for _ in range(ncw)]
    payload = torch.randint(0, 2, (dci.format1_size(prb),), generator=g,
                            dtype=torch.int8)
    hi = int(torch.randint(0, 2, (1,), generator=g))
    ul = torch.as_tensor(dci.pack_format0(prb, conf["ul_prb_start"],
                                          conf["ul_n_prb"], conf["ul_mcs"]))
    dcis = [(payload, 0x1234, 0, conf["dci_l"]),
            (ul, 0x1234, conf["ul_dci_cce"], conf["ul_dci_l"])]
    phichs = [(hi, *phich.phich_resource(cell, conf["ul_prb_start"]))]
    return conf, cfg, cfg.plan(tbs), tb, dcis, phichs, payload, hi


@pytest.mark.parametrize("ncw", [2, 1])
@pytest.mark.parametrize("prb", [6, 25])
def test_samples_are_the_specifications(prb, ncw):
    conf, cfg, plan, tb, dcis, phichs, payload, hi = _sent(prb, ncw)
    x = enb_dl.enb_dl_tx_batch(tb[0], cfg, plan,
                               tb2=tb[1] if ncw == 2 else None, dcis=dcis,
                               phichs=phichs)
    ref = dl_tx.transmit([t.numpy() for t in tb], conf, payload.numpy(),
                         hi)
    assert x.shape == ref["samples"].shape and x.dtype == torch.complex64
    gap = float((x.to(torch.complex128) - ref["samples"]).abs().max()
                / ref["samples"].abs().max())
    assert gap < 1e-5, gap
    assert dl_tx.decided_apart(x.numpy(), ref, prb) == 0
    # the decision radius is not loose: the grid the port's samples give
    # lies far closer to the reference's than any radius
    got = dl_tx.demodulate(x.numpy(), prb)
    assert float(((got - ref["grid"]).abs() / ref["radius"]).max()) < 1e-3
    assert plan.g == dl_tx.pdsch_g(conf, ncw)


@pytest.mark.parametrize("ng", [1 / 6, 1.0])
@pytest.mark.parametrize("prb", [6, 25])
def test_phich_is_the_specifications(prb, ng):
    """Every subframe, group, sequence and HI at N_g ``ng``: the port's
    HI on an empty grid equals the reference's PHICH (6.9), RE for RE."""
    cell = Cell(nof_prb=prb, nof_ports=2, id=1)
    conf = {"nof_prb": prb, "cell_id": 1, "cfi": 1}
    groups = nof_phich_groups(cell, ng)
    assert groups == math.ceil(ng * prb / 8)
    empty = torch.zeros((2, 14, cell.nof_re), dtype=torch.complex64)
    for sf in range(10):
        conf["sf_idx"] = sf
        for group in range(groups):
            for seq in range(8):
                for hi in (0, 1):
                    got = phich.phich_put(empty, hi, cell, sf, group, seq,
                                          ng)
                    ref = dl_tx.phich_region(conf, [(hi, group, seq)], ng)
                    n = ref.shape[1]
                    assert not got[:, n:].any()
                    assert float((got[:, :n].to(torch.complex128)
                                  - ref).abs().max()) < 1e-6, \
                        (sf, group, seq, hi)


def test_phich_symbols_are_the_specifications():
    """d(i) = w(i mod 4) (1 - 2 c(i)) z(floor(i / 4)) with z the BPSK of
    the HI's coded bit: ACK (1) at -(1 + j)/sqrt(2), NACK at
    (1 + j)/sqrt(2); c_init = (floor(n_s / 2) + 1)(2 N_ID + 1) 2^9 +
    N_ID."""
    d = dl_tx.phich_symbols(1, 0, 0, 0)
    c = spec.gold(1 << 9, 12)
    want = (1 - 2 * c.astype(float)) * -(1 + 1j) / math.sqrt(2)
    assert np.allclose(d.numpy(), want)
    assert np.allclose(dl_tx.phich_symbols(0, 0, 0, 0).numpy(), -want)


@pytest.mark.parametrize("ports", [1, 2])
def test_phich_decode_reads_back_what_phich_put_sends(ports):
    cell = Cell(nof_prb=25, nof_ports=ports, id=3)
    g = torch.Generator().manual_seed(ports)

    def cn(*shape):
        return torch.complex(torch.randn(shape, generator=g),
                             torch.randn(shape, generator=g)) / math.sqrt(2)

    for sf in range(10):
        for group, seq in ((0, 0), (3, 5), (1, 7)):
            for hi in (0, 1):
                grid = phich.phich_put(
                    torch.zeros((1, ports, 14, cell.nof_re),
                                dtype=torch.complex64), hi, cell, sf, group,
                    seq)
                gain = cn(1, ports, 1, 1)
                y = (gain * grid).sum(1) + 0.05 * cn(1, 14, cell.nof_re)
                h = gain.expand(1, ports, 14, cell.nof_re)
                ack, metric = phich.phich_decode(
                    y, h if ports > 1 else h[:, 0], cell, sf, group, seq,
                    noise_est=0.0025)
                assert bool(ack[0]) == bool(hi) and \
                    float(metric[0]) * (2 * hi - 1) > 0.5, (sf, group, seq)


def _old_dlsch_encode(tb_bits, plan):
    """The DL-SCH encode before it took one K at a time: every code block
    segmented, CRC'd, turbo encoded and rate matched on its own."""
    segm = plan.segm
    lead = tb_bits.shape[:-1]
    full = torch.cat([tb_bits.to(torch.int8),
                      CRC24A.compute(tb_bits).to(torch.int8)], dim=-1)
    out, pos = [], 0
    for k, e, f, _ in plan.cb_plans:
        payload = k - f - (24 if segm.c > 1 else 0)
        cb = full[..., pos:pos + payload]
        pos += payload
        if f:
            cb = torch.cat([torch.zeros((*lead, f), dtype=torch.int8), cb],
                           dim=-1)
        if segm.c > 1:
            cb = torch.cat([cb, CRC24B.compute(cb).to(torch.int8)], dim=-1)
        out.append(plan.rm(k, f).tx(turbo_encode(cb), plan.rv, e))
    return torch.cat(out, dim=-1)


@pytest.mark.parametrize("tbs,g,qm,rv", [
    (100, 480, 2, 0),            # one block with filler bits
    (6200, 20000, 4, 1),         # two blocks of one K
    (15000, 45000, 6, 2),        # K- and K+ blocks, filler bits
    (20000, 31000, 2, 3),        # K- and K+ blocks at rv 3
    (3496, 6912, 6, 0)])         # a table TBS, one block
def test_dlsch_encode_per_k_is_the_per_block_encode(tbs, g, qm, rv):
    plan = DlschPlan(tbs=tbs, g=g, qm=qm, rv=rv)
    tb = torch.randint(0, 2, (3, tbs), generator=torch.Generator()
                       .manual_seed(tbs), dtype=torch.int8)
    got = dlsch_encode(tb, plan)
    assert got.dtype == torch.int8 and got.shape == (3, g)
    assert torch.equal(got, _old_dlsch_encode(tb, plan))
    # two codewords of one plan stacked encode as each alone
    both = dlsch_encode([tb, tb.flip(0)], plan)
    assert torch.equal(both[1], _old_dlsch_encode(tb.flip(0), plan))


@pytest.mark.parametrize("name", [c[0] for c in cases.SUBFRAMES])
def test_composer_unchanged_but_at_the_phich(before, name):
    """On 1 and 2 ports the grids are as before but at the PHICH's REs.
    On 4 ports the control region's PDCCHs and PHICH take SFBC-FSTD (36.211
    6.8.4, 6.9.2), where they took SFBC on ports 0 and 1: the PDSCH's
    symbols are as before and the control region is the reference's."""
    cell, sf, cfi, dcis, phichs, pdschs = cases.subframe(name)
    got = enb_dl.enb_dl_subframe(cell, sf, cfi, dcis=dcis, phichs=phichs,
                                 pdschs=pdschs, device="cpu").numpy()
    bare = enb_dl.enb_dl_subframe(cell, sf, cfi, dcis=dcis, pdschs=pdschs,
                                  device="cpu").numpy()
    if cell.nof_ports == 4:
        from phybench.references import dl_tm2

        conf = {"nof_prb": cell.nof_prb, "cell_id": cell.id, "sf_idx": sf,
                "cfi": cfi, "rnti": cases.RNTI}
        pdcchs = [(bits, level, cce) for bits, _rnti, cce, level in dcis]
        for grid, old, his in ((got, before["grid_" + name], phichs),
                               (bare, before["nophich_" + name], [])):
            ctrl = dl_tm2.control_region(conf, pdcchs, his).numpy()
            n = ctrl.shape[1]
            assert np.array_equal(grid[:, n:], old[:, n:])
            crs = np.zeros(ctrl.shape, bool)
            for p in range(4):
                syms, offs, _v = dl_tm2.crs(cell.id, cell.nof_prb, sf, p)
                for sym, off in zip(syms, offs):
                    if sym < n:
                        crs[p, sym, off::6] = True
            want = np.where(crs, old[:, :n], 0) + ctrl
            assert np.abs(grid[:, :n] - want).max() < 1e-6
        return
    assert np.array_equal(bare, before["nophich_" + name])
    at = np.zeros(got.shape, bool)
    at[:min(2, cell.nof_ports), 0,
       phich._group_re_indices(cell, 1.0, phichs[0][1])] = True
    assert np.array_equal(got[~at], before["grid_" + name][~at])
    assert not np.allclose(got[at], before["grid_" + name][at])


@pytest.mark.parametrize("name", [c[0] for c in cases.TM4])
def test_two_codeword_pdsch_unchanged(before, name):
    cfg, plan, tb, tb2 = cases.tm4(name)
    assert np.array_equal(pdsch_encode(tb, cfg, plan, tb2, plan).numpy(),
                          before["tm4_" + name])


def test_receiver_unchanged_on_the_benchmark_waveform(before):
    """``ue_dl_tm4_batch``'s answers and its de-rate-matched LLRs (the
    benchmark's hook, ``pdsch_decode``'s third result) on the tiny
    downlink cell's waveform, bit for bit as before."""
    from phybench.drivers.ue_dl_tm4_batch import Driver
    from empower_srslte_tpu_torch.models import ue_dl

    data = PHYBENCH / "tests" / "data"
    drv = Driver(json.loads((data / "tiny_dl.json").read_text()),
                 json.loads((data / "tiny_b2.json").read_text()),
                 cases.RX_SEED, "cpu")
    samples = drv.samples[:2]
    assert hashlib.sha256(samples.numpy().tobytes()).digest() == \
        before["rx_samples_sha"].tobytes()
    sink: dict = {}
    with tapped(drv.hooks(sink)):
        out = ue_dl.ue_dl_tm4_batch(samples, drv.cfg, drv.plan)
    assert np.array_equal(out.cfi.numpy(), before["rx_cfi"])
    assert np.array_equal(out.dci_hits.numpy(), before["rx_dci_hits"])
    assert np.array_equal(torch.stack(out.tb_bits).numpy(),
                          before["rx_bits"])
    assert np.array_equal(torch.stack(out.crc_ok).numpy(), before["rx_crc"])
    assert list(out.iterations) == before["rx_iterations"].tolist()
    assert np.array_equal(sink["soft"].numpy(), before["rx_soft"])


def _inside(e, r) -> bool:
    return (e is not r and r.time_range.start <= e.time_range.start
            and e.time_range.end <= r.time_range.end)


def test_every_launch_of_a_call_is_in_one_stage_range():
    """Under the root ``enb_dl.tx_batch``, every op that would launch a
    kernel on a card lies in exactly one stage range; the stage ranges
    are disjoint and inside the root."""
    _conf6, cfg, plan, tb, dcis, phichs, _p, _hi = _sent(6, 2)
    args = (tb[0], cfg, plan)
    kw = dict(tb2=tb[1], dcis=dcis, phichs=phichs)
    enb_dl.enb_dl_tx_batch(*args, **kw)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        enb_dl.enb_dl_tx_batch(*args, **kw)
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    root, = [e for e in cpu if e.name == "enb_dl.tx_batch"]
    ranges = [e for e in cpu if e.name in STAGES]
    assert {r.name for r in ranges} == STAGES
    assert all(_inside(r, root) for r in ranges)
    assert not any(_inside(a, b) for a in ranges for b in ranges)
    ops, end = [], -1
    for e in sorted((e for e in cpu if e.name.startswith("aten::")),
                    key=lambda e: (e.time_range.start, -e.time_range.end)):
        if e.time_range.start >= end:            # not inside another op
            ops.append(e)
            end = e.time_range.end
    assert ops and all(_inside(e, root) for e in ops)
    outside = {e.name for e in ops if e.name not in NO_LAUNCH
               and sum(_inside(e, r) for r in ranges) != 1}
    assert outside == set(), outside


# --- departures off this cell's path, and a repaired one -----------------


@pytest.mark.parametrize("prb", [6, 25, 100])
def test_pcfich_regs_depart_at_cell_ids_divisible_by_three(prb):
    """36.211 6.7.4 puts the PCFICH's REG i at subcarrier k_bar + i N_RB/2
    N_sc/2, the REG that starts there. ``regs.pcfich_regs`` takes the REG
    whose first RE that is not a CRS RE lies at or below that k: where the
    CRS shift v_shift is 0 or 3 (N_ID divisible by 3) the REG starts with
    a CRS RE and it takes the REG before. The PCFICH, and the PHICH and
    PDCCH REGs it leaves, then depart; the cell's N_ID 1 does not. Pinned
    here until the repair (ROADMAP section 1), which changes this test."""
    from empower_srslte_tpu_torch.models.pcfich import pcfich_put

    for cid in range(12):
        cell = Cell(nof_prb=prb, nof_ports=2, id=cid)
        conf = {"nof_prb": prb, "cell_id": cid, "cfi": 1, "sf_idx": 1,
                "rnti": 1}
        got = pcfich_put(torch.zeros((2, 14, cell.nof_re),
                                     dtype=torch.complex64), 1, cell, 1)
        ref = dl_tx.control_region(conf, [], [])
        apart = float((got[:, :ref.shape[1]].to(torch.complex128)
                       - ref).abs().max())
        assert (apart > 0.5) == (cid % 3 == 0), (cid, apart)


def test_dlsch_e_split_takes_one_layer_where_36212_takes_two():
    """36.212 5.1.4.1.2 splits G into the code blocks' E in units of N_L
    Q_m with N_L 2 for a TB on two layers or on transmit diversity. The
    port took N_L 1 on transmit diversity, so this grant's blocks got
    other E than the specification's; ``PdschConfig.plan`` now gives
    ``DlschPlan.n_layers`` 2 there, and the same grant splits as 36.212
    does (N_L 1 would not). The cell's two codewords map one layer each
    and split with N_L 1."""
    cell = Cell(nof_prb=25, nof_ports=4, id=1)
    mod, tbs = ra.mcs_to_tbs(23, 25)
    cfg = PdschConfig(cell=cell, sf_idx=1, cfi=1, mod=mod,
                      mimo=MimoType.DIVERSITY, nof_layers=4)
    plan = cfg.plan(tbs)
    c = plan.segm.c
    assert plan.n_layers == 2
    assert list(plan.e_sizes) == spec.e_sizes(plan.g, c, plan.qm, 2)
    assert list(plan.e_sizes) != spec.e_sizes(plan.g, c, plan.qm, 1)
    cell = Cell(nof_prb=100, nof_ports=2, id=1)
    mod, tbs = ra.mcs_to_tbs(28, 100)
    plan2 = PdschConfig(cell=cell, sf_idx=1, cfi=1, mod=mod,
                        mimo=MimoType.SPATIAL_MUX, nof_layers=2,
                        nof_codewords=2).plan(tbs)
    assert plan2.n_layers == 1
    assert list(plan2.e_sizes) == spec.e_sizes(plan2.g, plan2.segm.c,
                                               plan2.qm, 1)
