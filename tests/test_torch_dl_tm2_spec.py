"""A 4-port cell's transmit-diversity downlink held to TS 36.211/36.212
through the benchmark's plain reference ``phybench/references/dl_tm2.py``,
on the CPU.

The reference is written from the specification in float64 and imports
nothing of the port. On a 4-port cell the port's PCFICH and PDCCH, its
PHICH (SFBC-FSTD with the port pairs of 36.211 6.9.2) and its PBCH are
the specification's RE for RE, and its decoders read back what the
reference sends; the PDCCH region's LLRs (the kernel's twin) are the
reference's combine; the DL-SCH's E split takes N_L 2 on transmit
diversity and on one codeword over two layers (36.212 5.1.4.1.2); the
benchmark's transmitter (``phybench/inputs/dl_tm2.py``) sends the
reference's grids; and ``ue_dl_tm2_batch`` decodes it as the reference
does: its de-rate-matched LLRs within the cell's ``gap.soft`` limit, the
same TB answers, the CFI and a DCI in every subframe. Every op of a call
that would launch a kernel lies in exactly one stage range.
"""

import json
import math
import pathlib

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from empower_srslte_tpu_torch.models import dci, pbch, phich, ra, ue_dl
from empower_srslte_tpu_torch.models.pcfich import pcfich_put
from empower_srslte_tpu_torch.models.pdcch import (_pdcch_extract_llr_plain,
                                                   pdcch_encode)
from empower_srslte_tpu_torch.models.pdsch import PdschConfig
from empower_srslte_tpu_torch.models.regs import nof_phich_groups
from empower_srslte_tpu_torch.ops.equalizer import MimoType
from empower_srslte_tpu_torch.utils.cell import Cell
from phybench.references import dl_pdsch, dl_tm2, spec

PHYBENCH = pathlib.Path(__file__).resolve().parent.parent / "phybench"
CONF = json.loads((PHYBENCH / "configs" / "dl_tm2_20mhz_4port.json")
                  .read_text())
LIMITS = json.loads((PHYBENCH / "limits" / "dl_tm2_4p_b256.json")
                    .read_text())
#: (CFI, MCS) of each bandwidth's grant
GRANTS = {6: (3, 20), 25: (2, 24), 100: (1, 28)}
#: the stage ranges of a batched receiver call
STAGES = {"ue_dl.ofdm_rx", "ue_dl.chest_noise", "ue_dl.pdcch_llr",
          "ue_dl.pdcch_blind_search", "pdsch.eq_demod", "dlsch.derm",
          "dlsch.turbo_decode", "dlsch.crc_reassembly"}
#: CPU ops that launch no kernel on a card (views and metadata)
NO_LAUNCH = {"aten::slice", "aten::view", "aten::select", "aten::reshape",
             "aten::as_strided", "aten::unsqueeze", "aten::expand",
             "aten::alias", "aten::detach", "aten::lift_fresh",
             "aten::empty", "aten::unbind", "aten::squeeze", "aten::t",
             "aten::transpose", "aten::permute", "aten::_reshape_alias",
             "aten::view_as_real", "aten::resolve_conj"}


def _conf(prb: int) -> dict:
    """The cell's configuration at ``prb`` PRB: its grant's TBS, G and
    the E of 36.212 5.1.4.1.2 at N_L 2."""
    cfi, mcs = GRANTS[prb]
    conf = dict(CONF, nof_prb=prb, cfi=cfi, mcs=mcs)
    _mod, tbs = ra.mcs_to_tbs(mcs, prb)
    c, ks, _f = spec.segmentation(tbs)
    qm = dl_pdsch.qm_of_mcs(mcs)
    g = len(dl_tm2.pdsch_res(1, prb, cfi, 1)) * qm
    conf.update(tbs=tbs, g=g, code_blocks={
        "count": c, "k": ks[-1], "e": spec.e_sizes(g, c, qm, 2)})
    return conf


def _cell(conf: dict) -> Cell:
    return Cell(nof_prb=conf["nof_prb"], nof_ports=4, id=conf["cell_id"])


def _unit_channel(gen, *shape) -> torch.Tensor:
    phase = torch.rand(shape, generator=gen, dtype=torch.float64) * math.tau
    return torch.polar(torch.ones_like(phase), phase)


# --- the E split, TS 36.212 5.1.4.1.2 -------------------------------------


@pytest.mark.parametrize("prb,ports,cfi,mcs", [
    (25, 4, 1, 23), (25, 2, 2, 24), (50, 4, 3, 20), (100, 4, 1, 28),
    (100, 2, 2, 27), (75, 4, 2, 26)])
def test_tm2_e_split_takes_two_layers(prb, ports, cfi, mcs):
    cell = Cell(nof_prb=prb, nof_ports=ports, id=1)
    mod, tbs = ra.mcs_to_tbs(mcs, prb)
    plan = PdschConfig(cell=cell, sf_idx=1, cfi=cfi, mod=mod,
                       mimo=MimoType.DIVERSITY, nof_layers=ports).plan(tbs)
    assert plan.n_layers == 2
    assert list(plan.e_sizes) == spec.e_sizes(plan.g, plan.segm.c, plan.qm,
                                              2)


def test_cells_e_sizes():
    """The benchmark cell's grant: G 81,600 in 13 blocks, 12 of 6,276 bits
    and 1 of 6,288; N_L 1 would give 11 and 2 of 6,282."""
    conf = _conf(100)
    cell = _cell(conf)
    mod, tbs = ra.mcs_to_tbs(28, 100)
    plan = PdschConfig(cell=cell, sf_idx=1, cfi=1, mod=mod,
                       mimo=MimoType.DIVERSITY, nof_layers=4).plan(tbs)
    assert (tbs, plan.g) == (CONF["tbs"], CONF["g"]) == (75376, 81600)
    assert list(plan.e_sizes) == CONF["code_blocks"]["e"] == \
        [6276] * 12 + [6288] == spec.e_sizes(81600, 13, 6, 2)
    assert spec.e_sizes(81600, 13, 6, 1) == [6276] * 11 + [6282] * 2


@pytest.mark.parametrize("mimo,layers,cws,n_l", [
    (MimoType.SPATIAL_MUX, 2, 1, 2), (MimoType.CDD, 2, 1, 2),
    (MimoType.SPATIAL_MUX, 2, 2, 1), (MimoType.SINGLE, 1, 1, 1)])
def test_other_schemes_split_as_36212(mimo, layers, cws, n_l):
    """One codeword on two layers takes N_L 2; two codewords on two
    layers one each, and one port one."""
    cell = Cell(nof_prb=25, nof_ports=2 if layers == 2 else 1, id=1)
    mod, tbs = ra.mcs_to_tbs(24, 25)
    plan = PdschConfig(cell=cell, sf_idx=1, cfi=2, mod=mod, mimo=mimo,
                       nof_layers=layers, nof_codewords=cws).plan(tbs)
    assert plan.n_layers == n_l
    assert list(plan.e_sizes) == spec.e_sizes(plan.g, plan.segm.c, plan.qm,
                                              n_l)


# --- the control channels on 4 ports ---------------------------------------


@pytest.mark.parametrize("prb", [6, 25, 100])
def test_pdcch_and_pcfich_are_the_specification(prb):
    """36.211 6.7 and 6.8.4 on 4 ports: the port's PCFICH and PDCCH
    (SFBC-FSTD) equal the reference's, RE for RE, at each level."""
    conf = _conf(prb)
    cell = _cell(conf)
    gen = torch.Generator().manual_seed(prb)
    bits = torch.randint(0, 2, (dci.format1_size(prb),), generator=gen,
                         dtype=torch.int8)
    for level, cce in ((1, 1), (2, 2), (4, 0), (8, 0)):
        if prb == 6 and level == 8:
            continue
        conf.update(dci_l=level, dci_cce=cce)
        grid = pcfich_put(torch.zeros((4, 14, cell.nof_re),
                                      dtype=torch.complex64),
                          conf["cfi"], cell, 1) + pdcch_encode(
            bits, conf["rnti"], cce, level, cell, conf["cfi"], 1)
        ref = dl_tm2.control_region(conf, [(bits.numpy(), level, cce)])
        n = ref.shape[1]
        assert (grid[:, :n].to(torch.complex128) - ref).abs().max() < 1e-6
        assert int((ref.abs() > 0).sum()) == 2 * (16 + 36 * level)
        assert not grid[:, n:].abs().any()


def test_region_llrs_are_the_reference_combine():
    """The kernel's twin on a 4-port channel: each quadruplet's first
    pair combined on ports 0 and 2, its second on 1 and 3, as the
    reference combines them."""
    conf = _conf(25)
    cell = _cell(conf)
    gen = torch.Generator().manual_seed(3)
    grid = torch.randn((2, 14, cell.nof_re), generator=gen,
                       dtype=torch.complex64)
    h = torch.randn((2, 4, 14, cell.nof_re), generator=gen,
                    dtype=torch.complex64)
    got = _pdcch_extract_llr_plain(grid, h, cell, conf["cfi"], 1, 0.01)
    ref = dl_tm2.pdcch_llrs(grid.to(torch.complex128),
                            h.to(torch.complex128), conf)
    assert got.shape == ref.shape
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


@pytest.mark.parametrize("ack", [0, 1])
def test_phich_is_the_specification(ack):
    """36.211 6.9.2 on 4 ports: SFBC-FSTD with the port pairs alternating
    on (i + n_group) mod 2, in every group; ``phich_decode`` reads the
    reference's HI back over a unit-modulus channel per port."""
    conf = _conf(25)
    cell = _cell(conf)
    gen = torch.Generator().manual_seed(ack)
    empty = dl_tm2.control_region(conf, [])
    for group in range(nof_phich_groups(cell, 1.0)):
        seq = (3 * group + ack) % 8
        grid = phich.phich_put(torch.zeros((4, 14, cell.nof_re),
                                           dtype=torch.complex64),
                               ack, cell, 1, group, seq)
        ref = dl_tm2.control_region(conf, [], [(ack, group, seq)]) - empty
        assert (grid[:, :ref.shape[1]].to(torch.complex128)
                - ref).abs().max() < 1e-6
        h = _unit_channel(gen, 4)
        rx = torch.zeros((14, cell.nof_re), dtype=torch.complex128)
        rx[:ref.shape[1]] = torch.einsum("p,psk->sk", h, ref)
        hh = h[:, None, None].expand(4, 14, cell.nof_re)
        got, metric = phich.phich_decode(rx.to(torch.complex64),
                                         hh.to(torch.complex64), cell, 1,
                                         group, seq)
        assert bool(got) == bool(ack) and abs(float(metric)) > 0.9


def test_pbch_is_the_specification():
    """36.211 6.6.3 on 4 ports: the port's PBCH equals the reference's
    SFBC-FSTD symbols on its 240 REs in each frame, and ``pbch_decode``
    reads the MIB and 4 ports back."""
    cell = Cell(nof_prb=6, nof_ports=4, id=7)
    gen = torch.Generator().manual_seed(11)
    mib = pbch.mib_pack(6, 0, 1, 4 * 37)
    for sfn in range(4 * 37, 4 * 37 + 4):
        grid = pbch.pbch_put(torch.zeros((4, 14, cell.nof_re),
                                         dtype=torch.complex64),
                             torch.as_tensor(mib), cell, sfn)
        res, ref = dl_tm2.pbch_ports(mib, 6, 7, sfn)
        flat = grid.reshape(4, -1).to(torch.complex128)
        assert (flat[:, res] - ref).abs().max() < 1e-6
        mask = torch.ones(flat.shape[-1], dtype=torch.bool)
        mask[torch.as_tensor(res)] = False
        assert not flat[:, mask].abs().any()
        h = _unit_channel(gen, 4)
        rx = torch.zeros(14 * cell.nof_re, dtype=torch.complex128)
        rx[torch.as_tensor(res)] = h @ ref
        hh = h[:, None, None].expand(4, 14, cell.nof_re)
        bits, q, ports, ok = pbch.pbch_decode(
            rx.reshape(14, -1).to(torch.complex64)[None],
            hh.to(torch.complex64)[None], cell)
        assert bool(ok[0]) and int(ports[0]) == 4 and int(q[0]) == sfn % 4
        assert np.array_equal(bits[0].numpy(), mib)


# --- the benchmark's transmitter and the receiver ---------------------------


@pytest.mark.parametrize("prb", [6, 100])
def test_transmitter_grid_is_the_specification(prb):
    """``phybench/inputs/dl_tm2.py``'s ports (the frozen encoders, its own
    PDCCH) equal, RE for RE, the reference's CRS, PCFICH, PDCCH and
    PDSCH."""
    from phybench.inputs import dl_tm2 as tx

    conf = _conf(prb)
    gen = torch.Generator().manual_seed(prb)
    out = tx.transmit(conf, {"snr_db": 30.0}, 1, gen, "cpu")
    ref = dl_tm2.pdsch_ports(out["tb"], conf)
    ctrl = dl_tm2.control_region(conf, [(
        out["dci_bits"].numpy(), conf["dci_l"], conf["dci_cce"])])
    ref[:, :, :ctrl.shape[1]] = ctrl
    for p in range(4):
        syms, offs, vals = dl_tm2.crs(1, prb, 1, p)
        for s, o, v in zip(syms, offs, vals):
            ref[:, p, s, o::6] = torch.as_tensor(v)
    assert (out["grid"].to(torch.complex128) - ref).abs().max() < 1e-6


@pytest.fixture(scope="module")
def traffic():
    return {"subframes_per_call": 2, "pool_subframes": 2,
            "draw_subframes": 2, "snr_db": 30.0, "check_calls": 1,
            "check_subframes": 2}


@pytest.mark.parametrize("prb", [6, 25])
def test_receiver_decodes_as_the_reference(prb, traffic):
    """``ue_dl_tm2_batch`` on the benchmark's waveform at 4 ports and 2 rx,
    against the reference: its de-rate-matched LLRs within the cell's
    ``gap.soft`` limit, the same TB answers, the sent bits, the CFI and
    a DCI in every subframe."""
    from phybench.drivers.ue_dl_tm2_batch import Driver

    drv = Driver(_conf(prb), traffic, 2**31 + prb, "cpu")
    drv.tally(0, drv.call(0))
    totals = drv.totals()
    assert totals["delivered"] == totals["attempted"] == 2
    assert totals["counts"] == {"cfi_wrong": 0, "dci_missed": 0}
    got = drv.check()
    assert 0 < got["gap.soft"] <= LIMITS["gap.soft"], got
    assert got["diff.tb"] == 0 and got["replay"] == 0, got


def _inside(e, r) -> bool:
    return (e is not r and r.time_range.start <= e.time_range.start
            and e.time_range.end <= r.time_range.end)


def test_every_launch_of_a_call_is_in_one_stage_range(traffic):
    """Under the root ``ue_dl.tm2_batch``, every op that would launch a
    kernel on a card lies in exactly one stage range."""
    from phybench.drivers.ue_dl_tm2_batch import Driver

    drv = Driver(_conf(6), traffic, 2**31 + 1, "cpu")
    samples = drv.samples
    ue_dl.ue_dl_tm2_batch(samples, drv.cfg, drv.plan)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ue_dl.ue_dl_tm2_batch(samples, drv.cfg, drv.plan)
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    root, = [e for e in cpu if e.name == "ue_dl.tm2_batch"]
    ranges = [e for e in cpu if e.name in STAGES]
    assert {r.name for r in ranges} == STAGES
    assert all(_inside(r, root) for r in ranges)
    ops, end = [], -1
    for e in sorted((e for e in cpu if e.name.startswith("aten::")),
                    key=lambda e: (e.time_range.start, -e.time_range.end)):
        if e.time_range.start >= end:
            ops.append(e)
            end = e.time_range.end
    outside = {e.name for e in ops if e.name not in NO_LAUNCH
               and sum(_inside(e, r) for r in ranges) != 1}
    assert outside == set(), outside
