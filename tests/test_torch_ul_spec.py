"""The port's uplink held to TS 36.211 through the benchmark's plain
uplink reference, on the CPU at 6 and 25 PRB.

``phybench/inputs/ul_pusch.py`` is the benchmark's uplink transmitter (its
SC-FDMA and DMRS written from 36.211 5.6 and 5.5.2.1.1) and
``phybench/references/ul_pusch.py`` its plain receiver, which imports
nothing of the port. The port's batched eNB entry ``enb_ul_pusch_batch``
decodes the transmitter's subframes to the sent TB, HARQ-ACK, RI and CQI,
and its UL-SCH de-rate-matched LLRs agree with the reference's; the
port's SC-FDMA grid and PUSCH DMRS equal the reference's, and its UE
transmitter's samples the benchmark transmitter's. Every kernel launch
of an ``enb_ul_pusch_batch`` call falls in a stage range, none in its root
range alone. The downlink's ``ofdm_rx_sf`` is held bit for bit to the
code it ran before the uplink's SC-FDMA pair was written.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from empower_srslte_tpu_torch.models import pusch, ra, ue_ul
from empower_srslte_tpu_torch.models.refsignal_ul import pusch_dmrs
from empower_srslte_tpu_torch.ops.ofdm import ofdm_rx_sf
from empower_srslte_tpu_torch.utils.cell import Cell
from phybench.inputs import ul_pusch as tx
from phybench.references import ul_pusch as ref

#: (cell PRBs, grant PRBs, first PRB) of the cases
GRANTS = {6: (4, 1), 25: (24, 0)}
N0, H, MCS = 1e-3, (0.95, 0.1), 20
#: the stage ranges of an ``enb_ul_pusch_batch`` call
STAGES = {"enb_ul.fft", "pusch.chest", "pusch.eq_demod", "pusch.uci_demux",
          "uci.cqi_decode", "dlsch.derm", "dlsch.turbo_decode",
          "dlsch.crc_reassembly", "turbo.stop_read"}
#: CPU ops that launch no kernel on a card (views and metadata)
NO_LAUNCH = {"aten::slice", "aten::view", "aten::select", "aten::reshape",
             "aten::as_strided", "aten::unsqueeze", "aten::expand",
             "aten::alias", "aten::detach", "aten::lift_fresh",
             "aten::empty", "aten::unbind", "aten::squeeze", "aten::t",
             "aten::transpose", "aten::permute", "aten::_reshape_alias"}


def _conf(prb: int) -> dict:
    n_prb, start = GRANTS[prb]
    return {"nof_prb": prb, "cell_id": 1, "sf_idx": 1, "rnti": 0x1234,
            "prb_start": start, "n_prb": n_prb, "mcs": MCS, "ack": [1, 0],
            "ri": 1, "max_iterations": 5}


def _port_plan(conf: dict, payload: dict):
    cell = Cell(nof_prb=conf["nof_prb"], nof_ports=1, id=conf["cell_id"])
    mod, tbs = ra.mcs_to_tbs(conf["mcs"], conf["n_prb"], dl=False)
    cfg = pusch.PuschConfig(cell=cell, sf_idx=conf["sf_idx"],
                            rnti=conf["rnti"], mod=mod,
                            prb_start=conf["prb_start"], n_prb=conf["n_prb"])
    return cfg, pusch.UciPlan(cfg, tbs, pusch.UciData(**payload),
                              decoder_impl="windowed")


@pytest.fixture(scope="module", params=sorted(GRANTS))
def sent(request):
    """Three subframes of the benchmark's transmitter at one cell size,
    with a CQI report and TB bits drawn from fixed seeds."""
    conf = _conf(request.param)
    host = torch.Generator()
    host.manual_seed(100 + request.param)
    payload = tx.uci_payload(conf, host)
    conf["tbs"] = tx.plan(conf, payload)[1].tbs
    gen = torch.Generator()
    gen.manual_seed(2**31 + request.param)
    out = tx.transmit(conf, {"h": H, "n0": N0}, payload, 3, gen, "cpu")
    cfg, plan = _port_plan(conf, payload)
    assert plan.tbs == conf["tbs"]
    return dict(conf=conf, payload=payload, cfg=cfg, plan=plan, **out)


def test_enb_entry_decodes_the_specification_waveform(sent):
    res = ue_ul.enb_ul_pusch_batch(sent["samples"], sent["cfg"],
                                   sent["plan"], N0)
    assert res.crc_ok.all()
    assert torch.equal(res.tb_bits, sent["tb"])
    ack = sent["payload"]["ack"]
    assert len(res.ack) == len(ack)
    for got, bit in zip(res.ack, ack):
        assert (got == bit).all()
    assert (res.ri == sent["payload"]["ri"]).all()
    cqi = torch.tensor(sent["payload"]["cqi_bits"], dtype=torch.int8)
    assert (res.cqi_bits == cqi).all() and res.cqi_ok.all()
    assert res.iterations and all(1 <= it <= 5 for it in res.iterations)


def test_derm_llrs_agree_with_the_reference(sent):
    """The UL-SCH's de-rate-matched LLRs (``pusch_decode_uci``'s
    ``softbuffers``) within 1e-5 of the reference's largest magnitude."""
    grid = ue_ul.enb_ul_receive_grid(sent["samples"], sent["cfg"].cell)
    out = pusch.pusch_decode_uci(grid, sent["cfg"], sent["plan"],
                                 noise_est=N0)
    ours = torch.stack(list(out["softbuffers"]), dim=-2).numpy()
    want = ref.receive(sent["samples"].numpy(), sent["conf"], N0,
                       len(sent["payload"]["cqi_bits"]))
    assert want["crc"].all()
    assert ours.shape == want["soft"].shape
    scale = np.abs(want["soft"]).max()
    assert np.abs(ours - want["soft"]).max() <= 1e-5 * scale


@pytest.mark.parametrize("prb", sorted(GRANTS))
def test_grid_equals_the_reference_sc_fdma_demod(prb):
    cell = Cell(nof_prb=prb, nof_ports=1, id=1)
    rng = np.random.default_rng(prb)
    x = (rng.normal(size=(2, cell.sf_sample_len))
         + 1j * rng.normal(size=(2, cell.sf_sample_len))).astype(np.complex64)
    got = ue_ul.enb_ul_receive_grid(torch.as_tensor(x), cell).numpy()
    want = ref.sc_fdma_demod(x, prb)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("cell_id", [0, 1, 29, 30, 61, 167, 503])
def test_dmrs_equals_the_reference(cell_id):
    for n_prb in (3, 4, 24, 96):
        for sf in range(10):
            got = pusch_dmrs(Cell(nof_prb=100, nof_ports=1, id=cell_id),
                             n_prb, sf_idx=sf)
            want = ref.dmrs(cell_id, n_prb, sf)
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_ue_transmitter_equals_the_benchmark_transmitter(sent):
    """The port's UE (``ue_ul_generate`` with the UCI plan) sends the
    benchmark transmitter's noiseless samples within float32 rounding."""
    got = ue_ul.ue_ul_generate(sent["cfg"].cell,
                               pusch=(sent["tb"], sent["cfg"], sent["plan"]))
    conf, cell = sent["conf"], sent["cfg"].cell
    grid = tx.pusch_mod.pusch_encode_uci(sent["tb"],
                                         *tx.plan(conf, sent["payload"]))
    want = tx.sc_fdma_mod(grid, cell.nof_prb, cell.fft_size)
    assert got.shape == want.shape
    assert (got - want).abs().max() <= 1e-6 * want.abs().max()


def _parent_ofdm_rx_sf(samples: torch.Tensor, cell: Cell) -> torch.Tensor:
    """The downlink demodulator as it was before the uplink's SC-FDMA pair
    (the DC bin skipped, negative half first)."""
    fft, starts, pos = cell.fft_size, [], 0
    for _slot in range(2):
        for cp_len in cell.cp_len_slot:
            pos += cp_len
            starts.append(pos)
            pos += fft
    sym = torch.stack([samples[..., s:s + fft] for s in starts], dim=-2)
    spec = torch.fft.fft(sym, dim=-1)
    half = cell.nof_re // 2
    return torch.cat([spec[..., fft - half:], spec[..., 1:1 + half]], dim=-1)


@pytest.mark.parametrize("prb", [6, 100])
def test_downlink_ofdm_rx_sf_is_unchanged(prb):
    cell = Cell(nof_prb=prb, nof_ports=2, id=1)
    g = torch.Generator()
    g.manual_seed(prb)
    x = torch.randn((2, 2, cell.sf_sample_len), generator=g,
                    dtype=torch.complex64)
    assert torch.equal(ofdm_rx_sf(x, cell), _parent_ofdm_rx_sf(x, cell))


def _inside(e, r) -> bool:
    return (e is not r and r.time_range.start <= e.time_range.start
            and e.time_range.end <= r.time_range.end)


def test_every_launch_of_a_call_is_in_a_stage_range(sent):
    """Under the root ``enb_ul.pusch_batch``, every op that would launch a
    kernel on a card has a stage range as its innermost range."""
    args = (sent["samples"], sent["cfg"], sent["plan"], N0)
    ue_ul.enb_ul_pusch_batch(*args)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ue_ul.enb_ul_pusch_batch(*args)
    cpu = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    root, = [e for e in cpu if e.name == "enb_ul.pusch_batch"]
    ranges = [e for e in cpu if e.name in STAGES]
    assert {r.name for r in ranges} == STAGES
    assert all(_inside(r, root) for r in ranges)
    ops, end = [], -1
    for e in sorted((e for e in cpu if e.name.startswith("aten::")),
                    key=lambda e: (e.time_range.start, -e.time_range.end)):
        if e.time_range.start >= end:            # not inside another op
            ops.append(e)
            end = e.time_range.end
    assert ops
    outside = {e.name for e in ops if e.name not in NO_LAUNCH
               and not any(_inside(e, r) for r in ranges)}
    assert outside == set(), outside
