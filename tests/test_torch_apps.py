"""The port's example programs against the JAX package's ``apps/``, at 6
PRB and 3 frames, on the CPU (``--cpu``): ``pdsch_enodeb`` writes the
same IQ (within 1e-4 of the peak), ``pdsch_ue`` decodes the JAX capture
into the same subframes, DCIs, CRC flags and TB bits as the JAX app's
loop (and the bits are the sent TBs), ``cell_search`` finds the same
cell, N_id_2 and MIB (CFO within 1e-3), ``cell_measurement.measure`` is
within 1e-3 relative of the JAX ``measure``, and ``iq_capture`` through
the file and the native-stream RF devices writes the capture the JAX
``iq_capture -d file`` writes, byte for byte.

One JAX ``pdsch_enodeb`` run and one JAX receive of its capture are
shared by the module: the JAX ``pdsch_ue`` and ``cell_search`` only
print, so the receive repeats their loops (``sync_and_align``, then one
``ue_dl_decode`` per subframe; the MIB of the first subframe)."""

import dataclasses
import importlib.util
import pathlib
import sys
from unittest import mock

import numpy as np
import pytest
import torch

from empower_srslte_tpu.models.ue_dl import ue_dl_decode as jax_ue_dl_decode
from empower_srslte_tpu.models.ue_dl import ue_mib_decode as jax_mib_decode
from empower_srslte_tpu.models.ue_sync import sync_and_align as jax_sync
from empower_srslte_tpu.utils import Cell as JaxCell

from empower_srslte_tpu_torch.apps import (cell_measurement, cell_search,
                                           iq_capture, pdsch_enodeb,
                                           pdsch_ue)
from empower_srslte_tpu_torch.models.ue_sync import sync_and_align

ROOT = pathlib.Path(__file__).resolve().parent.parent
NOF_PRB, MCS, FRAMES, RNTI = 6, 10, 3, 0x1234
ENB_ARGS = ["-p", str(NOF_PRB), "-m", str(MCS), "-f", str(FRAMES)]


def jax_app(name: str):
    """The JAX package's ``apps/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_app_{name}", ROOT / "apps" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_jax_main(name: str, argv: list) -> None:
    with mock.patch.object(sys, "argv", [f"{name}.py", *argv]):
        jax_app(name).main()


@pytest.fixture(scope="module")
def jax_capture(tmp_path_factory) -> pathlib.Path:
    out = tmp_path_factory.mktemp("jax_apps") / "enb.bin"
    run_jax_main("pdsch_enodeb", ["-o", str(out), *ENB_ARGS])
    return out


@pytest.fixture(scope="module")
def jax_rx(jax_capture):
    """The JAX ``pdsch_ue`` loop and ``cell_search -p 6`` on the capture:
    the sync result, per subframe the grants that carry a DCI, and the
    MIB of the first aligned subframe."""
    samples = np.fromfile(jax_capture, np.complex64)
    res = jax_sync(samples, cell_prb=NOF_PRB)
    cell = JaxCell(nof_prb=NOF_PRB, id=res.cell_id)
    subframes = []
    for i in range(min(len(res.subframes), 100)):
        got = [r for r in jax_ue_dl_decode(res.subframes[i], cell, i % 10,
                                           RNTI) if r.dci is not None]
        subframes.append(got)
    mib = jax_mib_decode(np.asarray(res.subframes[0]), res.cell_id)
    return res, subframes, mib


def test_enodeb_writes_the_jax_iq(jax_capture, tmp_path):
    out = tmp_path / "enb.bin"
    assert pdsch_enodeb.main(["-o", str(out), *ENB_ARGS, "--cpu"]) == 0
    ref = np.fromfile(jax_capture, np.complex64)
    got = np.fromfile(out, np.complex64)
    assert got.shape == ref.shape == (10 * FRAMES * 1920,)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max()


def test_pdsch_ue_decodes_as_the_jax_app(jax_capture, jax_rx):
    res, ref, _ = jax_rx
    run = pdsch_ue.receive(np.fromfile(jax_capture, np.complex64), NOF_PRB,
                           RNTI, 100, device="cpu")
    assert (run.cell_id, run.sf0_offset) == (res.cell_id, res.sf0_offset)
    assert len(run.subframes) == len(ref) == 10 * FRAMES
    _, tbs, _ = pdsch_enodeb.grant(NOF_PRB, MCS)
    sent = pdsch_enodeb.tb_draws(tbs)
    for i, (sf, want) in enumerate(zip(run.subframes, ref)):
        assert sf.sf_idx == i % 10
        assert [dataclasses.asdict(d) for d in sf.dci] == \
            [dataclasses.asdict(r.dci) for r in want]
        assert sf.crc_ok == [r.crc_ok for r in want] == [True]
        for bits, r in zip(sf.tb_bits, want):
            np.testing.assert_array_equal(bits, np.asarray(r.tb_bits))
        np.testing.assert_array_equal(sf.tb_bits[0], next(sent)[0])
    assert (run.blocks, run.errors) == (10 * FRAMES, 0)
    assert run.bits_ok == 10 * FRAMES * tbs
    assert [r["sf"] for r in run.reports] == [10, 20, 30]
    assert all(r["bler"] == 0.0 for r in run.reports)


def test_pdsch_ue_main_reports_metrics(jax_capture, capsys):
    assert pdsch_ue.main(["-i", str(jax_capture), "-p", str(NOF_PRB),
                          "-n", "10", "--cpu"]) == 0
    table = capsys.readouterr().out.split()
    assert table[:4] == ["sf", "net_mbps", "proc_mbps", "bler"]
    assert table[4] == "10" and table[-1] == "0.000"


def test_cell_search_finds_the_jax_cell(jax_capture, jax_rx):
    res, _, mib = jax_rx
    found = cell_search.search(np.fromfile(jax_capture, np.complex64),
                               NOF_PRB, device="cpu")
    assert found["cell_id"] == res.cell_id == 1
    assert found["n_id_2"] == res.n_id_2 and found["n_id_1"] == 0
    assert abs(found["cfo"] - res.cfo) <= 1e-3
    assert found["mib"] == mib
    assert (mib["nof_prb"], mib["nof_ports"], mib["sfn_msb"] * 4
            + mib["sfn_mod4"]) == (NOF_PRB, 1, 0)
    assert cell_search.main(["-i", str(jax_capture), "--cpu"]) == 0


def test_cell_measurement_matches_the_jax_measure(jax_rx):
    """The JAX ``measure`` of ``tests/test_sync.py``, and the port's, on
    the aligned subframes at 20 dB of added noise."""
    res, _, _ = jax_rx
    rng = np.random.default_rng(5)
    sub = np.asarray(res.subframes)
    noise = (rng.normal(size=sub.shape) + 1j * rng.normal(size=sub.shape))
    power = np.mean(np.abs(sub) ** 2)
    sub = (sub + np.sqrt(power / 100 / 2) * noise).astype(np.complex64)
    ref = jax_app("cell_measurement").measure(sub, NOF_PRB, res.cell_id)
    got = cell_measurement.measure(torch.as_tensor(sub), NOF_PRB,
                                   res.cell_id)
    assert sorted(got) == sorted(ref) == ["rsrp", "rsrq", "rssi", "snr"]
    for k in ref:
        assert abs(got[k] - ref[k]) <= 1e-3 * abs(ref[k]), k
    assert 10.0 < 10 * np.log10(got["snr"]) < 40.0


@pytest.fixture(scope="module")
def jax_iq_capture(jax_capture, tmp_path_factory) -> bytes:
    out = tmp_path_factory.mktemp("jax_capt") / "cap.bin"
    run_jax_main("iq_capture", ["-d", "file", "-a", f"rx={jax_capture}",
                                "-p", str(NOF_PRB), "-n", "25",
                                "-o", str(out)])
    return out.read_bytes()


@pytest.mark.parametrize("device", ["file", "stream"])
def test_iq_capture_writes_the_jax_capture(jax_capture, jax_iq_capture,
                                           tmp_path, device):
    out = tmp_path / "cap.bin"
    got = iq_capture.capture(str(out), 25, NOF_PRB,
                             device_name=device,
                             device_args=f"rx={jax_capture}")
    assert out.read_bytes() == jax_iq_capture
    assert len(jax_iq_capture) == 25 * 1920 * 8
    assert got["device"] == device and got["srate"] == 1.92e6
    assert got["timestamps"] == [1920 * i for i in range(25)]
    assert got["overflows"] == (0 if device == "stream" else None)
    assert iq_capture.main(["-d", device, "-a", f"rx={jax_capture}", "-p",
                            str(NOF_PRB), "-n", "25", "-o", str(out)]) == 0
    assert out.read_bytes() == jax_iq_capture


def test_sync_starts_one_sample_late_at_20mhz_in_both_packages(tmp_path):
    """A reference property the apps inherit: on the generator's 20 MHz
    capture (subframe 0 at sample 0, no CFO), ``sync_and_align`` of either
    package puts subframe 0 at sample 1 with a CFO of 0.0042 subcarrier.
    Each FFT window then takes one sample of the next symbol's CP, which
    caps the measured SNR of this noiseless capture near 30 dB in both
    packages' ``measure``; cut at the transmitter's own boundaries it
    measures above 100 dB."""
    out = tmp_path / "enb100.bin"
    pdsch_enodeb.generate(str(out), 100, 1, 16, RNTI, 2, device="cpu")
    samples = np.fromfile(out, np.complex64)
    ref = jax_sync(samples, cell_prb=100)
    got = sync_and_align(samples, 100, device="cpu")
    assert (got.cell_id, got.sf0_offset) == (ref.cell_id, ref.sf0_offset) \
        == (1, 1)
    assert abs(got.cfo - ref.cfo) <= 1e-6 and 0.004 < got.cfo < 0.0045
    synced = cell_measurement.measure(got.subframes, 100, 1)
    synced_jax = jax_app("cell_measurement").measure(
        np.asarray(ref.subframes), 100, 1)
    for k in synced_jax:
        assert abs(synced[k] - synced_jax[k]) <= 1e-3 * abs(synced_jax[k])
    aligned = cell_measurement.measure(
        torch.as_tensor(samples).reshape(20, -1), 100, 1)
    assert 25.0 < 10 * np.log10(synced["snr"]) < 31.0
    assert 10 * np.log10(aligned["snr"]) > 100.0
