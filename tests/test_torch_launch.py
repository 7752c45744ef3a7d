"""The port's one launch path for its hand-written CUDA kernels
(``utils.cuda_build.Kernel``) and its launch registry
(``runtime.trace``), on the CPU with a fake C function in place of each
library's (``tests/torch_fake_launch.py``)."""

from __future__ import annotations

import ctypes

import pytest
import torch

from empower_srslte_tpu_torch.models import pdcch
from empower_srslte_tpu_torch.ops import chest
from empower_srslte_tpu_torch.ops.fec import (rate_matching, turbo_encoder,
                                               turbo_nii, turbo_win, viterbi37)
from empower_srslte_tpu_torch.runtime import trace
from empower_srslte_tpu_torch.tools import microbench_recursion as mr
from empower_srslte_tpu_torch.utils import cuda_build
from empower_srslte_tpu_torch.utils.cuda_build import Kernel

from tests.torch_fake_launch import STREAM, fake_launches

#: every C launcher of the port, each declared once
DECLARED = [*turbo_nii.NII_KERNELS.values(), *turbo_win.WIN_KERNELS.values(),
            viterbi37.VITERBI37, chest.CHEST_DL, pdcch.CTRL_LLR,
            pdcch.PDCCH_BLIND, rate_matching.SCH_DERM,
            turbo_encoder.TURBO_ENC, *(t[3] for t in mr.TYPES)]


@pytest.fixture
def registry():
    trace.reset()
    yield
    trace.reset()


def test_the_port_declares_its_eleven_launchers_once():
    assert sorted(k.name for k in DECLARED) == sorted([
        "turbo_nii", "turbo_nii_bf16", "turbo_win", "turbo_win_bf16",
        "viterbi37", "chest_dl", "ctrl_llr", "pdcch_blind", "sch_derm",
        "turbo_enc", "recursion_f32", "recursion_bf16", "recursion_i8"])
    assert len({k.symbol for k in DECLARED}) == len(DECLARED)
    for k in DECLARED:
        assert k.argtypes[-1] is ctypes.c_void_p      # the stream


def test_declaring_loads_no_library(monkeypatch):
    loaded = []
    monkeypatch.setattr(cuda_build, "load", loaded.append)
    k = Kernel("lib_x", "x_launch_bf16", [ctypes.c_void_p, ctypes.c_int])
    assert k.name == "x_bf16" and loaded == []
    assert all(d._fn is None for d in DECLARED)


def test_first_launch_loads_the_library_and_declares_the_function(
        monkeypatch, registry):
    class Fn:
        def __call__(self, *args):
            self.args = args
            return 0

    lib = type("Lib", (), {"x_launch": Fn()})()
    loaded = []
    monkeypatch.setattr(cuda_build, "load",
                        lambda name: loaded.append(name) or lib)
    fake_launches(monkeypatch)                  # the device and the stream
    k = Kernel("lib_x", "x_launch", [ctypes.c_void_p, ctypes.c_int])
    k.launch(torch.device("cpu"), (1,), None, 3)
    k.launch(torch.device("cpu"), (1,), None, 4)
    assert loaded == ["lib_x"]
    assert lib.x_launch.argtypes == [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_void_p]
    assert lib.x_launch.restype is ctypes.c_int
    assert lib.x_launch.args == (None, 4, STREAM)


def test_the_stream_comes_last_on_the_launch_device(monkeypatch, registry):
    k = Kernel("lib_x", "x_launch", [ctypes.c_void_p, ctypes.c_int])
    calls = fake_launches(monkeypatch, k)
    dev = torch.device("cpu")
    k.launch(dev, (7,), 123, 5)
    assert calls == [("x", dev, (123, 5, STREAM))]


def test_one_launch_records_once_under_its_name_and_shape(monkeypatch,
                                                          registry):
    k = Kernel("lib_x", "x_launch_bf16", [ctypes.c_int])
    fake_launches(monkeypatch, k)
    k.launch("cpu", (64, 2, "bfloat16"), 1)
    assert trace.launch_counts() == {"x_bf16": 1}
    assert trace.launch_shapes("x_bf16") == {(64, 2, "bfloat16"): 1}
    k.launch("cpu", (64, 2, "bfloat16"), 1)
    k.launch("cpu", (32, 2, "bfloat16"), 1)
    assert trace.launch_counts() == {"x_bf16": 3}
    assert trace.launch_shapes("x_bf16") == {(64, 2, "bfloat16"): 2,
                                             (32, 2, "bfloat16"): 1}
    assert trace.launch_shapes("x") == {}
    # counted tracing or not, and apart from the first-use events
    assert not trace.tracing() and trace.counts() == {}
    trace.reset()
    assert trace.launch_counts() == {}


def test_a_failed_launch_raises_with_the_name_and_records_nothing(
        monkeypatch, registry):
    k = Kernel("lib_x", "x_launch", [ctypes.c_int])
    fake_launches(monkeypatch, k, rc=700)
    with pytest.raises(RuntimeError,
                       match=r"^x kernel launch failed: CUDA error 700$"):
        k.launch("cpu", (1,), 1)
    assert trace.launch_counts() == {}


def test_a_wrapper_launches_through_the_shared_launcher(monkeypatch,
                                                        registry):
    """The Viterbi wrapper on the card's path: its arguments, then the
    stream, and its launch shape (K, halo, code words) in the registry."""
    calls = fake_launches(monkeypatch, viterbi37.VITERBI37)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    llr = torch.zeros((5, 3, 44))
    regs = viterbi37.viterbi_regs_cuda(llr, 40)
    plan = viterbi37.vit_plan(44, 40)
    ((name, dev, args),) = calls
    assert name == "viterbi37" and dev == llr.device
    assert args == (llr.data_ptr(), regs.data_ptr(), 5, 44, 40, 2,
                    plan.warps, plan.smem, STREAM)
    assert trace.launch_shapes("viterbi37") == {(44, 40, 5): 1}
