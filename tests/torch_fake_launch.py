"""Launch the port's hand-written kernels on the CPU, with no card.

``fake_launches(monkeypatch, *kernels, rc=0)`` gives each
``utils.cuda_build.Kernel`` a fake C function in place of its library's:
it records the call and returns ``rc``. It also stands in for the current
device and stream, which ``Kernel.launch`` would ask the card for, so the
port's own launch path runs as it does on the card. ``STREAM`` is the
stand-in stream's handle.
"""

from __future__ import annotations

import contextlib
import types

import torch

#: the stand-in stream's handle, which a launcher is passed last
STREAM = 0x5EED


def fake_launches(monkeypatch, *kernels, rc: int = 0) -> list:
    """Fake the C functions of ``kernels``: -> the list that each call
    appends (kernel name, device, arguments) to."""
    calls: list = []
    device = []

    def enter(dev):
        device.append(dev)
        return contextlib.nullcontext()

    for kernel in kernels:
        def fn(*args, name=kernel.name):
            calls.append((name, device[-1], args))
            return rc
        monkeypatch.setattr(kernel, "_fn", fn)
    monkeypatch.setattr(torch.cuda, "device", enter)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=STREAM))
    return calls
