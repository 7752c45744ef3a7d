"""Build the hand-written CUDA kernels and the native host runtime, load
them with ctypes, and launch the kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc``, and each
``csrc/<name>.cpp`` (the sample ring buffer) by ``g++``, into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), named after a hash of its source and flags, inside the
package's ``_build/`` directory. Several sources build in parallel, one
compiler process each. Nothing here runs at import time.

A kernel's C launcher is declared once, beside its wrapper, as a
``Kernel``; ``Kernel.launch`` is the one way the port launches a
hand-written kernel, and counts each launch in ``runtime.trace``'s launch
registry.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

from ..runtime import trace

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"

#: sm_90a (Hopper) only; ``--fmad=false`` keeps every multiply-add
#: rounded as two operations, like the plain PyTorch versions on the CPU.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")
#: the host C++ sources' flags (those of the JAX package's native/Makefile)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared")

#: the port's CUDA kernels on its paths, the receivers' and the
#: transmitter's (the PDCCH and turbo encoders): the first ``load`` of one
#: of them builds each of them not built yet, all compilers started together
KERNELS = ("chest_dl", "pdcch_rx", "pdcch_tx", "sch_derm", "turbo_enc",
           "turbo_nii", "turbo_win", "viterbi37")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
#: ptxas resource report (registers, shared memory, spills) per source,
#: kept beside each library so that a cached build reports it too
BUILD_LOGS: dict[str, str] = {}


def nvcc() -> str:
    for cand in ("/usr/local/cuda/bin/nvcc", shutil.which("nvcc")):
        if cand and pathlib.Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def cxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native ring buffer builds "
                           "only where a C++ compiler is installed")
    return found


def _source(name: str, sources=None) -> pathlib.Path:
    if sources and name in sources:
        return pathlib.Path(sources[name])
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _flags(src: pathlib.Path) -> tuple:
    return NVCC_FLAGS if src.suffix == ".cu" else CXX_FLAGS


def library_path(name: str, sources=None) -> pathlib.Path:
    """Where the library of ``csrc/<name>.cu`` or ``.cpp`` (or of
    ``sources[name]``) is built: named after a hash of its source, the
    headers beside it and its flags."""
    src = _source(name, sources)
    headers = b"".join(h.read_bytes() for h in sorted(src.parent.glob("*.cuh")))
    tag = hashlib.sha1(src.read_bytes() + headers
                       + " ".join(_flags(src)).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{tag}.so"


def build(names, sources=None) -> dict[str, float]:
    """Compile the named sources that are not built yet, all compiler
    processes started together. ``sources`` maps a name to a source
    outside ``csrc/`` (another design of a kernel, built under a name of
    its own). Returns the seconds each build took."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {}
    for name in names:
        out = library_path(name, sources)
        if out.exists():
            log = out.with_suffix(".log")
            BUILD_LOGS[name] = log.read_text() if log.exists() else ""
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        src = _source(name, sources)
        # find every compiler before starting any, so that none is left
        # running when one is missing
        todo[name] = ([nvcc() if src.suffix == ".cu" else cxx(),
                       *_flags(src), "-o", str(tmp), str(src)], tmp, out)
    procs = {name: (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out, time.perf_counter())
             for name, (cmd, tmp, out) in todo.items()}
    took, failed = {}, []
    # wait for every compiler before reporting a failure: none is left
    # running
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{proc.args[0]} failed for "
                          f"{_source(name, sources)}:\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return took


def load(name: str, source=None) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu`` or ``.cpp``, or for
    ``source`` when given (built on first use, with the rest of
    ``KERNELS`` when it is one of them). A miss (the build, or the cached
    library's load) runs in the range ``runtime.kernel_load`` and counts
    one ``kernel_load``."""
    sources = None if source is None else {name: source}
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            with trace.span("runtime.kernel_load"):
                build(KERNELS if source is None and name in KERNELS
                      else [name], sources)
                lib = _LIBS[name] = ctypes.CDLL(str(library_path(name,
                                                                 sources)))
            trace.count("kernel_load")
        return lib


class Kernel:
    """The C launcher ``symbol`` of the library ``library``, declared
    with the ``argtypes`` of its arguments before the stream, which
    ``launch`` passes last. Declaring loads nothing: the library loads on
    the first launch (``load``). The kernel's name, the symbol with
    ``_launch`` taken out, names it in errors and in the launch
    registry."""

    __slots__ = ("library", "symbol", "name", "argtypes", "_fn")

    def __init__(self, library: str, symbol: str, argtypes):
        self.library, self.symbol = library, symbol
        self.name = symbol.replace("_launch", "")
        self.argtypes = [*argtypes, ctypes.c_void_p]
        self._fn = None

    @property
    def fn(self):
        """The ctypes function, its library loaded on first use."""
        if self._fn is None:
            fn = getattr(load(self.library), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn

    def launch(self, device, shape, *args) -> None:
        """One launch on ``device``'s current stream, counted in the
        launch registry under (name, ``shape``); raises on the launcher's
        CUDA error."""
        # the launcher calls the runtime on the current device, and stream
        # 0 of a device is its legacy default stream: both must be
        # ``device``'s
        with torch.cuda.device(device):
            rc = self.fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {rc}")
        trace.count_launch(self.name, shape)
