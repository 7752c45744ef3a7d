"""Native sample streaming: ctypes binding of the C++ ring buffer.

The host-side continuous-RX pipeline (the reference's srslte::radio
rx_now + ringbuffer.c + io/ streaming, re-designed as a native producer
thread feeding batched device transfers): a C++ lock-free SPSC ring
buffer (``csrc/ring_buffer.cpp``, the JAX package's
``native/ring_buffer.cpp`` byte for byte) with file or UDP producers,
read in subframe-batch chunks. It is compiled with ``g++`` on first use
into the package's ``_build/`` directory by ``utils.cuda_build``, which
builds the CUDA kernels the same way. There is no pure-Python fallback:
``SampleStream`` raises when the library cannot be built.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ..utils import cuda_build

_lib = None


def _load():
    """The ring buffer's library, built on first use; raises when the
    build fails."""
    global _lib
    if _lib is not None:
        return _lib
    lib = cuda_build.load("ring_buffer")
    lib.rb_create.restype = ctypes.c_void_p
    lib.rb_create.argtypes = [ctypes.c_size_t]
    lib.rb_destroy.argtypes = [ctypes.c_void_p]
    lib.rb_write.restype = ctypes.c_size_t
    lib.rb_write.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.rb_read.restype = ctypes.c_size_t
    lib.rb_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
                            ctypes.c_int, ctypes.POINTER(ctypes.c_uint64)]
    lib.rb_available.restype = ctypes.c_uint64
    lib.rb_available.argtypes = [ctypes.c_void_p]
    lib.rb_overflows.restype = ctypes.c_uint64
    lib.rb_overflows.argtypes = [ctypes.c_void_p]
    lib.rb_start_file_producer.restype = ctypes.c_int
    lib.rb_start_file_producer.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_double]
    lib.rb_start_udp_producer.restype = ctypes.c_int
    lib.rb_start_udp_producer.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.rb_bound_port.restype = ctypes.c_int
    lib.rb_bound_port.argtypes = [ctypes.c_void_p]
    lib.rb_stop.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def load_native():
    """Load (building if needed) the native library; None if it cannot be
    built (no compiler, or the compiler fails)."""
    try:
        return _load()
    except (RuntimeError, OSError):
        return None


class SampleStream:
    """Continuous IQ stream backed by the native ring buffer."""

    def __init__(self, capacity_samples: int = 1 << 22):
        try:
            lib = _load()
        except (RuntimeError, OSError) as e:
            raise RuntimeError("native runtime unavailable (the ring "
                               "buffer did not build)") from e
        self._lib = lib
        self._rb = lib.rb_create(capacity_samples)

    # --- producers ----------------------------------------------------------

    def start_file(self, path: str, loop: bool = False,
                   throttle_sps: float = 0.0) -> None:
        rc = self._lib.rb_start_file_producer(
            self._rb, str(path).encode(), int(loop), float(throttle_sps))
        if rc != 0:
            raise IOError(f"cannot open {path}")

    def start_udp(self, bind_addr: str = "", port: int = 0) -> int:
        rc = self._lib.rb_start_udp_producer(self._rb, bind_addr.encode(), port)
        if rc != 0:
            raise IOError(f"cannot bind UDP {bind_addr}:{port} ({rc})")
        return self._lib.rb_bound_port(self._rb)

    def push(self, samples: np.ndarray) -> int:
        data = np.ascontiguousarray(samples, np.complex64)
        return self._lib.rb_write(
            self._rb, data.ctypes.data_as(ctypes.c_void_p), len(data))

    # --- consumer -----------------------------------------------------------

    def read(self, n: int, timeout_ms: int = 1000) -> tuple[np.ndarray, int]:
        """Blocking read: (samples[n], stream_timestamp_of_first_sample).

        Short reads (timeout/stop) are zero-padded, like the reference's
        file-mode receive path.
        """
        out = np.empty(n, np.complex64)
        ts = ctypes.c_uint64()
        got = self._lib.rb_read(
            self._rb, out.ctypes.data_as(ctypes.c_void_p), n,
            timeout_ms, ctypes.byref(ts))
        if got < n:
            out[got:] = 0
        return out, int(ts.value)

    @property
    def available(self) -> int:
        return self._lib.rb_available(self._rb)

    @property
    def overflows(self) -> int:
        return self._lib.rb_overflows(self._rb)

    def close(self) -> None:
        if self._rb:
            self._lib.rb_stop(self._rb)
            self._lib.rb_destroy(self._rb)
            self._rb = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
