"""IQ sample I/O: binary files and UDP streams.

Capability parity with lib/src/phy/io/: filesource/filesink
(SRSLTE_COMPLEX_FLOAT_BIN — interleaved float32 I/Q — plus the text
formats) and netsource/netsink (UDP datagram sample streams). File format
is byte-compatible with the reference's recorded captures so its IQ
vectors can be decoded directly.
"""

from __future__ import annotations

import socket

import numpy as np


class FileSource:
    """Read complex64 samples from a binary (or text) IQ file."""

    def __init__(self, path: str, fmt: str = "complex_float_bin"):
        self.path = path
        self.fmt = fmt
        if fmt == "complex_float_bin":
            self._data = np.fromfile(path, dtype=np.complex64)
        elif fmt == "complex_float_txt":
            raw = np.loadtxt(path, dtype=np.float32)
            self._data = (raw[:, 0] + 1j * raw[:, 1]).astype(np.complex64)
        else:
            raise ValueError(fmt)
        self._pos = 0

    def read(self, n: int) -> np.ndarray:
        out = self._data[self._pos : self._pos + n]
        self._pos += len(out)
        if len(out) < n:
            out = np.concatenate([out, np.zeros(n - len(out), np.complex64)])
        return out

    def read_all(self) -> np.ndarray:
        return self._data

    def remaining(self) -> int:
        return max(0, len(self._data) - self._pos)

    def seek(self, pos: int) -> None:
        self._pos = pos


class FileSink:
    """Write complex64 samples to a binary IQ file (append-capable)."""

    def __init__(self, path: str, fmt: str = "complex_float_bin"):
        assert fmt == "complex_float_bin"
        self.path = path
        self._f = open(path, "wb")

    def write(self, samples: np.ndarray) -> None:
        np.ascontiguousarray(samples, dtype=np.complex64).tofile(self._f)

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NetSource:
    """Network IQ stream receiver (netsource.c analog).

    Supports both transports the reference does (netsource.c
    SRSLTE_NETSOURCE_UDP / SRSLTE_NETSOURCE_TCP): UDP datagrams, or a
    listening TCP socket that accepts one sender on first read.
    """

    def __init__(self, addr: str = "0.0.0.0", port: int = 2001,
                 timeout: float | None = 1.0, transport: str = "udp"):
        assert transport in ("udp", "tcp")
        self.transport = transport
        self._timeout = timeout
        self._residue = b""
        self._conn = None
        if transport == "udp":
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self.sock.bind((addr, port))
            if timeout is not None:
                self.sock.settimeout(timeout)
        else:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.sock.bind((addr, port))
            self.sock.listen(1)
            if timeout is not None:
                self.sock.settimeout(timeout)

    def _recv(self) -> bytes:
        if self.transport == "udp":
            pkt, _ = self.sock.recvfrom(65536)
            return pkt
        if self._conn is None:
            self._conn, _ = self.sock.accept()
            if self._timeout is not None:
                self._conn.settimeout(self._timeout)
        return self._conn.recv(65536)

    def read(self, n: int) -> np.ndarray:
        need = n * 8
        buf = self._residue
        while len(buf) < need:
            try:
                pkt = self._recv()
            except socket.timeout:
                break
            if not pkt and self.transport == "tcp":
                break  # sender closed
            buf += pkt
        self._residue = buf[need:]
        data = np.frombuffer(buf[:need].ljust(need, b"\0"), np.complex64)
        return data.copy()

    def close(self) -> None:
        if self._conn is not None:
            self._conn.close()
        self.sock.close()


class NetSink:
    """Network IQ stream transmitter (netsink.c analog): UDP or TCP."""

    MTU_SAMPLES = 1024  # samples per datagram (UDP only)

    def __init__(self, addr: str = "127.0.0.1", port: int = 2001,
                 transport: str = "udp"):
        assert transport in ("udp", "tcp")
        self.transport = transport
        if transport == "udp":
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self.dest = (addr, port)
        else:
            self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self.sock.connect((addr, port))

    def write(self, samples: np.ndarray) -> None:
        data = np.ascontiguousarray(samples, np.complex64)
        if self.transport == "tcp":
            self.sock.sendall(data.tobytes())
            return
        for i in range(0, len(data), self.MTU_SAMPLES):
            self.sock.sendto(data[i : i + self.MTU_SAMPLES].tobytes(), self.dest)

    def close(self) -> None:
        self.sock.close()
