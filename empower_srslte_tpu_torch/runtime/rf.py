"""RF HAL: device vtable, registry with auto-probe, and the radio layer.

Capability parity with the reference's RF stack:

* ``srslte_rf`` vtable (lib/src/phy/rf/rf_dev.h:1) — a table of device
  ops (open/close/set-srate/set-gain/set-freq/recv-with-time/send-timed);
  here a Python ABC with the same surface.
* Device registry + auto-probe open (rf_imp.c:103-126: try UHD, then
  bladeRF, then Soapy until one opens) — here ``register_device`` +
  ``rf_open`` probing "file", "net", "stream" backends plus any plugin
  the deployment registers (hardware SDRs are out of scope on a TPU
  host; the IQ-file/UDP modes are the reference's own hardware-free
  test path, ue_sync.c:675-707).
* ``srslte::radio`` (lib/src/radio/radio.cc) — tx/rx in units of
  samples with monotonically advancing timestamps, timed TX with
  burst-start padding and per-device TX advance calibration
  (radio.cc tx_adv_sec), EARFCN tuning via utils.band.

Timestamps are in samples at the configured sample rate (the reference
uses {full_secs, frac_secs}; a sample count at a known srate carries the
same information losslessly).
"""

from __future__ import annotations

import abc

import numpy as np

from ..utils.band import dl_freq_hz, ul_earfcn_from_dl, ul_freq_hz


class RfDevice(abc.ABC):
    """The srslte_rf_api_t op surface (rf_dev.h)."""

    name: str = "abstract"

    def __init__(self) -> None:
        self.rx_srate = 1.92e6
        self.tx_srate = 1.92e6
        self.rx_gain = 0.0
        self.tx_gain = 0.0
        self.rx_freq = 0.0
        self.tx_freq = 0.0
        self.streaming = False

    # -- control ---------------------------------------------------------
    def set_rx_srate(self, hz: float) -> float:
        self.rx_srate = hz
        return hz

    def set_tx_srate(self, hz: float) -> float:
        self.tx_srate = hz
        return hz

    def set_rx_gain(self, db: float) -> float:
        self.rx_gain = db
        return db

    def set_tx_gain(self, db: float) -> float:
        self.tx_gain = db
        return db

    def set_rx_freq(self, hz: float) -> float:
        self.rx_freq = hz
        return hz

    def set_tx_freq(self, hz: float) -> float:
        self.tx_freq = hz
        return hz

    def start_rx_stream(self) -> None:
        self.streaming = True

    def stop_rx_stream(self) -> None:
        self.streaming = False

    # -- data ------------------------------------------------------------
    @abc.abstractmethod
    def recv_with_time(self, nof_samples: int
                       ) -> tuple[np.ndarray, int]:
        """Blocking read -> (complex64[n], rx_timestamp_samples)."""

    @abc.abstractmethod
    def send_timed(self, samples: np.ndarray, timestamp: int | None
                   ) -> None:
        """Transmit at the given sample timestamp (None = now)."""

    def close(self) -> None:
        pass


class FileRfDevice(RfDevice):
    """IQ-file device: RX from a file source, TX to a file sink — the
    rf-free mode every reference file test uses."""

    name = "file"

    def __init__(self, args: str = ""):
        super().__init__()
        from .io import FileSink, FileSource

        kv = dict(p.split("=", 1) for p in args.split(",") if "=" in p)
        self._src = FileSource(kv["rx"]) if "rx" in kv else None
        self._sink = FileSink(kv["tx"]) if "tx" in kv else None
        if self._src is None and self._sink is None:
            raise ValueError("file rf device needs args 'rx=...' or "
                             "'tx=...'")
        self._rx_clock = 0
        self._tx_clock = 0

    def recv_with_time(self, nof_samples: int):
        if self._src is None:
            raise RuntimeError("no rx file configured")
        ts = self._rx_clock
        chunks = []
        need = nof_samples
        while need > 0:
            avail = self._src.remaining()
            if avail == 0:                # loop like rf file mode
                self._src.seek(0)
                if self._src.remaining() == 0:
                    chunks.append(np.zeros(need, np.complex64))
                    break
                continue
            chunk = self._src.read(min(need, avail))
            chunks.append(chunk)
            need -= len(chunk)
        out = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        self._rx_clock += nof_samples
        return out.astype(np.complex64), ts

    def send_timed(self, samples, timestamp=None):
        if self._sink is None:
            raise RuntimeError("no tx file configured")
        samples = np.asarray(samples, np.complex64)
        if timestamp is not None and timestamp > self._tx_clock:
            # zero-fill the gap so the file stays sample-accurate
            # (radio.cc burst padding)
            self._sink.write(np.zeros(timestamp - self._tx_clock,
                                      np.complex64))
            self._tx_clock = timestamp
        self._sink.write(samples)
        self._tx_clock += len(samples)

    def close(self):
        if self._sink is not None:
            self._sink.close()


class NetRfDevice(RfDevice):
    """UDP sample-stream device (io/netsource.c / netsink.c streaming)."""

    name = "net"

    def __init__(self, args: str = ""):
        super().__init__()
        from .io import NetSink, NetSource

        kv = dict(p.split("=", 1) for p in args.split(",") if "=" in p)
        self._src = NetSource(port=int(kv["rx_port"])) \
            if "rx_port" in kv else None
        self._sink = NetSink(addr=kv.get("tx_addr", "127.0.0.1"),
                             port=int(kv["tx_port"])) \
            if "tx_port" in kv else None
        self._rx_clock = 0

    def recv_with_time(self, nof_samples: int):
        if self._src is None:
            raise RuntimeError("no rx port configured")
        ts = self._rx_clock
        out = self._src.read(nof_samples)
        self._rx_clock += len(out)
        return out.astype(np.complex64), ts

    def send_timed(self, samples, timestamp=None):
        if self._sink is None:
            raise RuntimeError("no tx port configured")
        self._sink.write(np.asarray(samples, np.complex64))

    def close(self):
        for s in (self._src, self._sink):
            if s is not None:
                s.close()


class StreamRfDevice(RfDevice):
    """Native SPSC-ring device (runtime.stream.SampleStream producers):
    the double-buffered host ingest path feeding the TPU."""

    name = "stream"

    def __init__(self, args: str = "", stream=None):
        super().__init__()
        from .stream import SampleStream

        self._stream = stream or SampleStream()
        kv = dict(p.split("=", 1) for p in args.split(",") if "=" in p)
        if "rx" in kv:
            self._stream.start_file(kv["rx"], loop="loop" in args)
        elif "rx_port" in kv:
            self._stream.start_udp(port=int(kv["rx_port"]))
        self._rx_clock = 0

    def recv_with_time(self, nof_samples: int):
        out, _dropped = self._stream.read(nof_samples)
        ts = self._rx_clock
        self._rx_clock += len(out)
        return out, ts

    def send_timed(self, samples, timestamp=None):
        raise RuntimeError("stream device is rx-only")

    def close(self):
        self._stream.close()


# --- registry + auto-probe ---------------------------------------------------

_REGISTRY: dict[str, type] = {}


def register_device(cls: type) -> type:
    """Plugin registration (the reference's static rf_dev table; here
    open so deployments can add hardware backends)."""
    _REGISTRY[cls.name] = cls
    return cls


for _cls in (FileRfDevice, NetRfDevice, StreamRfDevice):
    register_device(_cls)


def rf_open(device_name: str | None = None, args: str = "") -> RfDevice:
    """Open a device by name, or auto-probe (rf_imp.c:103-126: first
    device that opens wins)."""
    if device_name:
        if device_name not in _REGISTRY:
            raise ValueError(f"unknown rf device {device_name!r}; have "
                             f"{sorted(_REGISTRY)}")
        return _REGISTRY[device_name](args)
    errors = {}
    for name, cls in _REGISTRY.items():
        try:
            return cls(args)
        except Exception as e:       # probe failure: try the next device
            errors[name] = e
    raise RuntimeError(f"no rf device opened (probed {errors})")


# --- radio layer -------------------------------------------------------------


class Radio:
    """srslte::radio: the app-facing wrapper with timed TX, burst
    bookkeeping and EARFCN tuning (radio.cc)."""

    def __init__(self, dev: RfDevice, tx_advance_samples: int = 0):
        self.dev = dev
        # per-device TX advance calibration (radio.cc burst_preamble /
        # tx_adv_sec table): transmissions are scheduled this many
        # samples early to absorb the device pipeline latency
        self.tx_advance = tx_advance_samples
        self.is_start_of_burst = True

    def set_rx_srate(self, hz: float) -> None:
        self.dev.set_rx_srate(hz)

    def set_tx_srate(self, hz: float) -> None:
        self.dev.set_tx_srate(hz)

    def set_rx_freq_earfcn(self, dl_earfcn: int) -> None:
        self.dev.set_rx_freq(dl_freq_hz(dl_earfcn))

    def set_tx_freq_earfcn(self, dl_earfcn: int) -> None:
        self.dev.set_tx_freq(ul_freq_hz(ul_earfcn_from_dl(dl_earfcn)))

    def rx_now(self, nof_samples: int) -> tuple[np.ndarray, int]:
        return self.dev.recv_with_time(nof_samples)

    def tx(self, samples: np.ndarray, timestamp: int | None = None) -> None:
        if timestamp is not None:
            timestamp = max(0, timestamp - self.tx_advance)
        self.dev.send_timed(samples, timestamp)
        self.is_start_of_burst = False

    def tx_end(self) -> None:
        self.is_start_of_burst = True

    def close(self) -> None:
        self.dev.close()
