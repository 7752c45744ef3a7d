"""Host-side runtime: IQ I/O, config, logging, metrics.

Capability parity with the reference's lib/src/phy/io (file/UDP sample
streams), lib/src/common logging/metrics infrastructure, and the
boost::program_options / libconfig configuration surface — re-designed as
Python dataclass configs with INI/CLI overrides and structured logging.
A native C++ streaming ring buffer (``csrc/ring_buffer.cpp``, built with
``g++`` on first use) backs ``stream``; ``tun`` (TUN interfaces and
network namespaces), ``pcap``, ``crash``, ``libconf`` and ``trace`` are
imported where they are used.
"""

from .io import FileSink, FileSource, NetSink, NetSource
from .logging import LogFilter, get_logger
from .metrics import MetricsHub
from .rf import Radio, RfDevice, register_device, rf_open

__all__ = ["FileSink", "FileSource", "NetSink", "NetSource",
           "LogFilter", "get_logger", "MetricsHub",
           "Radio", "RfDevice", "register_device", "rf_open"]
