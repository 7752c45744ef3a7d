"""Host-side runtime: layered logging and the TUN user plane.

The port's share of the JAX package's runtime (its ``io``, ``metrics``,
``rf``, ``stream``, ``pcap``, ``config``, ``libconf``, ``trace`` and
``crash`` modules are not ported yet): per-layer leveled logging with
TTI stamps (``logging``), and TUN interfaces and network namespaces for
the kernel-path user plane (``tun``, imported where it is used).
"""

from .logging import LogFilter, get_logger

__all__ = ["LogFilter", "get_logger"]
