"""TUN network interfaces: the kernel-path user plane.

Capability parity with the reference's two TUN endpoints:

* srsue ``gw.cc`` — creates ``tun_srsue``, assigns the NAS-provided UE IP,
  then bridges kernel IP packets <-> PDCP DRB SDUs.
* srsepc ``spgw.cc:get_sgi_if`` — the SGi interface ``srs_spgw_sgi``
  bridging the operator network <-> GTP-U tunnels.

Pure ctypes/fcntl on /dev/net/tun (no third-party deps); interface
addressing via iproute2. Creation requires CAP_NET_ADMIN — call
``tun_available()`` first and fall back to the in-memory user plane
(stack.ue.UeStack.send_ip / rx_ip) when it is absent.

For single-host end-to-end tests the UE side can be moved into a network
namespace (``netns=``) so that UE-originated traffic genuinely routes
through the LTE stack instead of short-circuiting in the host routing
table — the single-machine analog of the reference's two-box deployment.
"""

from __future__ import annotations

import fcntl
import os
import select
import struct
import subprocess

# linux/if_tun.h
TUNSETIFF = 0x400454CA
IFF_TUN = 0x0001
IFF_NO_PI = 0x1000


def tun_available() -> bool:
    try:
        fd = os.open("/dev/net/tun", os.O_RDWR)
    except OSError:
        return False
    try:
        ifr = struct.pack("16sH22s", b"probe_tun", IFF_TUN | IFF_NO_PI, b"")
        fcntl.ioctl(fd, TUNSETIFF, ifr)
        return True
    except OSError:
        return False
    finally:
        os.close(fd)


def _ip(*args: str, netns: str | None = None) -> None:
    cmd = ["ip"]
    if netns:
        cmd = ["ip", "netns", "exec", netns, "ip"]
    subprocess.run(cmd + list(args), check=True, capture_output=True)


class TunDevice:
    """One TUN interface delivering raw IP packets over a file descriptor
    (gw.cc init_if / spgw.cc get_sgi_if)."""

    def __init__(self, name: str, ip_cidr: str | None = None,
                 netns: str | None = None, mtu: int = 1500):
        self.name = name
        self.netns = netns
        self.fd = os.open("/dev/net/tun", os.O_RDWR)
        ifr = struct.pack("16sH22s", name.encode(), IFF_TUN | IFF_NO_PI, b"")
        fcntl.ioctl(self.fd, TUNSETIFF, ifr)
        if netns:
            # move the interface into the namespace; the fd stays valid
            # on this side — the single-host two-box emulation
            _ip("link", "set", name, "netns", netns)
        _ip("link", "set", name, "up", netns=netns)
        _ip("link", "set", name, "mtu", str(mtu), netns=netns)
        if ip_cidr:
            self.set_ip(ip_cidr)

    def set_ip(self, ip_cidr: str) -> None:
        """Assign the interface address (gw.cc setup_if_addr once the NAS
        attach delivers the UE IP)."""
        _ip("addr", "replace", ip_cidr, "dev", self.name, netns=self.netns)

    def add_route(self, cidr: str) -> None:
        _ip("route", "replace", cidr, "dev", self.name, netns=self.netns)

    def read_packet(self, timeout: float = 0.0) -> bytes | None:
        """One IP packet from the kernel, or None if none pending."""
        r, _, _ = select.select([self.fd], [], [], timeout)
        if not r:
            return None
        return os.read(self.fd, 65535)

    def write_packet(self, packet: bytes) -> None:
        """Inject one IP packet towards the kernel."""
        os.write(self.fd, packet)

    def close(self) -> None:
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class UeGateway:
    """srsue gw.cc: bridge a TunDevice to the UE stack's DRB user plane."""

    def __init__(self, ue_stack, tun: TunDevice):
        self.ue = ue_stack
        self.tun = tun

    def pump(self) -> int:
        """Move pending packets both ways; returns how many moved.
        Call once per TTI (the reference runs a blocking read thread;
        the subframe-synchronous loop polls instead)."""
        n = 0
        while True:
            pkt = self.tun.read_packet()
            if pkt is None:
                break
            self.ue.send_ip(pkt)
            n += 1
        while self.ue.rx_ip:
            self.tun.write_packet(self.ue.rx_ip.pop(0))
            n += 1
        return n


class SgiGateway:
    """srsepc spgw SGi side: bridge the operator-network TUN to the
    GTP-U tunnels (spgw.cc run_thread's sgi->s1u and s1u->sgi loops)."""

    def __init__(self, spgw, enb_stack, tun: TunDevice):
        self.spgw = spgw
        self.enb = enb_stack
        self.tun = tun

    def pump(self) -> int:
        n = 0
        while True:
            pkt = self.tun.read_packet()
            if pkt is None:
                break
            fwd = self.spgw.downlink(pkt)
            if fwd is not None:
                self.enb.deliver_gtpu(fwd[1])
                n += 1
        while self.enb.ul_gtpu:
            ip = self.spgw.uplink(self.enb.ul_gtpu.pop(0))
            if ip is not None:
                self.tun.write_packet(ip)
                n += 1
        return n


class NetNs:
    """A scoped network namespace for the UE side of single-host tests."""

    def __init__(self, name: str):
        self.name = name
        # a namespace left by an earlier run that did not close would make
        # ``ip netns add`` fail: delete it first (absent: a no-op)
        subprocess.run(["ip", "netns", "del", name], capture_output=True)
        subprocess.run(["ip", "netns", "add", name], check=True,
                       capture_output=True)
        _ip("link", "set", "lo", "up", netns=name)

    def run(self, argv: list[str], **kw):
        return subprocess.run(["ip", "netns", "exec", self.name] + argv,
                              **kw)

    def popen(self, argv: list[str], **kw):
        return subprocess.Popen(["ip", "netns", "exec", self.name] + argv,
                                **kw)

    def close(self) -> None:
        subprocess.run(["ip", "netns", "del", self.name],
                       capture_output=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
