"""The user plane through real TUN devices, on the port's stack on the
CPU.

``tests/test_tun_gateway.py`` with its asserts, on the port's stacks with
``device="cpu"`` and the port's ``runtime/tun.py``: the UE's TUN lives in
a network namespace, so a UDP socket there reaches a UDP socket on the
host only through the whole stack (kernel -> TUN -> PDCP/RLC/MAC ->
PUSCH IQ -> eNB -> GTP-U -> SP-GW -> SGi TUN -> kernel) and back.

Every name and address this test gives the host is its own: the
namespaces and TUN devices carry a random suffix, the SGi interface and
the UE address pool are /24s of the benchmarking block 198.18.0.0/15 that
no interface or route of the host uses, and the server binds to a port
the kernel picks. So two runs on one host leave each other alone.

Skipped where the process lacks CAP_NET_ADMIN, as the JAX test is.
"""

import ipaddress
import random
import socket
import subprocess
import sys
import uuid

import pytest

from empower_srslte_tpu_torch.apps.lte_attach import IMSI, KEY, OP
from empower_srslte_tpu_torch.epc import Hss, Subscriber
from empower_srslte_tpu_torch.epc.mme import Mme, UeNas
from empower_srslte_tpu_torch.epc.spgw import SpGw
from empower_srslte_tpu_torch.runtime.tun import (NetNs, SgiGateway,
                                                  TunDevice, UeGateway,
                                                  tun_available)
from empower_srslte_tpu_torch.stack import Air, EnbStack, UeStack
from empower_srslte_tpu_torch.tools.stack_drive import StackDrive
from empower_srslte_tpu_torch.upper import security
from empower_srslte_tpu_torch.utils.cell import Cell

#: this run's suffix of every host-global name (a TUN name has at most 15
#: characters)
TAG = uuid.uuid4().hex[:8]
#: RFC 2544's block for benchmark networks
BENCH_NET = ipaddress.ip_network("198.18.0.0/15")


def _netns_available() -> bool:
    name = f"probe{TAG}"
    try:
        subprocess.run(["ip", "netns", "add", name], check=True,
                       capture_output=True)
        subprocess.run(["ip", "netns", "del", name], capture_output=True)
        return True
    except Exception:
        return False


requires_netadmin = pytest.mark.skipif(
    not (tun_available() and _netns_available()),
    reason="needs CAP_NET_ADMIN (tun + netns)")


def _unused_subnets(n: int) -> list:
    """``n`` /24s of ``BENCH_NET``, drawn at random, that no address or
    route of the host overlaps."""
    out = []
    for net in random.sample(list(BENCH_NET.subnets(new_prefix=24)), 64):
        busy = [subprocess.run(["ip", "-4", "-o", *cmd, str(net)],
                               capture_output=True, text=True).stdout.strip()
                for cmd in (("addr", "show", "to"), ("route", "show",
                                                      "root"))]
        if not any(busy):
            out.append(net)
            if len(out) == n:
                return out
    raise RuntimeError(f"no {n} unused /24s in {BENCH_NET}")


CLIENT = r"""
import socket, sys
s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
s.settimeout(600)
s.bind(("{ue_ip}", 9000))
s.sendto(b"PING-VIA-TUN", ("{sgi_ip}", {port}))
data, addr = s.recvfrom(2048)
print("GOT:" + data.decode(), flush=True)
"""


@requires_netadmin
def test_udp_round_trip_through_the_stack():
    sgi_net, ue_net = _unused_subnets(2)
    sgi_ip = str(next(sgi_net.hosts()))
    opc = security.milenage_opc(KEY, OP)
    hss = Hss()
    hss.add_subscriber(Subscriber(name="demo", auth_algo="mil", imsi=IMSI,
                                  key=KEY, opc=opc))
    mme = Mme(hss, spgw=SpGw(ue_subnet=str(ue_net)))
    cell = Cell(nof_prb=25, id=1)
    enb = EnbStack(cell, mme, device="cpu")
    ue = UeStack(cell, UeNas(imsi=IMSI, key=KEY, opc=opc), device="cpu")
    drive = StackDrive([enb], [ue], air=Air(cell.sf_sample_len))

    # 1) attach over the air (in-memory IQ)
    drive.run(100, lambda tti: ue.rrc.nas.attached and bool(ue.rrc.drbs))
    assert ue.rrc.nas.attached, "attach failed"
    ue_ip = ue.rrc.nas.ue_ip

    ns = ue_tun = sgi_tun = client = server = None
    try:
        # 2) TUN endpoints: UE side in a namespace, SGi on the host
        ns = NetNs(f"lteue{TAG}")
        ue_tun = TunDevice(f"tue{TAG}", netns=ns.name)
        ue_tun.set_ip(f"{ue_ip}/24")
        ue_tun.add_route("default")
        sgi_tun = TunDevice(f"tsgi{TAG}",
                            ip_cidr=f"{sgi_ip}/{sgi_net.prefixlen}")
        sgi_tun.add_route(f"{ue_ip}/32")

        gw = UeGateway(ue, ue_tun)
        sgi = SgiGateway(mme.spgw, enb, sgi_tun)

        # 3) real sockets: server on the host SGi address, client in the
        # UE namespace
        server = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        server.bind((sgi_ip, 0))
        server.setblocking(False)

        client = ns.popen(
            [sys.executable, "-c", CLIENT.format(
                ue_ip=ue_ip, sgi_ip=sgi_ip, port=server.getsockname()[1])],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        # 4) TTIs pumping both gateways
        got = []

        def pump(tti):
            gw.pump()
            sgi.pump()
            if not got:
                try:
                    got.append(server.recvfrom(2048))
                    server.sendto(b"PONG-VIA-TUN", got[0][1])
                except BlockingIOError:
                    pass
            return client.poll() is not None

        drive.run(drive.tti + 600, pump)
        assert got, "uplink packet never reached the SGi socket"
        data, addr = got[0]
        assert data == b"PING-VIA-TUN"
        assert addr[0] == ue_ip
        out, err = client.communicate(timeout=10)
        assert "GOT:PONG-VIA-TUN" in out, (out, err)
    finally:
        if client is not None and client.poll() is None:
            client.kill()
        if server is not None:
            server.close()
        for dev in (ue_tun, sgi_tun):
            if dev is not None:
                dev.close()
        if ns is not None:
            ns.close()
