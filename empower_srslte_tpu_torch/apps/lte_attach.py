"""Full-stack demo: srsUE + srsENB + srsEPC equivalents attach over an
IQ air interface, with S1AP over a local socket, on the port's PHY.

The integration the reference's three binaries perform (srsue/srsenb/
srsepc), in one process: PRACH -> RAR -> msg3/contention resolution ->
RRC connection -> NAS mutual auth -> AS security -> DRB setup, then one
ping up and one pong down the user plane. The PHY runs on the CUDA card
unless ``--cpu`` is given, and raises without one.

  python -m empower_srslte_tpu_torch.apps.lte_attach [--prb 25] [--snr 15]
      [--imsi ...] [--max-tti 100] [--cpu]
"""

from __future__ import annotations

import argparse
import sys
import time

#: the demo subscriber's key and operator key (Milenage test values)
KEY = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
OP = bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318")
IMSI = "001010123456789"


def epc(imsi: str = IMSI):
    """An MME over an HSS that knows the demo subscriber ``imsi``, and
    that subscriber's UE-side NAS: (mme, nas)."""
    from ..epc import Hss, Subscriber
    from ..epc.mme import Mme, UeNas
    from ..upper import security

    opc = security.milenage_opc(KEY, OP)
    hss = Hss()
    hss.add_subscriber(Subscriber(name="demo", auth_algo="mil", imsi=imsi,
                                  key=KEY, opc=opc))
    return Mme(hss), UeNas(imsi=imsi, key=KEY, opc=opc)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--prb", type=int, default=25)
    ap.add_argument("--snr", type=float, default=None,
                    help="air SNR in dB (default: noiseless)")
    ap.add_argument("--imsi", default=IMSI)
    ap.add_argument("--max-tti", type=int, default=100)
    ap.add_argument("--cpu", action="store_true",
                    help="run the PHY on the CPU (default: the CUDA card)")
    args = ap.parse_args(argv)

    import numpy as np

    from ..runtime.logging import get_logger
    from ..s1ap.procedures import EnbS1ap, MmeS1ap
    from ..s1ap.transport import S1Client, S1Server
    from ..stack import Air, EnbStack, UeStack
    from ..upper.gtpu import gtpu_unpack
    from ..utils.cell import Cell
    from ..utils.device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    log = get_logger("STACK", "info")

    mme, nas = epc(args.imsi)
    mme_s1 = MmeS1ap(mme=mme)
    server = S1Server(mme_s1.handle)
    client = S1Client("127.0.0.1", server.port)
    try:
        log.info("EPC up (S1AP on 127.0.0.1:%d)", server.port)
        cell = Cell(nof_prb=args.prb, id=1)
        enb = EnbStack(cell, EnbS1ap(send=client), device=device)
        ue = UeStack(cell, nas, device=device)
        air = Air(cell.sf_sample_len, snr_db=args.snr,
                  h_dl=0.9 * np.exp(1j * 0.5), h_ul=0.85 * np.exp(-1j * 0.3))
        log.info("cell: %d PRB, id %d; air SNR: %s; PHY on %s", args.prb,
                 cell.id, f"{args.snr} dB" if args.snr is not None
                 else "ideal", device)

        seen: set = set()

        def show(tag, events):
            for e in events:
                if (tag, e) not in seen:
                    seen.add((tag, e))
                    log.info("[%s] %s", tag, e)

        t0 = time.time()
        ul_iq = None
        for tti in range(args.max_tti):
            dl_iq = enb.tti(tti, air.ul(ul_iq) if ul_iq is not None
                            else None)
            ul_iq = ue.tti(tti, air.dl(dl_iq))
            show("UE", ue.events)
            show("UE-RRC", ue.rrc.events)
            show("ENB", enb.events)
            show("MME", mme_s1.events)
            if ue.rrc.nas.attached and ue.rrc.drbs and not ue.rx_ip \
                    and not enb.ul_gtpu and "ping_sent" not in seen:
                seen.add("ping_sent")
                log.info("ATTACH COMPLETE at tti %d (%.1fs wall): IP %s, "
                         "DRBs %s", tti, time.time() - t0, ue.rrc.nas.ue_ip,
                         ue.rrc.drbs)
                ue.send_ip(b"\x45\x00" + bytes(18) + b"PING-FROM-UE-01")
                pong = (b"\x45\x00" + bytes(14)
                        + bytes(map(int, ue.rrc.nas.ue_ip.split(".")))
                        + b"PONG-TO-THE-UE!")
                fwd = mme.spgw.downlink(pong)
                if fwd is not None:
                    enb.deliver_gtpu(fwd[1])
            if enb.ul_gtpu and ue.rx_ip:
                sgi = mme.spgw.uplink(enb.ul_gtpu[0])
                if sgi is None:
                    log.error("the SP-GW dropped the uplink GTP-U (TEID "
                              "%d)", gtpu_unpack(enb.ul_gtpu[0])[0])
                    return 1
                log.info("USER PLANE: UL %r at SGi, DL %r at UE",
                         sgi[-15:], ue.rx_ip[0][-15:])
                return 0
        log.error("attach did not complete in %d ttis", args.max_tti)
        return 1
    finally:
        server.close()
        client.close()


if __name__ == "__main__":
    sys.exit(main())
