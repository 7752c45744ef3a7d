"""IQ capture to file through the RF HAL (lib/examples/usrp_capture.c
analog): open a device (auto-probe or named, rf_imp.c:103-126 parity),
tune, set gain/rate, stream N subframes into a binary capture that
FileSource / the reference's filesource can read back. Host only: no
PHY work, so no device flag.

  python -m empower_srslte_tpu_torch.apps.iq_capture -o /tmp/cap.bin
      -n 100 -d file -a rx=/tmp/enb.bin      # any registered HAL device
  python -m empower_srslte_tpu_torch.apps.iq_capture -o /tmp/cap.bin
      -d stream -a rx=/tmp/enb.bin           # the native ring buffer
"""

from __future__ import annotations

import argparse
import sys

from ..runtime.io import FileSink
from ..runtime.logging import get_logger
from ..runtime.rf import rf_open
from ..utils.cell import Cell


def capture(output: str, subframes: int = 100, nof_prb: int = 25,
            freq: float = 2.68e9, gain: float = 50.0,
            device_name: str | None = None, device_args: str = "",
            log=None) -> dict:
    """Stream ``subframes`` subframes of the opened RF device into the file
    ``output``. -> dict(device, srate, first_ts, timestamps, overflows):
    the device's name, the sample rate set, each read's timestamp, and the
    ring buffer's overflow count for a ``stream`` device (None for
    others)."""
    cell = Cell(nof_prb=nof_prb, id=0)
    srate = cell.sf_sample_len * 1000.0

    dev = rf_open(device_name, device_args)
    if log is not None:
        log.info("opened RF device '%s'", dev.name)
    dev.set_rx_srate(srate)
    dev.set_rx_gain(gain)
    dev.set_rx_freq(freq)
    dev.start_rx_stream()

    stamps = []
    try:
        with FileSink(output) as sink:
            for _ in range(subframes):
                samples, ts = dev.recv_with_time(cell.sf_sample_len)
                stamps.append(ts)
                sink.write(samples)
        # the stream device's ring buffer, read before close frees it
        ring = getattr(dev, "_stream", None)
        overflows = ring.overflows if ring is not None else None
        dev.stop_rx_stream()
    finally:
        dev.close()
    return dict(device=dev.name, srate=srate,
                first_ts=stamps[0] if stamps else None, timestamps=stamps,
                overflows=overflows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("-o", "--output", required=True)
    ap.add_argument("-n", "--subframes", type=int, default=100)
    ap.add_argument("-p", "--nof-prb", type=int, default=25,
                    help="sets the sample rate from the cell bandwidth")
    ap.add_argument("-f", "--freq", type=float, default=2.68e9)
    ap.add_argument("-g", "--gain", type=float, default=50.0)
    ap.add_argument("-d", "--device", default=None,
                    help="HAL device name (default: auto-probe)")
    ap.add_argument("-a", "--args", default="", help="device args")
    args = ap.parse_args(argv)

    log = get_logger("CAPT", "info")
    got = capture(args.output, args.subframes, args.nof_prb, args.freq,
                  args.gain, args.device, args.args, log=log)
    log.info("wrote %d subframes (%.2f Msps, first ts %s) to %s",
             args.subframes, got["srate"] / 1e6, got["first_ts"], args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
