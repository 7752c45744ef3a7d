"""turbo_win_roofline: the least time the UL-SCH's turbo decodes of the
traced uplink calls could take over the device time of every operation
launched inside ``dlsch.turbo_decode``, in %. The least time
(``phybench.roofline``, unchanged) counts the max-log-MAP work of the
iterations each call ran, from the configuration's segmentation, and each
code block's LLRs read once and bits written once; it does not depend on
which kernel (here the windowed one) implements the decode.

Layer: kernels. Moves mbps.
"""

from phybench import roofline

RANGES = ("dlsch.turbo_decode",)


def read(trace, ctx):
    device_s = trace.device_s(RANGES)
    if device_s <= 0:
        return None
    drv = ctx["driver"]
    work = [w for its in ctx["iterations"]
            for w in drv.turbo_work(its, drv.per)]
    return 100.0 * roofline.turbo_least_s(work) / device_s
