"""turbo_roofline.tm2: the least time the TM2 receiver's turbo decodes
could take over the device time of every operation launched inside
``dlsch.turbo_decode``, in %: one codeword of 13 code blocks of K 5824
a subframe, 3,328 a call at 256 subframes, on the NII kernel in
bfloat16. The least time (``phybench.roofline``) counts the
max-log-MAP work of the iterations each call ran, from the
configuration's segmentation, and each code block's LLRs read once and
bits written once.

Layer: kernels. Moves mbps. Ranges: dlsch.turbo_decode.
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
