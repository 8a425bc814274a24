"""Pooled A's share of its roofline: the escape flops of every leaf pixel
of the window's frames (and the canvas bytes A writes), at the card's
peaks, over the device time of the pooled leaf kernel."""

from bench.yardstick import trace, work

KERNELS = ("region_dwell_pooled_kernel",)


def read(ctx):
    return work.roofline_pct(trace.kernel_seconds(ctx.trace, KERNELS),
                             ctx.work["leaf_flops"], ctx.work["leaf_bytes"])
