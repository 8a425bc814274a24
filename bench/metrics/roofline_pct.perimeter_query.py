"""Q's share of its roofline: the exact work of every level's live
regions of the window's frames (``work.border_work``, in flops) and the
bytes a query moves, at the card's peaks, over the device time of the
single-frame border query."""

from bench.yardstick import trace, work

KERNELS = ("perimeter_query_kernel",)


def read(ctx):
    return work.roofline_pct(trace.kernel_seconds(ctx.trace, KERNELS),
                             ctx.work["query_flops"], ctx.work["query_bytes"])
