"""Frames the service dispatched again after an overflow, a chunk:
``ChunkStats.retries`` over the window's chunks."""


def read(ctx):
    if not ctx.chunks:
        return None
    return sum(c.retries for c in ctx.chunks) / len(ctx.chunks)
