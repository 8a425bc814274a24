"""The service's host milliseconds to enqueue a chunk: the mean of
``ChunkStats.dispatch_s`` over the window's chunks."""


def read(ctx):
    if not ctx.chunks:
        return None
    return 1e3 * sum(c.dispatch_s for c in ctx.chunks) / len(ctx.chunks)
