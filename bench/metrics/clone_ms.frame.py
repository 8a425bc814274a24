"""Device milliseconds of device-to-device copies a frame: the canvas
cloned out of the graph's pool, and the 16-byte window copied into it."""

COPY = "Memcpy DtoD (Device -> Device)"


def read(ctx):
    seconds = ctx.trace.device_s.get(COPY, 0.0)
    if seconds <= 0 or not ctx.frames:
        return None
    return 1e3 * seconds / ctx.frames
