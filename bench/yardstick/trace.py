"""Reading a torch.profiler session of the measured window.

CUPTI traces the kernel nodes of a CUDA graph only if its kernel
activities were on when the graph was instantiated. So a traced run holds
one recording session (``recording``) from before its first request,
which captures the graphs, to the window's end, and marks the window with
a host range named ``WINDOW``; ``read`` keeps what lies inside it.
"""

from __future__ import annotations

import bisect
import contextlib
import re
from typing import NamedTuple

_NAME = re.compile(r"([A-Za-z_][\w]*)\s*[<(]")
WINDOW = "bench.window"


def short_name(name: str) -> str:
    """A device activity's function name: ``void region_dwell_kernel<0,
    16>(int*, ...)`` -> ``region_dwell_kernel``; copies and memsets keep
    their names."""
    if name.startswith(("Memcpy", "Memset")):
        return name
    if name.startswith("void "):
        name = name[5:]
    m = _NAME.search(name.replace("::", "_SEP_"))
    return name if m is None else m.group(1).split("_SEP_")[-1]


class Trace(NamedTuple):
    device_s: dict  # short name -> summed device seconds
    counts: dict  # short name -> activities
    busy_s: float  # union of the device activities, a card
    span_s: float  # the window's range
    idle_by_host: dict  # what the host was in -> the first card's idle s


@contextlib.contextmanager
def recording():
    """A recording profiler session of the CPU and the card."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof


def _is_device(e) -> bool:
    from torch.autograd import DeviceType
    if e.device_type != DeviceType.CUDA:
        return False
    # the profiler lays its step and user ranges on the device timeline too
    kind = str(getattr(e, "activity_type", "")).lower()
    return "annotation" not in kind and e.name != WINDOW and \
        not e.name.startswith("ProfilerStep")


def _union(intervals) -> tuple:
    """(covered length, gaps between) of sorted [start, end] intervals."""
    covered, gaps = 0.0, []
    cur_start = cur_end = None
    for start, end in intervals:
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                covered += cur_end - cur_start
                gaps.append((cur_end, start))
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        covered += cur_end - cur_start
    return covered, gaps


def read(prof, chips: int = 1) -> Trace:
    """The window's device activities by name, their union on each card
    averaged over ``chips``, and the idle time of the first card between
    its activities by the innermost host event at each gap's middle."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    spans = [e.time_range for e in events
             if e.name == WINDOW and e.device_type == DeviceType.CPU]
    if not spans:
        raise RuntimeError(f"the trace holds no {WINDOW!r} range")
    w0, w1 = spans[0].start, spans[0].end
    device, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if end < w0 or start > w1:
            continue
        if _is_device(e):
            if end > start:
                device.append((max(start, w0), min(end, w1),
                               short_name(e.name),
                               getattr(e, "device_index", 0)))
        elif e.device_type == DeviceType.CPU and e.name != WINDOW:
            host.append((start, end, e.name))
    device_s, counts = {}, {}
    for start, end, name, _ in device:
        device_s[name] = device_s.get(name, 0.0) + (end - start) * 1e-6
        counts[name] = counts.get(name, 0) + 1
    device.sort()
    host.sort()
    cards = sorted({d for *_, d in device})
    busy = 0.0
    gaps = []
    for card in cards:
        mine = [(a, b) for a, b, _, d in device if d == card]
        covered, between = _union(mine)
        busy += covered
        if card == cards[0]:
            gaps = [(w0, mine[0][0])] + between + \
                [(max(b for _, b in mine), w1)]
    starts = [s for s, _, _ in host]
    idle: dict = {}
    for a, b in gaps:
        mid = (a + b) / 2
        label = "python"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(-1, i - 256), -1):
            if host[j][1] >= mid:
                label = host[j][2]
                break
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-6
    return Trace(device_s, counts, busy / max(chips, 1) * 1e-6,
                 (w1 - w0) * 1e-6, idle)


def kernel_seconds(tr: Trace, names) -> float:
    """Device seconds of the activities named in ``names``."""
    return sum(tr.device_s.get(n, 0.0) for n in names)


def top(d: dict, k: int = 10) -> list:
    """The ``k`` largest entries of a name -> seconds map."""
    return [[n, s] for n, s in sorted(d.items(), key=lambda x: -x[1])[:k]]
