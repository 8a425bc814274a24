"""Read-backs that wait only for their own dispatch.

A pipelined caller enqueues chunk k+1 on a device before it reads chunk k
back, and on the card both chunks run on the device's one compute stream:
the single-pass scans of a device share one look-back scratch
(``kernels._build.lookback_scratch``), so two chunks never run at once on
two compute streams. A plain ``.cpu()`` or ``.tolist()`` of chunk k is
enqueued on that stream too, behind chunk k+1, and so waits for both. JAX's
read-back of a buffer waits only for the buffer's own definition event.
The two helpers here give the port the same:

* ``StatsCopy``: a dispatch's stats, copied into pinned host memory at
  enqueue time, on the compute stream right behind the pipeline that
  wrote them, with a CUDA event recorded after the copy. ``read()`` waits
  on that event alone, and the event also marks the dispatch's canvases
  as written (``ready`` of the dispatch handles).
* ``HostCopy`` / ``to_host``: the host copy of a canvas tensor. It runs
  on a second stream of the device (``copy_stream``), which waits on the
  dispatch's event and copies into pinned memory; the source is marked as
  used on that stream (``record_stream``), so the caching allocator does
  not hand its memory to a later chunk while the copy still reads it. The
  result is a numpy array of its own; the pinned buffer goes back to the
  allocator. ``HostCopy`` starts the copy when it is made, lands it in
  numpy on a host thread, and waits for it at ``result()``, so a caller
  can start it as soon as the dispatch is enqueued
  (``ShardedDispatch.host_copy``); ``to_host`` does both at once.

On the CPU there is nothing to wait for: both are plain copies.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["StatsCopy", "HostCopy", "copy_stream", "to_host",
           "gather_on_first"]

_COPY_STREAMS: dict = {}  # device index -> the device's copy stream
_WORKER = None  # the host-copy thread's executor, made on first use


def copy_stream(device: torch.device) -> torch.cuda.Stream:
    """The device's copy stream: host copies and cross-device gathers run
    on it, never compute."""
    stream = _COPY_STREAMS.get(device.index)
    if stream is None:
        stream = _COPY_STREAMS[device.index] = torch.cuda.Stream(device)
    return stream


class StatsCopy:
    """The host copy of one dispatch's stats, started at enqueue time.

    ``values`` is the flat stats tensor the pipeline just wrote. On the
    card it is copied into pinned memory with ``non_blocking=True`` on the
    current stream, and ``event`` is recorded after the copy; on the CPU
    it is kept as it is and ``event`` is None."""

    def __init__(self, values: torch.Tensor):
        if values.device.type == "cuda":
            self._host = torch.empty(values.shape, dtype=values.dtype,
                                     pin_memory=True)
            self._host.copy_(values, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(values.device))
        else:
            self._host, self.event = values, None

    def read(self) -> np.ndarray:
        """Wait on ``event`` only, then the values as numpy."""
        if self.event is not None:
            self.event.synchronize()
        return self._host.numpy()


class HostCopy:
    """A host copy started now, read later.

    ``parts`` are (tensor, event) pairs, concatenated along the first axis
    in the copy. Each CUDA part is copied on its device's copy stream once
    its event (None: everything enqueued so far on the current stream) has
    passed, into pinned memory, and marked as used on that stream
    (``record_stream``); the constructor makes no host sync. The copy out
    of pinned memory into a numpy array of its own runs on the host-copy
    thread (one for the process, made on first use), which waits for
    these copies alone; ``result()`` waits for it. So a copy started at
    enqueue time lands while the caller still works on the chunk before,
    both releasing the interpreter lock (a CUDA event wait, a numpy
    copy); the pinned buffers then go back to the allocator. Anything
    else (numpy, a CPU tensor) is copied on that thread as it is."""

    def __init__(self, parts):
        staged = []
        for x, ready in parts:
            if not (isinstance(x, torch.Tensor) and x.is_cuda):
                staged.append((x, None))
                continue
            side = copy_stream(x.device)
            if ready is None:
                side.wait_stream(torch.cuda.current_stream(x.device))
            else:
                side.wait_event(ready)
            with torch.cuda.stream(side):
                pinned = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                pinned.copy_(x, non_blocking=True)
                done = torch.cuda.Event()
                done.record(side)
            x.record_stream(side)
            staged.append((pinned, done))
        self._landed = _worker().submit(_land, staged)

    def result(self) -> np.ndarray:
        """The parts as one numpy array, once they have landed."""
        return self._landed.result()


def _worker() -> concurrent.futures.ThreadPoolExecutor:
    global _WORKER
    if _WORKER is None:
        _WORKER = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="host-copy")
    return _WORKER


def _land(staged) -> np.ndarray:
    """Wait for each staged copy, then copy the parts out into one array."""
    out = []
    for x, done in staged:
        if done is not None:
            done.synchronize()
        out.append(x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x))
    return np.array(out[0]) if len(out) == 1 else np.concatenate(out)


def to_host(x, ready: Optional[torch.cuda.Event] = None) -> np.ndarray:
    """``x`` as a numpy array of its own, where JAX calls ``np.asarray`` on
    a device array. A CUDA tensor is copied on its device's copy stream
    once ``ready`` (the dispatch's event; None: everything enqueued so far
    on the current stream) has passed, and only that copy is waited for
    (``HostCopy``)."""
    return HostCopy([(x, ready)]).result()


def gather_on_first(parts: Sequence[torch.Tensor],
                    events: Sequence[Optional[torch.cuda.Event]]):
    """Concatenate the shards' canvases ``parts`` (one a device, frame
    order) on the first one's device, once each shard's event has passed.
    On the card the copies and the concatenation run on the devices' copy
    streams, so they wait for these shards only, and the caller's current
    stream on the first device is made to wait for the result (a stream
    dependency, no work). Returns (tensor, event after which it is
    written; None on the CPU)."""
    first = parts[0].device
    if first.type != "cuda":
        return torch.cat([p.to(first) for p in parts]), None
    with contextlib.ExitStack() as stack:
        # a cross-device copy runs on the source's current stream and the
        # destination's: both become copy streams, the first's last
        for part, event in sorted(zip(parts, events),
                                  key=lambda pe: pe[0].device == first):
            side = copy_stream(part.device)
            if event is not None:
                side.wait_event(event)
            stack.enter_context(torch.cuda.stream(side))
            part.record_stream(side)
        out = torch.cat([p.to(first, non_blocking=True) for p in parts])
        ready = torch.cuda.Event()
        ready.record(copy_stream(first))
    current = torch.cuda.current_stream(first)
    current.wait_event(ready)
    out.record_stream(current)
    return out, ready
