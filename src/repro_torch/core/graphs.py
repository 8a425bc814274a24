"""CUDA-graph replays: the one-dispatch engines on the card.

The JAX package runs ``run_ask_fused`` and ``run_ask_scan`` each as one
jitted XLA program, cached per (problem, capacities) (``_jitted_pipeline``
in ``repro/core/ask.py``). On the card their counterpart is one replay of
a CUDA graph of the engine's whole level loop: ``replay(key, fn,
*inputs)`` captures ``fn`` the first time it sees ``key`` and replays the
graph on every later call.

A capture first runs ``fn`` once on a side stream of this module (the
warm-up: it loads every kernel library, caches the grid sizes and makes
each single-pass scan's look-back scratch on that stream, none of which
may happen under a capture), then captures a second run of it on the same
stream with ``torch.cuda.graph``. ``fn`` must have static shapes and make
no host sync, which the capture enforces: a capture that fails raises, and
nothing falls back to eager launches. Every replay runs on that side
stream too, after the caller's stream and before the caller's next work:
the graphs of a device share its look-back scratch, so two replays never
run at once.

``inputs`` are copied into the graph's own static tensors before each
replay, so one graph serves any values of them (the frame's window). With
``borrow=b`` the first b inputs of the capturing call become the graph's
static tensors themselves (its warm-up runs on copies of them), and a
later call that passes those same tensors copies nothing: the split scan's
refine graph reads the coarse graph's carry where it lies
(``core.progressive``). The outputs are the graph's static tensors, which
the next replay overwrites: a caller clones what it hands on, and
``static(key)`` shows a caller which tensors a replay of ``key`` writes.

A graph keeps every tensor of its run in a private memory pool (at n=16384
the canvas alone is 1 GiB), and the look-back scratches its capture used
(``_build.keeping_captured``), so the cache is bounded by bytes,
``MAX_SHARE`` of the card's memory (the least recently replayed graphs go
first), and ``release()`` drops every graph and returns its memory.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Hashable, Tuple

import torch

from repro_torch.kernels import _build

__all__ = ["MAX_SHARE", "replay", "static", "release", "held"]

MAX_SHARE = 0.25  # of the card's memory, which the graphs' pools may hold


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph
    inputs: Tuple[torch.Tensor, ...]  # copied into before each replay
    outputs: Tuple[torch.Tensor, ...]  # written by each replay
    nbytes: int  # the private pool's reserved bytes
    scratch: list  # the look-back scratches the graph's kernels point to


_GRAPHS: "collections.OrderedDict[Hashable, _Graph]" = collections.OrderedDict()
_STREAMS: dict = {}  # device index -> the side stream of captures and replays


def _stream(device: torch.device) -> torch.cuda.Stream:
    stream = _STREAMS.get(device.index)
    if stream is None:
        stream = _STREAMS[device.index] = torch.cuda.Stream(device)
    return stream


def _capture(fn: Callable, inputs, device: torch.device,
             borrow: int) -> _Graph:
    stream = _stream(device)
    static = tuple(x if i < borrow else x.clone()
                   for i, x in enumerate(inputs))
    warm = tuple(x.clone() for x in static[:borrow]) + static[borrow:]
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        fn(*warm)  # the warm-up
    del warm
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved(device)
    graph = torch.cuda.CUDAGraph()
    with _build.keeping_captured() as scratch:
        with torch.cuda.graph(graph, stream=stream):
            outputs = tuple(fn(*static))
    return _Graph(graph, static, outputs,
                  torch.cuda.memory_reserved(device) - before, scratch)


def replay(key: Hashable, fn: Callable, *inputs: torch.Tensor,
           device: torch.device, borrow: int = 0) -> Tuple[torch.Tensor, ...]:
    """``fn(*inputs)`` on ``device`` as one replay of the CUDA graph cached
    under ``key`` (captured now if there is none; its first ``borrow``
    inputs are then its static tensors). ``fn`` returns a tuple of
    tensors; so does this, the graph's static outputs, ready on the
    caller's current stream. An input that is the graph's static tensor
    is not copied."""
    entry = _GRAPHS.get(key)
    if entry is None:
        entry = _GRAPHS[key] = _capture(fn, inputs, device, borrow)
        _evict(key, torch.cuda.get_device_properties(device).total_memory
               * MAX_SHARE)
    _GRAPHS.move_to_end(key)
    stream, current = _stream(device), torch.cuda.current_stream(device)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        for dst, src in zip(entry.inputs, inputs):
            if dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        entry.graph.replay()
    current.wait_stream(stream)
    return entry.outputs


def static(key: Hashable):
    """(static inputs, static outputs) of the graph cached under ``key``,
    or None: the tensors a replay of it reads and writes."""
    entry = _GRAPHS.get(key)
    return None if entry is None else (entry.inputs, entry.outputs)


def _evict(keep: Hashable, limit: float) -> None:
    """Drop the least recently replayed graphs, all but ``keep``, until the
    pools hold at most ``limit`` bytes."""
    total = sum(e.nbytes for e in _GRAPHS.values())
    dropped = False
    for key in list(_GRAPHS):
        if total <= limit:
            break
        if key != keep:
            total -= _GRAPHS.pop(key).nbytes
            dropped = True
    if dropped:
        torch.cuda.empty_cache()


def release() -> None:
    """Drop every cached graph and return its pool, and every look-back
    scratch only a graph still held, to the device."""
    _GRAPHS.clear()
    if torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def held() -> Tuple[int, int]:
    """(graphs cached, bytes their pools hold)."""
    return len(_GRAPHS), sum(e.nbytes for e in _GRAPHS.values())
