"""Split ASK scan: a cheap coarse preview early, the exact canvas after.

Counterpart of ``repro/core/progressive.py``. The scan engine's level loop
is split at a *checkpoint level* k into two halves that run the scan's own
level code (``ask.scan_start`` / ``scan_levels`` / ``scan_leaf``, and for a
batch ``pooled.pool_start`` / ``pool_levels`` / ``pool_leaf``), so their
composition is the unsplit loop, operation for operation:

* the **coarse** half runs levels [0, k), homogeneous regions filled as
  the full loop fills them, then paints a preview: a copy of the canvas
  on which every region still live at level k is filled with its border's
  common value (``FrameProblem.preview_step``: one Q and one T, no
  per-pixel dwell). The scan's own canvas is never painted;
* the **refine** half resumes from the carry the coarse half leaves on the
  device -- ``(state, ring, parity, count, dropped)``, the unsplit loop's
  carry at level k -- over levels [k, tau) and the leaf pass. The refined
  canvas equals ``run_ask_scan``'s at the same capacities, bit for bit.

No host sync happens between ``dispatch_progressive`` and the return of
``refine()``: the counts stay on the device, their copy to pinned host
memory is enqueued behind the refine half (``readback.StatsCopy``), and
``RefineDispatch.finalize`` waits on that copy's event alone, so a caller
may enqueue more work before it. ``kernel_launches`` is 2, one engine
dispatch a half. Each half's handle has ``ready``, the CUDA event after
which its canvases are written, for ``readback.to_host``.

On the card a single frame's halves are each one replay of a CUDA graph
(``core.graphs``), keyed on (half, capacities, k, ``graph_key``); the
preview is painted eagerly on a clone of the coarse graph's canvas. The
refine graph reads the coarse graph's carry where it lies (``borrow``):
the coarse graph's static outputs are its static inputs. A later coarse
replay of the same key would overwrite that carry, so a carry has at most
one holder, the ``CoarseDispatch`` whose carry it is, until its
``refine()``: before a replay writes a graph's static carry, the carry's
holder (if another dispatch) gets a copy of it (it is *spilled*), enqueued
on the caller's stream, which every replay waits on. A spilled dispatch's
``refine()`` copies its carry back in, spilling the then holder in turn.
Dispatches refined in order, as a pipelined caller makes them, copy
nothing (copying the carry out and in, as other graph inputs are copied,
measured 1.1-1.6 ms slower a split render at n=16384; PERF.md). A batch runs eagerly, as the batched scan does (its canvas is
8 GiB at n=16384, F=8: a graph's clone of it costs more than the enqueue it
saves; PERF.md).
"""

from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Sequence, Tuple, Union

import torch

from repro_torch.core import graphs, pooled, readback
from repro_torch.core.ask import (ASKStats, _resolve_capacities, scan_leaf,
                                  scan_levels, scan_live, scan_start)
from repro_torch.core.cost_model import num_levels
from repro_torch.kernels import ops

__all__ = ["CoarseDispatch", "RefineDispatch", "checkpoint_for",
           "dispatch_progressive", "dispatch_progressive_batch",
           "run_ask_scan_progressive"]

# data_ptr of a graph's static carry canvas -> (a weak reference to) the
# CoarseDispatch holding it; a dispatch dropped unrefined holds nothing
_HELD: dict = {}


def checkpoint_for(problem, checkpoint_level: Union[int, None]) -> int:
    """Clamp a requested checkpoint level into [0, tau]. ``None`` is the
    default split: after level 1 when the ladder is that deep, else after
    every level there is."""
    levels = num_levels(problem.n, problem.g, problem.r, problem.B)
    if checkpoint_level is None:
        return min(1, levels)
    k = int(checkpoint_level)
    if k < 0:
        raise ValueError(f"checkpoint_level must be >= 0, got {k}")
    return min(k, levels)


def _claim(carry) -> None:
    """Spill the dispatch that holds ``carry`` (a graph's static carry
    tensors), if one does: a replay is about to write them."""
    ref = _HELD.pop(carry[0].data_ptr(), None)
    held = None if ref is None else ref()
    if held is not None:
        held._spill()


def _coarse(problem, caps, k: int) -> tuple:
    """The single frame's coarse half: levels [0, k). Returns (state, ring,
    count, dropped, entering [k]); the parity is k % 2."""
    carry, entering = scan_levels(problem, caps, scan_start(problem, caps),
                                  0, k)
    state, ring, _, count, dropped = carry
    return state, ring, count, dropped, entering


def _refine(problem, caps, k: int, state, ring, count, dropped) -> tuple:
    """The single frame's refine half: levels [k, tau) and the leaf pass
    from the carry at level k. Returns (state, entering [tau - k],
    leaf_count, dropped)."""
    carry, entering = scan_levels(problem, caps,
                                  (state, ring, k % 2, count, dropped),
                                  k, len(caps) - 1)
    state, count, dropped = scan_leaf(problem, caps, carry)
    return state, entering, count, dropped


class RefineDispatch:
    """The in-flight refine half. ``finalize()`` reads the stats back and
    returns ``(state(s), ASKStats)``, stitched across both halves
    (``kernel_launches == 2``: the price of the early preview)."""

    def __init__(self, caps, state, stats, frames, t0):
        self._caps = tuple(caps)
        self._state = state
        # single: (StatsCopy of [levels + 2],); batch: pooled.pool_stats'
        self._stats = stats
        self._frames = frames  # None: single frame
        self._t0 = t0
        self._done = False

    @property
    def ready(self):
        """The CUDA event after which the refined canvas(es) are written
        (None on the CPU)."""
        return self._stats[0].event

    def finalize(self, *, block_until_ready: bool = True):
        """``(state, ASKStats)``; one-shot. Waits on the stats' own event,
        which comes after the canvas: ``block_until_ready`` has nothing to
        do."""
        if self._done:
            raise RuntimeError("RefineDispatch.finalize() is one-shot")
        self._done = True
        caps = self._caps
        if self._frames is None:
            host = self._stats[0].read().tolist()
            levels = len(caps) - 1
            counts = []
            for c in host[:levels]:
                if c == 0:
                    break
                counts.append(c)
            stats = ASKStats(
                levels=len(counts),
                kernel_launches=2,  # coarse + refine
                region_counts=tuple(counts),
                leaf_count=host[levels],
                overflow_dropped=host[levels + 1],
                wall_s=time.perf_counter() - self._t0,
                olt_caps=caps,
            )
            return self._state, stats
        entering_fl, leaf_f, dropped = pooled.read_pool(*self._stats)
        stats = pooled._pooled_stats(caps, entering_fl, leaf_f, dropped,
                                     time.perf_counter() - self._t0)
        return self._state, dataclasses.replace(stats, kernel_launches=2)


class CoarseDispatch:
    """The in-flight coarse half.

    ``preview()`` waits only for the preview canvas; ``refine()`` enqueues
    the second half on the carry left on the device, with no host sync --
    call it before ``preview()`` to overlap the refinement with whatever
    the preview is streamed to.
    """

    def __init__(self, problem, caps, checkpoint, preview, carry, entering,
                 planes, t0, graph_key):
        self._problem = problem
        self._caps = tuple(caps)
        self._checkpoint = checkpoint
        self._preview = preview
        self._carry = carry
        self._entering = entering
        self._planes = planes  # None: single frame
        self._t0 = t0
        self._graph_key = graph_key  # the refine graph's, on the card
        self._refined = False
        self._event = None
        if problem.device.type == "cuda":
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(problem.device))
        if graph_key is not None:
            _HELD[carry[0].data_ptr()] = weakref.ref(self)

    @property
    def checkpoint(self) -> int:
        return self._checkpoint

    @property
    def ready(self):
        """The CUDA event after which the preview is painted (None on the
        CPU): ``readback.to_host(d.preview(block_until_ready=False),
        d.ready)`` copies it without waiting for a refine enqueued since."""
        return self._event

    def preview(self, *, block_until_ready: bool = True) -> torch.Tensor:
        """The coarse canvas(es): every live region at the checkpoint level
        painted with its border's common value."""
        if block_until_ready and self._event is not None:
            self._event.synchronize()
        return self._preview

    def _spill(self) -> None:
        """Keep a copy of this dispatch's carry (no longer held in
        ``_HELD``): a replay is about to overwrite the graph's."""
        self._carry = tuple(x.clone() for x in self._carry)

    def refine(self) -> RefineDispatch:
        """Enqueue the exact-refinement half (one-shot, non-blocking)."""
        if self._refined:
            raise RuntimeError("CoarseDispatch.refine() is one-shot")
        self._refined = True
        p, caps, k = self._problem, self._caps, self._checkpoint
        carry, self._carry = self._carry, None
        if self._planes is not None:
            return self._refine_batch(carry)
        if self._graph_key is None:  # the CPU: eagerly
            state, entering, count, dropped = _refine(p, caps, k, *carry)
        else:
            _HELD.pop(carry[0].data_ptr(), None)  # consumed by this replay
            known = graphs.static(self._graph_key)
            if known is not None:
                _claim(known[0][:4])
            state, entering, count, dropped = graphs.replay(
                self._graph_key,
                lambda s, ring, c, d, w: _refine(p.reading(w), caps, k, s,
                                                 ring, c, d),
                *carry, p.window(), device=p.device, borrow=4)
            state = state.clone()  # out of the graph's static tensors
        counts = torch.cat([self._entering, entering, count.reshape(1),
                            dropped.reshape(1)])
        return RefineDispatch(caps, state, (readback.StatsCopy(counts),),
                              None, self._t0)

    def _refine_batch(self, carry) -> RefineDispatch:
        p, caps, k, planes = (self._problem, self._caps, self._checkpoint,
                              self._planes)
        carry, entering = pooled.pool_levels(p, caps, planes, carry, k,
                                             len(caps) - 1, per_frame=True)
        states, leaf_f, dropped = pooled.pool_leaf(p, caps, planes, carry,
                                                   per_frame=True)
        entering = torch.cat([self._entering, entering])
        return RefineDispatch(caps, states,
                              pooled.pool_stats(entering, leaf_f, dropped),
                              planes.shape[0], self._t0)


def dispatch_progressive(
    problem,
    *,
    checkpoint_level: Union[int, None] = None,
    capacities: Union[None, int, Sequence[int]] = None,
    p_subdiv: float = 0.7,
    safety_factor: float = 2.0,
) -> CoarseDispatch:
    """Enqueue the coarse half of one frame and paint its preview (no host
    sync). Capacities as in ``run_ask_scan``."""
    caps = _resolve_capacities(problem, capacities, p_subdiv, safety_factor)
    k = checkpoint_for(problem, checkpoint_level)
    t0 = time.perf_counter()
    refine_key = None
    if problem.device.type == "cuda":
        key = ("coarse", caps, k, problem.graph_key())
        known = graphs.static(key)
        if known is not None:
            _claim(known[1][:4])
        out = graphs.replay(
            key, lambda w: _coarse(problem.reading(w), caps, k),
            problem.window(), device=problem.device)
        *carry, entering = out
        entering = entering.clone()
        refine_key = ("refine", caps, k, problem.graph_key())
    else:
        *carry, entering = _coarse(problem, caps, k)
    state, ring, count, dropped = carry
    coords, valid = scan_live(ring, k % 2, count, caps[k])
    preview = problem.preview_step(state.clone(), coords, valid, level=k)
    return CoarseDispatch(problem, caps, k, preview, tuple(carry), entering,
                          None, t0, refine_key)


def dispatch_progressive_batch(
    problem,
    extras,
    *,
    checkpoint_level: Union[int, None] = None,
    capacities: Union[None, int, Sequence[int]] = None,
    p_subdiv: float = 0.7,
    safety_factor: float = 2.0,
) -> CoarseDispatch:
    """Enqueue the coarse half of a frame batch and paint its previews (no
    host sync). ``extras`` is the [F, 4] per-frame bounds of the batched
    scan (``run_ask_scan_batch``, whose loop the halves split: every frame
    a ring of ``caps[l]`` rows); the previews are painted by the pooled Q
    and T on the frame-tagged rows live at the checkpoint."""
    bounds = pooled.bounds_array(extras)
    F, n, dev = bounds.shape[0], problem.n, problem.device
    caps = _resolve_capacities(problem, capacities, p_subdiv, safety_factor)
    k = checkpoint_for(problem, checkpoint_level)
    t0 = time.perf_counter()
    planes = ops.pooled_planes(n, bounds, dev)
    live = torch.ones((F,), dtype=torch.bool, device=dev)
    carry = pooled.pool_start(problem, caps, live, per_frame=True)
    carry, entering = pooled.pool_levels(problem, caps, planes, carry, 0, k,
                                         per_frame=True)
    rows, valid = pooled.pool_live(caps, carry, k, F, per_frame=True)
    preview = problem.pooled_preview_step(carry[0].clone(), rows, valid,
                                          level=k, planes=planes)
    return CoarseDispatch(problem, caps, k, preview.reshape(F, n, n), carry,
                          entering, planes, t0, None)


def run_ask_scan_progressive(
    problem,
    *,
    checkpoint_level: Union[int, None] = None,
    capacities: Union[None, int, Sequence[int]] = None,
    p_subdiv: float = 0.7,
    safety_factor: float = 2.0,
    block_until_ready: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, ASKStats]:
    """Synchronous progressive render: ``(preview, state, stats)``.
    ``state`` equals ``run_ask_scan``'s at the same capacities, bit for
    bit; ``preview`` is the coarse canvas the split served early;
    ``stats.kernel_launches == 2``."""
    d = dispatch_progressive(problem, checkpoint_level=checkpoint_level,
                             capacities=capacities, p_subdiv=p_subdiv,
                             safety_factor=safety_factor)
    r = d.refine()  # enqueue the exact half behind the preview
    preview = d.preview(block_until_ready=block_until_ready)
    state, stats = r.finalize(block_until_ready=block_until_ready)
    return preview, state, stats
