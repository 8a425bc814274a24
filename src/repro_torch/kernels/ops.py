"""Public entry points of the port's kernels.

Counterpart of ``repro/kernels/ops.py`` with the same keyword arguments
minus the routing knobs (``backend``, ``policy``) and the Pallas tile of
``mandelbrot``: routing and the tuned tier come with ROADMAP queue 1 slice
11. Here the device decides. A CPU tensor (or ``device="cpu"``) takes the
plain version; a CUDA tensor launches the hand-written kernel or raises.
Nothing falls back. Each entry point is the kernel module's wrapper
itself, so its ``launches`` counter is shared.

``region_fill`` and ``region_dwell`` update the canvas in place and return
it (the JAX versions are functional, through ``input_output_aliases``).
Their third argument, and ``perimeter_query``'s second, is ``count``, the
live row count as an int32 [1] tensor on the device, where JAX takes a
duplicate-padded OLT (and, for the fill and the dwell, a ``nonempty``
flag); no kernel does work for a row past it.

The pooled engine's entry points take frame-tagged rows (frame, cy, cx),
the banded [F*n, n] canvas and, where a point is computed, ``planes``
[F, 4] from ``pooled_planes`` in place of JAX's ``bounds_all`` and
``pooled_bounds``: ``perimeter_query_pooled`` (JAX computes it with jnp),
``region_fill_pooled``, ``region_dwell_pooled``, and ``compact_ranks``,
the OLT scan, which returns the count as a 0-d tensor on the device.

``batched_ranks`` is the MoE's ``position_in_expert``: per-column OLT ranks
of [N, E] flags (JAX's contract) or of [G, N, E] flags, one launch for
every token group; unlike JAX's, it takes any N (no cumsum fallback).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import moe_dispatch, olt_compact
from repro_torch.kernels.mandelbrot_dwell import mandelbrot_dwell as mandelbrot
from repro_torch.kernels.perimeter_query import (perimeter_query,
                                                 perimeter_query_pooled)
from repro_torch.kernels.ref import pooled_planes as _pooled_planes
from repro_torch.kernels.region_dwell import region_dwell
from repro_torch.kernels.region_dwell_pooled import region_dwell_pooled
from repro_torch.kernels.region_fill import region_fill
from repro_torch.kernels.region_fill_pooled import region_fill_pooled

__all__ = ["mandelbrot", "perimeter_query", "region_fill", "region_dwell",
           "pooled_planes", "perimeter_query_pooled", "region_fill_pooled",
           "region_dwell_pooled", "compact_ranks", "batched_ranks"]


def pooled_planes(n: int, bounds_all, device) -> torch.Tensor:
    """The [F, 4] f32 per-frame planes of ``ref.pooled_planes`` as one
    tensor on ``device`` (one upload per batch; to the card from pinned
    memory, with no host sync)."""
    planes = torch.from_numpy(_pooled_planes(n, bounds_all))
    if torch.device(device).type == "cuda":
        return planes.pin_memory().to(device, non_blocking=True)
    return planes.to(device)


def compact_ranks(flags: torch.Tensor):
    """Exclusive-scan OLT compaction (the atomicAdd replacement) through the
    scan kernel. Returns (ranks [N] int32, count int32 0-d), on the device."""
    ranks, count = olt_compact.compact_ranks(flags)
    return ranks, count.reshape(())


def batched_ranks(flags: torch.Tensor):
    """Per-column OLT ranks through the batched-ranks kernel. ``flags``
    [N, E] returns (ranks [N, E], counts [E]); [G, N, E] returns (ranks
    [G, N, E], counts [G, E]); int32, on the device."""
    if flags.ndim == 2:
        ranks, counts = moe_dispatch.batched_ranks(flags[None].contiguous())
        return ranks[0], counts[0]
    return moe_dispatch.batched_ranks(flags)
