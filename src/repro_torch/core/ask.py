"""Adaptive Serial Kernels (ASK) -- paper Sec. 5, the paper-faithful mode.

Counterpart of ``repro/core/ask.py`` (``ASKProblem``, ``ASKStats``,
``run_ask``). ASK replaces Dynamic Parallelism's recursive kernel tree
with a serial sequence of flat launches, one per subdivision level; the
live regions travel between levels in a compact OLT (``core/olt.py``).
The live count is padded to the next power of two, as in the JAX package,
so the per-level OLT sizes (``olt_caps``) are the same.

After each level the host reads the child count with ``.item()``: that
sync is the serial-kernel boundary of the paper, where the next level's
grid size is learnt. The one-dispatch engines (``run_ask_fused``,
``run_ask_scan``) come with ROADMAP queue 1 slice 6.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Protocol, Tuple

import torch

from repro_torch.core import olt as olt_lib
from repro_torch.core.cost_model import num_levels

__all__ = ["ASKProblem", "ASKStats", "run_ask"]


class ASKProblem(Protocol):
    """Adapter for an SSD workload driven by subdivision.

    Regions at level ``l`` live on a ``(g * r**l)``-per-side grid and are
    identified by int32 coords (cy, cx) -- see ``core/olt.py``.
    """

    n: int
    g: int
    r: int
    B: int
    device: torch.device

    def init_state(self) -> Any:
        """Initial output state (e.g. the n x n canvas)."""

    def root_coords(self) -> torch.Tensor:
        """[g*g, 2] level-0 region coordinates."""

    def level_step(self, state: Any, coords: torch.Tensor,
                   valid: torch.Tensor, *, level: int) -> Tuple[Any, torch.Tensor]:
        """Query Q on each valid region, terminal work T on the homogeneous
        ones; returns (new_state, subdivide_flags[bool])."""

    def leaf_step(self, state: Any, coords: torch.Tensor, valid: torch.Tensor,
                  *, level: int) -> Any:
        """Last-level application work A on each remaining region."""

    def region_side(self, level: int) -> int:
        """Pixel side of a level-``level`` region: n // (g * r**level)."""


@dataclasses.dataclass
class ASKStats:
    """Per-run accounting (feeds the cost-model validation benchmarks)."""

    levels: int = 0
    kernel_launches: int = 0  # host dispatches (ASK: one per level)
    region_counts: tuple = ()  # live regions entering each level
    leaf_count: int = 0
    wall_s: float = 0.0
    overflow_dropped: int = 0  # pooled engine: regions beyond capacity
    olt_caps: tuple = ()  # OLT rows allocated per level (incl. leaf level)
    # batched engines only: per-frame breakdowns of the two sums above, in
    # input frame order (region_counts then holds one tuple per frame)
    frame_overflow: tuple = ()
    frame_leaf_counts: tuple = ()

    @property
    def ring_rows(self) -> int:
        """Live OLT rows in the scan engines' double-buffered ring: two
        buffers of the widest level slice (the whole batch's, pooled)."""
        return 2 * max(self.olt_caps) if self.olt_caps else 0

    def frame_chains(self) -> tuple:
        """Per-frame ``(region_counts, leaf_count)`` observation chains (the
        raw material of the measured-occupancy feedback loop): one per
        frame of a batch, in input order, or one for a single frame."""
        if self.frame_leaf_counts:
            return tuple(zip(self.region_counts, self.frame_leaf_counts))
        return ((self.region_counts, self.leaf_count),)


def synchronize(device: torch.device) -> None:
    """Wait for the card (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_ask(problem: ASKProblem) -> Tuple[Any, ASKStats]:
    """Paper-faithful ASK: serial launches, power-of-two OLT buckets.
    Returns (canvas, ASKStats); the canvas is the problem's ``init_state``
    updated in place, and ``wall_s`` ends after the device finished."""
    n, g, r, B = problem.n, problem.g, problem.r, problem.B
    t0 = time.perf_counter()
    state = problem.init_state()
    coords = problem.root_coords()
    count = g * g
    stats = ASKStats()
    counts = []
    caps_used = []

    for level in range(num_levels(n, g, r, B)):
        if count == 0:
            break
        cap = olt_lib.next_pow2(count)
        coords_p, valid = olt_lib.pad_olt(coords, count, cap)
        counts.append(count)
        caps_used.append(cap)
        state, flags = problem.level_step(state, coords_p, valid, level=level)
        stats.kernel_launches += 1
        # write-OLT: every flagged region inserts r*r children (Sec. 5.3.2)
        coords, child_count = olt_lib.subdivide_olt(
            coords_p, flags & valid, r=r,
            capacity=olt_lib.next_pow2(cap * r * r))
        count = int(child_count.item())  # host sync: the level boundary
        stats.levels += 1

    if count > 0:
        cap = olt_lib.next_pow2(count)
        coords_p, valid = olt_lib.pad_olt(coords, count, cap)
        state = problem.leaf_step(state, coords_p, valid, level=stats.levels)
        stats.kernel_launches += 1
        stats.leaf_count = count
        caps_used.append(cap)

    synchronize(problem.device)
    stats.region_counts = tuple(counts)
    stats.olt_caps = tuple(caps_used)
    stats.wall_s = time.perf_counter() - t0
    return state, stats


def _per_frame_counts(entering) -> tuple:
    """[F, levels] entering-count matrix -> per-frame ``region_counts``
    tuples, each cut at its first zero level as in the single-frame
    engine."""
    per_frame = []
    for row in entering:
        counts = []
        for c in row.tolist():
            if c == 0:
                break
            counts.append(int(c))
        per_frame.append(tuple(counts))
    return tuple(per_frame)
