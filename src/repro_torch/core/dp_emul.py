"""Dynamic-Parallelism-style recursive baseline (paper Sec. 3).

Counterpart of ``repro/core/dp_emul.py``. What the cost model needs from
"DP" is its cost structure: one dispatch per node of the subdivision
tree, the recursion driven from outside the kernels, and a per-launch
overhead. This module reproduces exactly that with a host-driven
depth-first recursion: every node runs ``level_step`` on a one-row OLT
(query and terminal work), reads its subdivide flag back to the host and
recurses into its children; the leaves run ``leaf_step``. The same
``ASKProblem`` adapter is reused, so DP and ASK drive the same kernels.
"""

from __future__ import annotations

import time
from typing import Any, Tuple

import torch

from repro_torch.core.ask import ASKProblem, ASKStats, synchronize
from repro_torch.core.cost_model import num_levels

__all__ = ["run_dp"]


def run_dp(problem: ASKProblem) -> Tuple[Any, ASKStats]:
    """Recursive subdivision with one dispatch per tree node. Returns
    (canvas, ASKStats); ``wall_s`` ends after the device finished."""
    g, r = problem.g, problem.r
    levels = num_levels(problem.n, g, r, problem.B)
    stats = ASKStats(levels=levels)
    one_valid = torch.ones((1,), dtype=torch.bool, device=problem.device)

    t0 = time.perf_counter()
    state = problem.init_state()
    counts = [0] * levels  # live regions entering each level (== run_ask's)

    def recurse(state, cy: int, cx: int, level: int):
        coords = torch.tensor([[cy, cx]], dtype=torch.int32,
                              device=problem.device)
        if level == levels:
            stats.kernel_launches += 1
            stats.leaf_count += 1
            return problem.leaf_step(state, coords, one_valid, level=level)
        counts[level] += 1
        stats.kernel_launches += 1
        state, flags = problem.level_step(state, coords, one_valid, level=level)
        if bool(flags[0]):  # device->host sync per node, as a DP parent
            for dy in range(r):  # observing its children
                for dx in range(r):
                    state = recurse(state, cy * r + dy, cx * r + dx, level + 1)
        return state

    for cy in range(g):
        for cx in range(g):
            state = recurse(state, cy, cx, 0)
    stats.region_counts = tuple(c for c in counts if c > 0)
    # one 1-row OLT per dispatched node => per-level rows == node counts
    stats.olt_caps = stats.region_counts + (
        (stats.leaf_count,) if stats.leaf_count else ())

    synchronize(problem.device)
    stats.wall_s = time.perf_counter() - t0
    return state, stats
