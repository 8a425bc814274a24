"""The work that a frame's subdivision needs, read off its dwell canvas.

What a kernel must compute is the same whatever implements it, so the
rooflines count it from the frame itself: the subdivision is replayed on
the finished canvas at the configuration's g, r and B. Every pixel that
any border query or leaf computed holds its own exact dwell in the final
canvas (a border pixel of a region ends on the border of the filled
region or in the leaf that holds it), so the replay needs no escape
iteration. A region whose border is homogeneous was filled; the others
split; the regions live at side <= B are the leaves that A computes.

The arithmetic is a frozen copy of the renderer's own bound arithmetic
(``escape_flops``, ``border_work`` and the bytes of ``bound_of``),
vectorised over the canvas; a step's flops are each kind's
``STEP_FLOPS`` (``bench/reference/kinds/<kind>.py``).
"""

from __future__ import annotations

import torch

from bench.reference import escape
from bench.yardstick import peaks

# f32 flops of the final escape test, and of the map to the plane's two
# FMAs; a step's are the kind's own (``STEP_FLOPS`` of its file)
TEST_FLOPS, MAP_FLOPS = 3, 4


def step_flops(workload: str) -> int:
    """f32 flops of one escape step of ``workload`` (an FMA counts 2)."""
    return escape.arithmetic(workload).STEP_FLOPS


def escape_flops(dwell_sum, pixels, escaped, workload: str):
    """f32 flops of the escape loop over ``pixels`` points whose dwells
    sum to ``dwell_sum``, ``escaped`` of them below ``max_dwell``."""
    return MAP_FLOPS * pixels + step_flops(workload) * dwell_sum \
        + TEST_FLOPS * escaped


def border_work(d: torch.Tensor) -> tuple:
    """(homogeneous [N] bool, exact-work steps [N] f64) of [N, P] border
    dwells, the first column the top-left point's. A homogeneous border
    needs every dwell; any other needs f, the top-left dwell, plus its
    cheapest witness of a mismatch, min over the points q with d_q != f of
    min(d_q, f) + 1."""
    d = d.long()
    f = d[:, :1]
    differ = d != f
    homog = ~differ.any(1)
    witness = torch.where(differ, torch.minimum(d, f) + 1,
                          torch.full_like(d, 1 << 40)).amin(1)
    steps = torch.where(homog, d.sum(1), f[:, 0] + witness)
    return homog, steps.double()


def _borders(canvas: torch.Tensor, side: int) -> torch.Tensor:
    """[R, R, 4 * side] border dwells of every side x side region, in the
    order top, bottom, left, right (the first the top-left point)."""
    n = canvas.shape[0]
    R = n // side
    top = canvas[0::side].reshape(R, R, side)
    bottom = canvas[side - 1::side].reshape(R, R, side)
    left = canvas[:, 0::side].reshape(R, side, R).permute(0, 2, 1)
    right = canvas[:, side - 1::side].reshape(R, side, R).permute(0, 2, 1)
    return torch.cat([top, bottom, left, right], dim=2)


def frame_work(canvas: torch.Tensor, *, g: int, r: int, B: int,
               max_dwell: int, workload: str) -> dict:
    """The kernels' work for one finished [n, n] canvas, as 0-d f64
    tensors on its device (no host sync, so frames add up on the card):

    * ``query_flops``, ``query_bytes``: Q's exact work over every level's
      live regions (escape steps times ``STEP_FLOPS``) and the bytes a
      query moves (coordinates in, flag and value out);
    * ``leaf_flops``, ``leaf_bytes``: A's escape flops over every leaf
      pixel and the canvas bytes it writes;
    * ``leaves``, ``live`` (regions queried, over all levels).
    """
    n = canvas.shape[0]
    side = n // g
    live = torch.ones((g, g), dtype=torch.bool, device=canvas.device)
    zero = torch.zeros((), dtype=torch.float64, device=canvas.device)
    q_steps, queried, q_bytes = zero, zero, zero
    while side > B:
        homog, steps = border_work(
            _borders(canvas, side).reshape(-1, 4 * side))
        flat = live.reshape(-1)
        k = flat.sum().double()
        queried = queried + k
        q_bytes = q_bytes + k * (8 + 5) + 4
        q_steps = q_steps + (steps * flat).sum()
        live = (live & ~homog.view_as(live)).repeat_interleave(r, 0) \
            .repeat_interleave(r, 1)
        side //= r
    R = n // side
    blocks = canvas.view(R, side, R, side)
    dsum = blocks.sum((1, 3), dtype=torch.int64)
    esc = (blocks < max_dwell).sum((1, 3), dtype=torch.int64)
    leaves = live.sum().double()
    pixels = leaves * side * side
    leaf_flops = escape_flops((dsum * live).sum().double(), pixels,
                              (esc * live).sum().double(), workload)
    return dict(query_flops=step_flops(workload) * q_steps,
                query_bytes=q_bytes, leaf_flops=leaf_flops,
                leaf_bytes=pixels * 4 + leaves * 12, leaves=leaves,
                live=queried)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card needs for this work: the larger of the
    flops over the f32 peak and the bytes over HBM bandwidth."""
    return max(flops / peaks.PEAK_FP32_FLOPS, nbytes / peaks.PEAK_HBM_BYTES)


def roofline_pct(seconds: float, flops: float, nbytes: float):
    """The share of its roofline that work done in ``seconds`` of device
    time reaches, or None when no time was traced."""
    return 100.0 * least_seconds(flops, nbytes) / seconds if seconds > 0 \
        else None
