"""The one traffic generator: zoom trajectories of several tenants,
interleaved, from a traffic mix's parameters and ``--seed``.

A mix (``bench/traffic/<mix>.json``) names:

* ``entry``: how the requests reach the program (``bench/entries/<entry>.py``);
* ``centers``: ``coarse_n``, ``dwell_low``: the boundary band of a coarse
  plain render (f64, NumPy) of the configuration's default window, the
  points whose dwell lies in [dwell_low, max_dwell). The tenants' centers
  are spread evenly over that band ordered by dwell, so each mix has one
  fixed set of centers;
* ``tenants``, ``depth_stride``: tenant k zooms into center k, starting
  ``k * depth_stride`` frames deep;
* ``frames``, ``zoom_per_frame``: a trajectory's length and its zoom a
  frame, from the default window's size; a trajectory that ends starts
  again from the top;
* ``warm_rounds``: rounds that set-up renders and the window does not.

Frames go out in rounds of one frame a tenant. The seed orders the
tenants inside each round, and nothing else: every seed gets the same
frames round by round, so runs with different seeds do the same work.
"""

from __future__ import annotations

import itertools
from typing import Iterator, Mapping, NamedTuple, Sequence, Tuple

import numpy as np

from bench.reference import escape


class Frame(NamedTuple):
    index: int  # position in the stream, warm rounds included
    tenant: int
    depth: int
    bounds: Tuple[float, float, float, float]


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for one use of ``seed``: any whole number, any size."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def coarse_dwell(n: int, bounds: Sequence[float], max_dwell: int, kind: str,
                 params: Mapping = None) -> np.ndarray:
    """[n, n] dwells at the pixel centres of ``bounds``, in f64, by the
    kind's own step (``bench.reference.escape.arithmetic``)."""
    arith = escape.arithmetic(kind)
    re0, im0, re1, im1 = (float(v) for v in bounds)
    xs = re0 + (np.arange(n) + 0.5) * (re1 - re0) / n
    ys = im0 + (np.arange(n) + 0.5) * (im1 - im0) / n
    z = xs[None, :] + 1j * ys[:, None]
    k = arith.coarse_addend(z, params or {})
    out = np.zeros(z.shape, np.int64)
    alive = np.ones(z.shape, bool)
    for _ in range(max_dwell):
        alive &= (z.real * z.real + z.imag * z.imag) < 4.0
        if not alive.any():
            break
        out += alive
        z = np.where(alive, arith.coarse_step(z, k), z)
    return out


def centers(config: dict, spec: dict) -> list:
    """The mix's fixed centers: ``tenants`` points spread evenly over the
    boundary band of the coarse render, ordered by (dwell, row, column)."""
    n = int(spec["centers"]["coarse_n"])
    low = int(spec["centers"]["dwell_low"])
    md = int(config["max_dwell"])
    b = config["bounds"]
    d = coarse_dwell(n, b, md, config["workload"], config)
    ys, xs = np.nonzero((d >= low) & (d < md))
    if len(ys) < spec["tenants"]:
        raise ValueError("the boundary band holds fewer points than tenants")
    order = np.lexsort((xs, ys, d[ys, xs]))
    pick = order[np.linspace(0, len(order) - 1, spec["tenants"]).round()
                 .astype(int)]
    re0, im0, re1, im1 = (float(v) for v in b)
    return [(re0 + (xs[i] + 0.5) * (re1 - re0) / n,
             im0 + (ys[i] + 0.5) * (im1 - im0) / n) for i in pick]


def window(config: dict, center, depth: int, zoom: float):
    """The bounds of a frame ``depth`` zoom steps into ``center``."""
    re0, im0, re1, im1 = (float(v) for v in config["bounds"])
    hw = (re1 - re0) / 2 / zoom ** depth
    hh = (im1 - im0) / 2 / zoom ** depth
    cx, cy = center
    return (cx - hw, cy - hh, cx + hw, cy + hh)


def frames(config: dict, spec: dict, seed: int) -> Iterator[Frame]:
    """The endless frame stream of one run."""
    pts = centers(config, spec)
    k, length = spec["tenants"], int(spec["frames"])
    stride, zoom = int(spec["depth_stride"]), float(spec["zoom_per_frame"])
    order = rng(seed)
    index = itertools.count()
    for round_ in itertools.count():
        for t in order.permutation(k):
            depth = (int(t) * stride + round_) % length
            yield Frame(next(index), int(t), depth,
                        window(config, pts[t], depth, zoom))


def warm_frames(spec: dict) -> int:
    """Frames of the stream's prefix that set-up renders."""
    return int(spec["warm_rounds"]) * int(spec["tenants"])
