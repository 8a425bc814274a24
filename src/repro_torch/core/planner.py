"""Occupancy-aware frame capacity planner for the batched ASK engines.

Counterpart of ``repro/core/planner.py``, its mesh arms included (with a
``launch.mesh.FramesMesh`` each dispatch is the sharded batch). The scan
engines size their OLT ring from ONE global (``p_subdiv``,
``safety_factor``) pair, so a batch mixing deep-zoom frames (dense) with
wide frames (sparse) either overflows the ring or wastes ring memory on
the sparse majority. The planner sizes per frame
instead:

  1. estimate each frame's effective subdivision probability from its
     zoom depth (``effective_p_subdiv``: deep zooms => higher P, the
     paper's Sec. 4.2.1 assumption-ii parameter evaluated per frame);
  2. evaluate the cost model's expected occupancy E_l = g^2 (r^2 P)^l at
     that per-frame P (``cost_model.expected_level_counts``) and bucket
     frames into at most K capacity classes (``plan_capacities``);
  3. dispatch one batched scan per bucket with bucket-local ring
     capacities (``solve_planned``, through ``ask.run_ask_scan_batch``);
  4. when a frame still overflows its bucket, re-plan it into the next
     bucket (or escalate toward the worst case, which cannot overflow);
     the retry path keys on ``ASKStats.frame_overflow``, read back once a
     dispatch.

``plan_pooled`` / ``solve_pooled`` do the same for the pooled engine
(``core.pooled``): one shared ring sized from the summed per-frame
occupancies. ``plan_frames(..., observed=)`` blends MEASURED occupancy from
a ``core.feedback.OccupancyEstimator`` into the per-frame P. The planned
paths return their canvases as one [F, n, n] tensor on the problem's
device (JAX returns host numpy): the frames that converged in each
dispatch are copied into it by frame index.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.ask import (run_ask_scan_batch, run_ask_scan_sharded,
                                  scan_capacities)
from repro_torch.core.cost_model import expected_level_counts, num_levels
from repro_torch.core import pooled as pooled_lib
from repro_torch.core.pooled import bounds_array

__all__ = [
    "ROW_BYTES",
    "P_DEEP_DEFAULT",
    "SLOPE_DEFAULT",
    "P_MIN_DEFAULT",
    "prior_band_for",
    "workload_name",
    "FrameEstimate",
    "FramePlan",
    "BucketPlan",
    "CapacityPlan",
    "PlanReport",
    "zoom_depth",
    "effective_p_subdiv",
    "estimate_frames",
    "plan_from_p",
    "plan_capacities",
    "plan_frames",
    "plan_pooled",
    "worst_case_capacities",
    "escalate_capacities",
    "solve_planned",
    "solve_pooled",
]

# int32 (cy, cx) coordinates: bytes per OLT row (public: the benchmarks
# convert ring rows to bytes with THIS constant, never a literal)
ROW_BYTES = 8

# the calibrated MANDELBROT zoom-depth prior band (fit notes:
# effective_p_subdiv). Problems built on a ``WorkloadSpec`` carry
# their own band (``WorkloadSpec.prior_band``, resolved by
# ``prior_band_for``); this triple is the fallback for spec-less problems
# and the ``core.feedback.OccupancyEstimator`` default namespace, so
# re-fitting the seed prior stays a one-place change.
P_DEEP_DEFAULT = 0.97
SLOPE_DEFAULT = 0.18
P_MIN_DEFAULT = 0.3


def prior_band_for(problem) -> Tuple[float, float, float]:
    """(p_deep, slope, p_min) for one problem: the workload's own prior
    band when the problem carries a ``WorkloadSpec`` (the workload-
    parametric stack always does), else the calibrated Mandelbrot
    defaults. THE band-resolution rule every planning entry point
    shares, so two layers can never plan the same frame from different
    priors."""
    band = getattr(getattr(problem, "workload", None), "prior_band", None)
    if band is None:
        return (P_DEEP_DEFAULT, SLOPE_DEFAULT, P_MIN_DEFAULT)
    return tuple(float(b) for b in band)


# ---------------------------------------------------------------------------
# per-frame occupancy estimation
# ---------------------------------------------------------------------------

def zoom_depth(width: float, *, ref_width: float, r: int) -> float:
    """Zoom depth of a frame window in subdivision levels.

    ``log_r(ref_width / width)``: how many r-fold shrinks separate this
    frame from the reference window. NEGATIVE for frames wider than the
    reference (zoomed out). Measured in the same base r as the
    subdivision tree, so depth composes with the paper's tau =
    log_r(n / (g B)) level count (``cost_model.tau_levels``).
    """
    if width <= 0 or ref_width <= 0:
        raise ValueError(f"widths must be positive, got {width} / {ref_width}")
    return math.log(ref_width / width) / math.log(r)


def effective_p_subdiv(depth: float, *, p_deep: float = P_DEEP_DEFAULT,
                       slope: float = SLOPE_DEFAULT,
                       p_min: float = P_MIN_DEFAULT) -> float:
    """Effective per-level subdivision probability at a given zoom depth.

    A self-similar boundary fills a constant *fraction* of the window at
    every scale at or inside the reference view, so frames at depth >= 0
    (reference width or any deep zoom onto the boundary) share a
    saturated P = ``p_deep`` -- near-boundary windows run hot, the regime
    the paper's constant-P assumption (Sec. 4.2.1 assumption ii)
    describes. Zoomed OUT (depth < 0) the set occupies a shrinking
    fraction of the window: whole regions go homogeneous at the first
    query and resolve early, and the effective P falls off close to
    linearly per zoom-out level:

        P(depth) = max(p_min, p_deep - slope * max(0, -depth))

    The default slope 0.18/level is a fit of the measured per-frame
    constant-P equivalent ((leaf_count / worst_leaf)^(1/tau)) on seahorse-
    valley windows from 8x zoomed out to 4096x zoomed in (n=512 smoke
    config); it tracks the measurement within ~0.03 across that range.
    It is still an *estimate* that only has to bucket frames sensibly --
    the overflow-retry path of ``solve_planned`` guarantees correctness
    whatever the estimate misses.
    """
    if slope < 0:
        raise ValueError(f"slope must be >= 0, got {slope}")
    return max(p_min, p_deep - slope * max(0.0, -depth))


@dataclasses.dataclass(frozen=True)
class FrameEstimate:
    """Planner view of one frame: zoom geometry -> expected occupancy."""

    index: int  # position in the input batch
    width: float  # complex-plane window width
    depth: float  # zoom_depth(width)
    p_subdiv: float  # the P the plan uses for this frame
    expected: Tuple[float, ...]  # E_l = g^2 (r^2 P)^l per level 0..tau


@dataclasses.dataclass(frozen=True)
class FramePlan:
    """Provenance of one frame's planning P: prior vs measured.

    ``p_subdiv`` is what the plan actually used (what sized the frame's
    bucket); ``p_prior`` is the zoom-depth prior at this frame's depth;
    ``p_measured`` is the feedback estimator's (EWMA-smoothed, clamped)
    measurement when one was near enough, else None. The pair feeds the
    ``PlanReport.frame_p_*`` fields so tests and benchmarks can assert
    on which signal drove each frame instead of reverse-engineering
    ring sizes.
    """

    index: int
    width: float
    depth: float
    p_prior: float
    p_measured: Union[float, None]  # None: cold start / out of range
    p_subdiv: float  # the P the plan used (p_measured or p_prior, maybe quantized)
    # multi-tenant serving (launch.frontdoor): the tenant namespace the
    # estimator was consulted under, None for single-tenant plans
    tenant: Union[str, None] = None

    @property
    def source(self) -> str:
        return "prior" if self.p_measured is None else "measured"


def estimate_frames(problem, widths: Sequence[float], *,
                    ref_width: Union[float, None] = None,
                    p_deep: Union[float, None] = None,
                    slope: Union[float, None] = None,
                    p_min: Union[float, None] = None,
                    ) -> Tuple[FrameEstimate, ...]:
    """Per-frame occupancy estimates for a batch of window widths.

    ``ref_width`` anchors depth 0 (where P saturates at ``p_deep``); it
    defaults to the problem's own bounds width -- the "boundary fills the
    frame" view -- or, failing that, the narrowest frame in the batch.
    The band knobs default to the problem's workload prior
    (``prior_band_for``), so a julia batch falls off along julia's own
    fit; explicit values override per knob.
    """
    n, g, r, B = problem.n, problem.g, problem.r, problem.B
    band_deep, band_slope, band_min = prior_band_for(problem)
    p_deep = band_deep if p_deep is None else p_deep
    slope = band_slope if slope is None else slope
    p_min = band_min if p_min is None else p_min
    ref_width = _resolve_ref_width(problem, widths, ref_width)
    out = []
    for i, w in enumerate(widths):
        d = zoom_depth(float(w), ref_width=ref_width, r=r)
        p = effective_p_subdiv(d, p_deep=p_deep, slope=slope, p_min=p_min)
        exp = tuple(expected_level_counts(n, g, r, B, P=p))
        out.append(FrameEstimate(index=i, width=float(w), depth=d,
                                 p_subdiv=p, expected=exp))
    return tuple(out)


# ---------------------------------------------------------------------------
# bucketing
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """One capacity class: the frames it serves and their shared ring.

    ``pooled=True`` marks a cross-frame pooled bucket (``core.pooled``):
    ``capacities`` is then ONE shared ring for all member frames (sized
    from their summed occupancies) rather than a per-frame sizing, so
    the bucket's ring cost is 2 x max(caps) TOTAL instead of per frame.
    """

    frames: Tuple[int, ...]  # input-batch indices, original order
    p_subdiv: float  # planning P (max over member frames)
    capacities: Tuple[int, ...]  # per-level ring-slice capacities
    pooled: bool = False

    @property
    def ring_rows_per_frame(self) -> int:
        """Rows resident per frame: the double-buffered ring is two
        buffers of the widest level slice (see ``olt.ring_init``)."""
        return 2 * max(self.capacities)

    @property
    def ring_rows(self) -> int:
        if self.pooled:
            return self.ring_rows_per_frame  # ONE shared ring, all frames
        return len(self.frames) * self.ring_rows_per_frame

    @property
    def ring_bytes(self) -> int:
        return self.ring_rows * ROW_BYTES


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """Buckets ascending by capacity, plus the estimates they came from.

    ``frame_plans`` (populated by ``plan_frames``) records per frame
    whether the planning P came from the zoom-depth prior or from a
    measured-occupancy estimator; plans built by the lower-level
    ``plan_from_p`` / hand-made plans leave it empty. ``workload`` names
    the workload the plan was built for ("" for spec-less problems) and
    ``workload_band`` carries its (p_deep, slope, p_min) prior --
    ``feedback.OccupancyEstimator.observe_report`` uses the pair to file
    the measurements in the right per-workload namespace with the right
    clamping band, even for parametric workload instances whose names
    are not in the registry (e.g. ``multibrot(m=4)``).
    """

    buckets: Tuple[BucketPlan, ...]
    estimates: Tuple[FrameEstimate, ...]
    safety_factor: float
    frame_plans: Tuple[FramePlan, ...] = ()
    workload: str = ""
    workload_band: Union[Tuple[float, float, float], None] = None
    pooled: bool = False  # True: one cross-frame bucket (plan_pooled)

    @property
    def frames(self) -> int:
        return sum(len(b.frames) for b in self.buckets)

    @property
    def ring_rows(self) -> int:
        """Total OLT-ring rows across all bucket dispatches (the memory
        the heterogeneous-batch benchmark compares against one uniform
        ring of F x 2 x max(caps_uniform) rows)."""
        return sum(b.ring_rows for b in self.buckets)

    @property
    def ring_bytes(self) -> int:
        return self.ring_rows * ROW_BYTES

    def bucket_of(self, frame: int) -> int:
        for pos, b in enumerate(self.buckets):
            if frame in b.frames:
                return pos
        raise KeyError(f"frame {frame} not in plan")


def worst_case_capacities(problem) -> Tuple[int, ...]:
    """The exhaustive per-level grids (g r^l)^2 -- the sizing that cannot
    overflow, and the ceiling the retry escalation converges to."""
    g, r = problem.g, problem.r
    levels = num_levels(problem.n, g, r, problem.B)
    return tuple((g * r ** lv) ** 2 for lv in range(levels + 1))


def escalate_capacities(caps, worst, frames) -> Tuple[int, ...]:
    """THE overflow-escalation step, shared by every retry loop
    (``solve_planned``, the render service's in-chunk retry): double
    each level's capacity, clamped at the worst case. ``frames`` only
    labels the defensive error -- the worst case cannot drop, so hitting
    it with frames still overflowing is a bug, not a sizing problem."""
    if tuple(caps) == tuple(worst):
        raise RuntimeError(
            f"frames {sorted(frames)} overflow at worst-case capacities")
    return tuple(min(2 * c, w) for c, w in zip(caps, worst))


def workload_name(problem) -> str:
    """Registry name of the problem's workload ("" when spec-less)."""
    return getattr(getattr(problem, "workload", None), "name", "")


def plan_from_p(problem, frame_ps: Sequence[float], *,
                num_buckets: int = 4,
                safety_factor: float = 1.25,
                estimates: Tuple[FrameEstimate, ...] = (),
                frame_plans: Tuple[FramePlan, ...] = (),
                ) -> CapacityPlan:
    """Bucket frames by per-frame subdivision probability.

    A bucket's capacities come from ``scan_capacities`` evaluated at its
    hottest member's P, so its ring cost is ``|bucket| x 2 x
    max(caps(max P))`` rows. Frames are sorted by P and partitioned into
    at most ``num_buckets`` contiguous classes by a dynamic program that
    MINIMISES total ring rows -- one cold frame grouped with a hot one
    pays the hot ring, which is exactly the uniform-sizing waste the
    planner exists to remove, so the split points land at the occupancy
    gaps rather than at fixed quantiles. Buckets whose capacities
    coincide are merged: identical-occupancy batches collapse to ONE
    bucket no matter how large ``num_buckets`` is, and ``num_buckets >
    F`` simply degenerates to one bucket per distinct capacity vector.
    """
    if num_buckets < 1:
        raise ValueError(f"num_buckets must be >= 1, got {num_buckets}")
    if not frame_ps:
        raise ValueError("cannot plan an empty frame batch")
    n, g, r, B = problem.n, problem.g, problem.r, problem.B
    order = sorted(range(len(frame_ps)), key=lambda i: float(frame_ps[i]))
    M = len(order)
    K = min(num_buckets, M)
    caps_sorted = [scan_capacities(n, g, r, B,
                                   p_subdiv=float(frame_ps[i]),
                                   safety_factor=safety_factor)
                   for i in order]
    ring_w = [2 * max(c) for c in caps_sorted]  # rows/frame if bucket ends at j

    # DP over the sorted order: best[k][j] = min ring rows covering frames
    # 0..j (sorted) with k+1 buckets; interval i..j costs (j-i+1)*ring_w[j]
    # because the bucket inherits its hottest member's capacities.
    inf = float("inf")
    best = [[inf] * M for _ in range(K)]
    back = [[0] * M for _ in range(K)]
    for j in range(M):
        best[0][j] = (j + 1) * ring_w[j]
    for k in range(1, K):
        for j in range(M):
            best[k][j] = best[k - 1][j]  # unused extra bucket
            back[k][j] = -1  # sentinel: defer to k-1 levels
            for i in range(j):
                c = best[k - 1][i] + (j - i) * ring_w[j]
                if c < best[k][j]:
                    best[k][j] = c
                    back[k][j] = i

    # backtrack the K-bucket solution (ties resolve to fewer buckets)
    groups = []
    k, j = K - 1, M - 1
    while j >= 0:
        while k > 0 and back[k][j] == -1:
            k -= 1
        i = back[k][j] if k > 0 else -1
        groups.append(order[i + 1:j + 1])
        k, j = k - 1, i
    groups.reverse()

    buckets = []
    for idx in groups:
        p = max(float(frame_ps[i]) for i in idx)
        caps = scan_capacities(n, g, r, B, p_subdiv=p,
                               safety_factor=safety_factor)
        if buckets and buckets[-1].capacities == caps:
            merged = tuple(sorted(buckets[-1].frames + tuple(idx)))
            buckets[-1] = BucketPlan(frames=merged,
                                     p_subdiv=max(buckets[-1].p_subdiv, p),
                                     capacities=caps)
        else:
            buckets.append(BucketPlan(frames=tuple(sorted(int(i) for i in idx)),
                                      p_subdiv=p, capacities=caps))
    name = workload_name(problem)
    return CapacityPlan(buckets=tuple(buckets), estimates=tuple(estimates),
                        safety_factor=safety_factor,
                        frame_plans=tuple(frame_plans),
                        workload=name,
                        workload_band=prior_band_for(problem) if name else None)


def plan_capacities(problem, bounds_batch, *,
                    num_buckets: int = 4,
                    safety_factor: float = 1.25,
                    p_deep: Union[float, None] = None,
                    slope: Union[float, None] = None,
                    p_min: Union[float, None] = None,
                    ref_width: Union[float, None] = None,
                    ) -> CapacityPlan:
    """Plan a heterogeneous zoom batch from its [F, 4] bounds.

    Frame width re1 - re0 feeds ``zoom_depth`` -> ``effective_p_subdiv``
    -> ``expected_level_counts``; see ``plan_from_p`` for the bucketing.
    The prior band defaults to the problem's workload (``prior_band_
    for``). Problems whose extras are not plane bounds can call
    ``estimate_frames``/``plan_from_p`` with their own width or P notion.
    """
    arr = np.asarray(bounds_batch, np.float64)
    if arr.ndim != 2 or arr.shape[1] != 4:
        raise ValueError(f"bounds_batch must be [F, 4], got {arr.shape}")
    widths = (arr[:, 2] - arr[:, 0]).tolist()
    ests = estimate_frames(problem, widths, ref_width=ref_width,
                           p_deep=p_deep, slope=slope, p_min=p_min)
    return plan_from_p(problem, [e.p_subdiv for e in ests],
                       num_buckets=num_buckets, safety_factor=safety_factor,
                       estimates=ests)


def _resolve_ref_width(problem, widths, ref_width) -> float:
    """THE depth-0 anchor rule, shared by every planning entry point:
    explicit ``ref_width`` > the problem's own bounds width (the
    "boundary fills the frame" view) > the narrowest frame in the
    batch. One definition, so prior-only and observed plans can never
    assign different zoom depths to the same bounds."""
    if ref_width is not None:
        return float(ref_width)
    bounds = getattr(problem, "bounds", None)
    if bounds is not None:
        return float(bounds[2]) - float(bounds[0])
    return min(float(w) for w in widths)


def _frame_widths(problem, bounds_batch, ref_width):
    arr = np.asarray(bounds_batch, np.float64)
    if arr.ndim != 2 or arr.shape[1] != 4:
        raise ValueError(f"bounds_batch must be [F, 4], got {arr.shape}")
    widths = (arr[:, 2] - arr[:, 0]).tolist()
    return widths, _resolve_ref_width(problem, widths, ref_width)


def observed_frame_ps(problem, bounds_batch, observed, *,
                      quantize: bool = False,
                      ref_width: Union[float, None] = None,
                      tenant: Union[str, None] = None,
                      ) -> Tuple[float, ...]:
    """Per-frame planning P from an ``OccupancyEstimator``, no buckets.

    The estimator-threading rule of the UNPLANNED batch path: exactly
    the per-frame P ``plan_frames`` would assign (the measured EWMA
    where the estimator holds an observation near the frame's zoom
    depth, the workload's prior fallback otherwise), without building a
    ``CapacityPlan``. ``solve_batch(..., observed=...)`` without
    ``plan=`` feeds these straight into the engines -- ``frame_ps`` for
    the pooled shared ring, ``max(...)`` as the uniform scan P -- the
    same signals ``RenderService``'s feedback chunker derives, so the
    batch path and the service path size from one rule.
    """
    wl = getattr(problem, "workload", None)
    widths, ref_w = _frame_widths(problem, bounds_batch, ref_width)
    r = problem.r
    out = []
    for w in widths:
        d = zoom_depth(float(w), ref_width=ref_w, r=r)
        p = (observed.predict_quantized(d, workload=wl, tenant=tenant)
             if quantize
             else observed.predict(d, workload=wl, tenant=tenant))
        out.append(float(p))
    return tuple(out)


def plan_frames(problem, bounds_batch, *, observed=None,
                num_buckets: int = 4,
                safety_factor: float = 1.25,
                quantize: bool = False,
                p_deep: Union[float, None] = None,
                slope: Union[float, None] = None,
                p_min: Union[float, None] = None,
                ref_width: Union[float, None] = None,
                tenant: Union[str, None] = None,
                ) -> CapacityPlan:
    """Plan a zoom batch, blending MEASURED occupancy when available.

    Like ``plan_capacities``, but each frame's planning P comes from
    ``observed`` (a ``core.feedback.OccupancyEstimator``) when the
    estimator holds a measurement near that frame's zoom depth, and from
    the zoom-depth prior otherwise. At the default ``quantize=False`` a
    cold (or absent) estimator therefore reproduces ``plan_capacities``
    EXACTLY -- the cold-start contract of the feedback serving loop.
    ``quantize=True`` rounds every prediction (the cold prior included)
    up onto the estimator's ``p_quantum`` grid, trading that exactness
    for a bounded set of distinct capacity vectors (plan signatures)
    over the life of a stream -- cold-start comparisons then
    hold against a prior-only plan quantized the same way, which is what
    the render service's prior-only baseline (``adapt=False``) does.

    The per-frame provenance lands in ``CapacityPlan.frame_plans`` and,
    after execution, in ``PlanReport.frame_p_subdiv`` /
    ``frame_p_source``. When ``observed`` is given, the estimator's own
    band (p_deep / slope / p_min) governs its prior fallback, so passing
    those knobs alongside it raises instead of being silently ignored.

    ``tenant`` (multi-tenant serving, ``launch.frontdoor``) consults the
    estimator under that tenant's namespace -- the tenant's own
    measurements first, the shared workload namespace as fallback -- and
    is stamped on each ``FramePlan``. It requires ``observed=`` (the
    tenant dimension lives on the estimator).
    """
    if observed is None:
        if quantize:
            raise ValueError(
                "quantize=True needs observed=: the p_quantum grid lives "
                "on the OccupancyEstimator, so without one the flag would "
                "be silently ignored")
        if tenant is not None:
            raise ValueError(
                "tenant= needs observed=: tenant namespaces live on the "
                "OccupancyEstimator, so without one the flag would be "
                "silently ignored")
        return plan_capacities(
            problem, bounds_batch, num_buckets=num_buckets,
            safety_factor=safety_factor, p_deep=p_deep, slope=slope,
            p_min=p_min, ref_width=ref_width)
    clashing = [k for k, v in
                (("p_deep", p_deep), ("slope", slope), ("p_min", p_min))
                if v is not None]
    if clashing:
        raise ValueError(
            f"{clashing} conflict with observed=: the estimator's own "
            "band governs its prior fallback -- configure the "
            "OccupancyEstimator (or the WorkloadSpec band) instead")
    # measurements and prior fallback both live in the workload's own
    # estimator namespace: a mixed-workload service sharing one estimator
    # can never plan julia frames from mandelbrot measurements
    wl = getattr(problem, "workload", None)
    widths, ref_w = _frame_widths(problem, bounds_batch, ref_width)
    n, g, r, B = problem.n, problem.g, problem.r, problem.B
    ests, fps = [], []
    for i, w in enumerate(widths):
        d = zoom_depth(float(w), ref_width=ref_w, r=r)
        measured = observed.measured(d, workload=wl, tenant=tenant)
        p = (observed.predict_quantized(d, workload=wl, tenant=tenant)
             if quantize else observed.predict(d, workload=wl, tenant=tenant))
        ests.append(FrameEstimate(
            index=i, width=float(w), depth=d, p_subdiv=p,
            expected=tuple(expected_level_counts(n, g, r, B, P=p))))
        fps.append(FramePlan(index=i, width=float(w), depth=d,
                             p_prior=observed.prior(d, workload=wl),
                             p_measured=measured, p_subdiv=p,
                             tenant=tenant))
    return plan_from_p(problem, [e.p_subdiv for e in ests],
                       num_buckets=num_buckets, safety_factor=safety_factor,
                       estimates=tuple(ests), frame_plans=tuple(fps))


def plan_pooled(problem, bounds_batch, *, observed=None,
                safety_factor: float = 1.25,
                quantize: bool = False,
                p_deep: Union[float, None] = None,
                slope: Union[float, None] = None,
                p_min: Union[float, None] = None,
                ref_width: Union[float, None] = None,
                tenant: Union[str, None] = None,
                ) -> CapacityPlan:
    """Plan ONE pooled cross-frame bucket from summed occupancies.

    Per-frame estimation is exactly ``plan_frames`` (zoom-depth prior,
    optionally blended with an ``observed`` estimator's measurements,
    optionally quantized), but instead of bucketing frames into capacity
    classes the whole batch shares one ring sized per level from the SUM
    of the members' expected occupancies (``pooled.pooled_capacities``):

        cap_l = ceil(safety * sum_f E_l(P_f)),  clamped at F (g r^l)^2

    On a heterogeneous batch the sum is far below F x the hottest
    frame's capacity -- the pooled plan's ``ring_rows`` (2 x max caps,
    TOTAL) undercuts the per-frame plan's ``sum_b |b| x 2 x max(caps_b)``
    whenever the occupancy spread is real. Execute with ``solve_pooled``
    (or ``solve_batch(..., options=EngineOptions(engine="ask_pooled",
    plan=True))``).
    """
    base = plan_frames(problem, bounds_batch, observed=observed,
                       num_buckets=1, safety_factor=safety_factor,
                       quantize=quantize, p_deep=p_deep, slope=slope,
                       p_min=p_min, ref_width=ref_width, tenant=tenant)
    frame_ps = tuple(e.p_subdiv for e in base.estimates)
    caps = pooled_lib.pooled_capacities(problem, frame_ps,
                                        safety_factor=safety_factor)
    bucket = BucketPlan(frames=tuple(range(len(frame_ps))),
                        p_subdiv=max(frame_ps), capacities=caps, pooled=True)
    return dataclasses.replace(base, buckets=(bucket,), pooled=True)


# ---------------------------------------------------------------------------
# execution: one batched scan per bucket + overflow-adaptive retry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PlanReport:
    """What a planned run actually did (feeds the planner benchmarks)."""

    plan: CapacityPlan
    frames: int = 0
    dispatches: int = 0  # bucket programs issued, retries included
    retries: int = 0  # frame re-plans (a frame can be retried twice)
    retried_frames: tuple = ()  # indices that overflowed at least once
    overflow_dropped: int = 0  # final drops (0: every frame converged)
    leaf_count: int = 0
    region_counts: tuple = ()  # per-frame tuples, final successful run
    frame_leaf_counts: tuple = ()  # per-frame leaf counts, final run
    # the P that sized each frame's SUCCESSFUL dispatch (retries update
    # it to the bucket the frame converged in), and whether the plan got
    # it from the zoom-depth prior or a measured-occupancy estimator --
    # so tests/benchmarks assert on the signal, not on ring sizes
    frame_p_subdiv: tuple = ()
    frame_p_source: tuple = ()  # "prior" | "measured" per frame
    ring_rows: int = 0  # rows allocated across ALL dispatches, retries incl.
    wall_s: float = 0.0
    bucket_stats: tuple = ()  # ASKStats per dispatch, issue order

    @property
    def ring_bytes(self) -> int:
        return self.ring_rows * ROW_BYTES


def _run_bucket(problem, bounds: np.ndarray, caps, mesh):
    if mesh is None:
        return run_ask_scan_batch(problem, bounds, capacities=caps)
    return run_ask_scan_sharded(problem, bounds, mesh=mesh, capacities=caps)


def _padded_count(F: int, mesh) -> int:
    if mesh is None:
        return F
    return -(-F // mesh.size) * mesh.size


def _host(extras):
    """``extras`` as the planner's estimators read it (they take its
    widths in float64, before the engines' f32)."""
    return extras.cpu() if isinstance(extras, torch.Tensor) else extras


def _take_frames(bounds: np.ndarray, idx) -> np.ndarray:
    return bounds[np.asarray(idx, dtype=np.int64)]


class _Canvases:
    """The planned paths' output: one [F, n, n] tensor on the problem's
    device, filled by frame index with the frames that converged (every
    frame does, once, before the retry loop ends). A first dispatch of
    every frame, in order, that converges whole is the output itself (no
    copy)."""

    def __init__(self, frames: int):
        self.frames = frames
        self.out = None

    def take(self, states: torch.Tensor, idx, ok) -> None:
        if self.out is None:
            if list(idx) == list(range(self.frames)) and len(ok) == len(idx):
                self.out = states
                return
            self.out = torch.empty((self.frames,) + tuple(states.shape[1:]),
                                   dtype=states.dtype, device=states.device)
        if ok:
            dev = states.device
            sel = torch.tensor([idx[j] for j in ok], device=dev)
            self.out[sel] = states[torch.tensor(ok, device=dev)]


def solve_planned(problem, extras, *, plan: Union[CapacityPlan, None] = None,
                  mesh=None, num_buckets: int = 4,
                  safety_factor: float = 1.25,
                  max_dispatches: int = 64,
                  **plan_kw) -> Tuple[torch.Tensor, PlanReport]:
    """Execute a capacity plan: per-bucket dispatch + overflow retry.

    ``extras`` is the [F, 4] per-frame bounds. When ``plan`` is None one is
    built with ``plan_frames(problem, extras, num_buckets=...,
    safety_factor=..., **plan_kw)``; pass ``observed=`` there to blend
    measured occupancy from a ``core.feedback.OccupancyEstimator``.

    Buckets run in ascending capacity order, one ``run_ask_scan_batch``
    each, which reads its stats back once. Any frame whose
    ``ASKStats.frame_overflow`` entry is nonzero is re-planned: promoted
    into the next bucket's capacities if one exists, otherwise its
    capacities are doubled per level (clamped at the exhaustive worst
    case, which cannot overflow), so the loop ends with
    ``overflow_dropped == 0``. Frames with the same retry target share one
    dispatch.

    Returns ``(states, PlanReport)``, ``states`` one [F, n, n] tensor on
    the problem's device in input frame order (JAX's is host numpy; under
    a ``mesh`` on its first device). With a ``mesh`` each dispatch is the
    sharded batch (``ask.run_ask_scan_sharded``), and ``ring_rows`` counts
    its padded frames, as JAX does.
    """
    bounds = bounds_array(extras)
    F = bounds.shape[0]
    if plan is None:
        plan = plan_frames(problem, _host(extras), num_buckets=num_buckets,
                           safety_factor=safety_factor, **plan_kw)
    elif plan_kw:
        raise ValueError(
            f"plan was given, so estimation kwargs {sorted(plan_kw)} would "
            "be silently ignored -- drop them or drop the prebuilt plan")
    if plan.frames != F:
        raise ValueError(f"plan covers {plan.frames} frames, batch has {F}")

    worst = worst_case_capacities(problem)
    report = PlanReport(plan=plan, frames=F)
    t0 = time.perf_counter()

    out = _Canvases(F)
    leaf_counts = [0] * F
    region_counts: list = [()] * F
    frame_p: list = [float("nan")] * F
    retried: set = set()
    bucket_stats = []

    # worklist ascending by ring width; (capacities, frame indices,
    # position in plan.buckets or None once escalated beyond the plan,
    # the planning P that sized these capacities -- escalated-past-the-
    # plan entries keep the last bucket's P). Empty buckets dispatch
    # nothing but remain valid promotion targets.
    work = [(b.capacities, list(b.frames), pos, b.p_subdiv)
            for pos, b in enumerate(plan.buckets) if b.frames]

    while work:
        work.sort(key=lambda item: max(item[0]))
        caps, idx, pos, p_used = work.pop(0)
        if report.dispatches >= max_dispatches:
            raise RuntimeError(
                f"planner exceeded max_dispatches={max_dispatches} without "
                f"converging; frames still pending: {sorted(idx)}")
        states, st = _run_bucket(problem, _take_frames(bounds, idx), caps,
                                 mesh)
        report.dispatches += 1
        report.ring_rows += _padded_count(len(idx), mesh) * 2 * max(caps)
        bucket_stats.append(st)

        ok = [j for j in range(len(idx)) if st.frame_overflow[j] == 0]
        out.take(states, idx, ok)
        for j in ok:
            leaf_counts[idx[j]] = st.frame_leaf_counts[j]
            region_counts[idx[j]] = st.region_counts[j]
            frame_p[idx[j]] = p_used
        del states

        failed = [idx[j] for j in range(len(idx))
                  if st.frame_overflow[j] != 0]
        if failed:
            retried.update(failed)
            report.retries += len(failed)
            if pos is not None and pos + 1 < len(plan.buckets):
                tgt_caps = plan.buckets[pos + 1].capacities
                tgt_pos: Union[int, None] = pos + 1
                tgt_p = plan.buckets[pos + 1].p_subdiv
            else:
                tgt_caps = escalate_capacities(caps, worst, failed)
                tgt_pos = None
                tgt_p = p_used
            for item in work:
                if item[0] == tgt_caps:
                    item[1].extend(failed)
                    break
            else:
                work.append((tgt_caps, list(failed), tgt_pos, tgt_p))

    return out.out, _finish(report, plan, t0, retried, leaf_counts,
                            region_counts, frame_p, bucket_stats)


def _finish(report: PlanReport, plan: CapacityPlan, t0: float, retried,
            leaf_counts, region_counts, frame_p, bucket_stats) -> PlanReport:
    """Fill in a converged run's report (both planned paths)."""
    F = report.frames
    report.wall_s = time.perf_counter() - t0
    report.retried_frames = tuple(sorted(retried))
    report.leaf_count = sum(int(c) for c in leaf_counts)
    report.region_counts = tuple(region_counts)
    report.frame_leaf_counts = tuple(int(c) for c in leaf_counts)
    report.frame_p_subdiv = tuple(frame_p)
    report.frame_p_source = (tuple(fp.source for fp in plan.frame_plans)
                             if plan.frame_plans else ("prior",) * F)
    report.overflow_dropped = 0  # the loop only exits once every frame fits
    report.bucket_stats = tuple(bucket_stats)
    return report


def solve_pooled(problem, extras, *, plan: Union[CapacityPlan, None] = None,
                 mesh=None, safety_factor: float = 1.25,
                 max_dispatches: int = 64,
                 **plan_kw) -> Tuple[torch.Tensor, PlanReport]:
    """Execute a pooled plan: ONE cross-frame dispatch + overflow retry.

    The pooled counterpart of ``solve_planned``: the whole batch runs
    through ``core.pooled`` as one worklist whose shared ring the plan
    sized from the summed per-frame occupancies (``plan_pooled``; pass
    ``observed=`` / ``quantize=`` / band knobs through ``plan_kw``).
    ``extras`` is the [F, 4] bounds.

    Overflow stays per frame: any frame with a nonzero
    ``ASKStats.frame_overflow`` entry is re-pooled, the first time at a
    ring sized from only the overflowing frames' measured rows
    (``pooled.failed_pool_capacities``), after that at capacities doubled
    per level, clamped at the pooled worst case for the retry pool's own
    size (``pooled.escalate_pooled_capacities``, which cannot overflow),
    so the loop ends with ``overflow_dropped == 0``. ``ring_rows`` counts
    ``n_dev x 2 x max(caps)`` per dispatch. Under a ``mesh`` each dispatch
    is the sharded pool (``pooled.run_ask_pooled_sharded``): the first
    sizes each shard's ring from its own members' P (``frame_ps``), and a
    retry's ring serves one shard of the retried frames. Returns the
    canvases as in ``solve_planned``.
    """
    bounds = bounds_array(extras)
    F = bounds.shape[0]
    if plan is None:
        plan = plan_pooled(problem, _host(extras), safety_factor=safety_factor,
                           **plan_kw)
    elif plan_kw:
        raise ValueError(
            f"plan was given, so estimation kwargs {sorted(plan_kw)} would "
            "be silently ignored -- drop them or drop the prebuilt plan")
    if not plan.pooled:
        raise ValueError(
            "solve_pooled needs a pooled plan (plan_pooled / "
            "CapacityPlan(pooled=True)); per-frame plans run under "
            "solve_planned")
    if plan.frames != F:
        raise ValueError(f"plan covers {plan.frames} frames, batch has {F}")

    worst = worst_case_capacities(problem)
    n_dev = 1 if mesh is None else mesh.size
    p_used = plan.buckets[0].p_subdiv
    ps_all = (tuple(e.p_subdiv for e in plan.estimates)
              or (p_used,) * F)  # hand-built plans may omit estimates
    report = PlanReport(plan=plan, frames=F)
    t0 = time.perf_counter()

    out = _Canvases(F)
    leaf_counts = [0] * F
    region_counts: list = [()] * F
    frame_p: list = [float("nan")] * F
    retried: set = set()
    bucket_stats = []

    # (capacities-or-None, frame indices): None sizes the initial pool
    # from the plan (unsharded) / the members' own frame_ps (sharded)
    work: list = [(None, list(range(F)))]
    while work:
        caps_exp, idx = work.pop(0)
        if report.dispatches >= max_dispatches:
            raise RuntimeError(
                f"pooled planner exceeded max_dispatches={max_dispatches} "
                f"without converging; frames still pending: {sorted(idx)}")
        sel = _take_frames(bounds, idx)
        if mesh is None:
            caps = (caps_exp if caps_exp is not None
                    else plan.buckets[0].capacities)
            states, st = pooled_lib.run_ask_pooled_batch(
                problem, sel, capacities=caps)
        elif caps_exp is not None:
            states, st = pooled_lib.run_ask_pooled_sharded(
                problem, sel, mesh=mesh, capacities=caps_exp)
        else:
            states, st = pooled_lib.run_ask_pooled_sharded(
                problem, sel, mesh=mesh,
                frame_ps=[ps_all[i] for i in idx],
                safety_factor=plan.safety_factor)
        caps_used = st.olt_caps
        report.dispatches += 1
        report.ring_rows += n_dev * 2 * max(caps_used)
        bucket_stats.append(st)

        ok = [j for j in range(len(idx)) if st.frame_overflow[j] == 0]
        out.take(states, idx, ok)
        for j in ok:
            leaf_counts[idx[j]] = st.frame_leaf_counts[j]
            region_counts[idx[j]] = st.region_counts[j]
            frame_p[idx[j]] = p_used
        del states

        bad = [j for j in range(len(idx)) if st.frame_overflow[j] != 0]
        failed = [idx[j] for j in bad]
        if failed:
            retried.update(failed)
            report.retries += len(failed)
            shard_frames = -(-len(failed) // n_dev)
            ran_frames = -(-len(idx) // n_dev)
            if caps_exp is None:
                # first failure of the initial pool: size the retry ring
                # from ONLY the overflowing frames' measured contribution
                # instead of doubling the whole-batch pool
                tgt = pooled_lib.failed_pool_capacities(
                    problem,
                    [tuple(st.region_counts[j]) for j in bad],
                    leaf_counts=[int(st.frame_leaf_counts[j]) for j in bad],
                    frames_per_shard=shard_frames,
                    frame_ps=[ps_all[i] for i in failed],
                    caps_prev=caps_used,
                    dispatched_per_shard=ran_frames,
                    safety_factor=plan.safety_factor)
            else:
                tgt = pooled_lib.escalate_pooled_capacities(
                    caps_used, worst, shard_frames, failed,
                    dispatched_per_shard=ran_frames)
            for item in work:
                if item[0] == tgt:
                    item[1].extend(failed)
                    break
            else:
                work.append((tgt, list(failed)))

    return out.out, _finish(report, plan, t0, retried, leaf_counts,
                            region_counts, frame_p, bucket_stats)
