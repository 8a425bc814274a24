"""Measured-occupancy feedback: close the loop between what a chunk
actually subdivided and what the planner assumes the next chunk will.

Counterpart of ``repro/core/feedback.py``, copied (it is plain Python host
code): the same functions, estimator and snapshot format, over the port's
planner and workload registry.

The capacity planner (``core/planner.py``) seeds each frame's effective
subdivision probability from a zoom-depth *prior*
(``planner.effective_p_subdiv``): a fit, not a measurement. A trajectory
whose density deviates from that fit -- e.g. a zoom path skimming the
Mandelbrot boundary while still zoomed out -- either overflows into the
retry path (extra dispatches) or over-provisions ring memory. But every
finished chunk already carries the ground truth: ``ASKStats.
region_counts`` records the live-region count entering each level, and
the ratio of consecutive entries IS the per-level subdivision rate the
cost model's constant-P assumption (paper Sec. 4.2.1, assumption ii)
abstracts. This module turns those counts into an empirical
``p_subdiv`` per zoom depth and feeds it back into planning:

  1. ``measured_p_subdiv`` reduces one frame's observed level counts to
     a single constant-P equivalent -- the envelope P whose expected-
     occupancy curve covers every level the frame actually populated;
  2. ``OccupancyEstimator`` maintains an EWMA of that measurement per
     zoom-depth bucket, across chunk boundaries. Depths never observed
     fall back to the prior -- the cold-start chunk of a stream plans
     exactly as the prior-only planner would;
  3. ``predict_quantized`` rounds the blended P *up* onto a coarse grid,
     so the downstream capacity vectors -- and therefore the compiled
     chunk programs -- take at most O((p_deep - p_min) / p_quantum)
     distinct signatures for the life of a serving process.

Consumers: ``planner.plan_frames(..., observed=estimator)`` blends the
measurement into a batch plan; ``launch.render_service.RenderService(
feedback=...)`` re-plans every chunk of a stream from the estimator
state. This is runtime aggregation in the sense of the DP-consolidation
compilers (Wu et al. 2016): the launch configuration of iteration k+1
is derived from the measured workload of iteration k, not from a static
model.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

from repro_torch.core.planner import (P_DEEP_DEFAULT, P_MIN_DEFAULT,
                                      SLOPE_DEFAULT, effective_p_subdiv)

__all__ = [
    "measured_p_subdiv",
    "level_subdivision_rates",
    "ewma",
    "OccupancyEstimator",
]


def level_subdivision_rates(region_counts: Sequence[int], leaf_count: int,
                            *, r: int) -> Tuple[float, ...]:
    """Per-level measured subdivision rates of one frame.

    ``region_counts`` is the engine's entering-count chain (live regions
    entering exploration level l, ``ASKStats.region_counts``); appending
    ``leaf_count`` completes it (regions that reached the last level).
    A level-l parent spawns r^2 children when it subdivides, so the
    measured rate at level l is::

        p_hat_l = count[l + 1] / (r^2 * count[l])

    Levels with zero parents contribute no rate (the chain ended).
    Returns one rate per executed exploration level.
    """
    if r < 2:
        raise ValueError(f"r must be >= 2, got {r}")
    chain = [int(c) for c in region_counts] + [int(leaf_count)]
    rates = []
    for cur, nxt in zip(chain, chain[1:]):
        if cur <= 0:
            break
        rates.append(nxt / (r * r * cur))
    return tuple(rates)


def measured_p_subdiv(region_counts: Sequence[int], leaf_count: int,
                      *, g: int, r: int) -> Optional[float]:
    """Envelope constant-P equivalent of one frame's observed counts.

    The ring is sized level by level from the cost model's E_l =
    g^2 (r^2 P)^l (paper Sec. 4.2.1 assumption ii), so the measurement
    that matters for CAPACITY is the smallest constant P whose E_l
    curve dominates every observed level count -- the envelope::

        p_hat = max_{l >= 1} (count[l] / g^2)^(1/l) / r^2

    evaluated over the whole chain (exploration levels plus the leaf
    level). A work-weighted average of the per-level rates
    (``level_subdivision_rates``) would under-size whichever level
    binds: real occupancy profiles are flatter than the geometric
    model, and the pooled rate is dominated by the deep, populous
    levels. Counts generated exactly from a constant P recover that P
    (every level gives the same value), which is the property the
    regression tier pins.

    Returns None when the frame carries no subdivision information (no
    exploration levels executed, e.g. an n/g <= B chain) -- callers
    keep the prior in that case. The estimate is NOT clamped here; the
    estimator clamps to its [p_min, p_deep] band so the planning P
    always stays in the band the prior lives in.
    """
    if g < 1 or r < 2:
        raise ValueError(f"need g >= 1 and r >= 2, got g={g} r={r}")
    chain = [int(c) for c in region_counts] + [int(leaf_count)]
    best = None
    for lv, count in enumerate(chain):
        if lv == 0:
            continue  # every root is live: level 0 carries no signal
        p = (count / (g * g)) ** (1.0 / lv) / (r * r)
        if best is None or p > best:
            best = p
    return best


def ewma(old: Optional[float], new: float, alpha: float) -> float:
    """One EWMA step: ``old + alpha * (new - old)``; seeds at ``new``.

    A contraction toward ``new`` with factor (1 - alpha):
    ``|ewma(old, new, a) - new| == (1 - a) * |old - new|`` -- the
    property tests pin this, it is what makes the estimator stable
    under noisy per-chunk measurements.
    """
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    if old is None:
        return new
    return old + alpha * (new - old)


@dataclasses.dataclass
class OccupancyEstimator:
    """EWMA of measured subdivision probability per (workload,
    zoom-depth-bucket) key.

    The estimator is the feedback state a serving loop carries across
    chunk boundaries. Depth (``planner.zoom_depth`` levels, negative =
    zoomed out) is bucketed at ``depth_quantum`` resolution; each bucket
    holds an EWMA of the envelope measured P of the frames observed
    there. Every observation/prediction method takes an optional
    ``workload`` (a ``workloads.WorkloadSpec`` or its registry
    name): measurements are filed under that workload's namespace and
    its prior band governs clamping and fallback, so ONE estimator can
    back a mixed-workload render service without julia measurements
    contaminating mandelbrot plans. ``workload=None`` is the default
    namespace, whose band is this estimator's own ``p_deep`` / ``slope``
    / ``p_min`` fields -- the pre-workload behaviour. Prediction:

    * a depth whose nearest observed bucket (same workload) lies within
      ``max_extrapolate`` levels returns that bucket's EWMA (clamped to
      the band -- measurement noise never plans outside the band the
      prior lives in);
    * anything further from every observation falls back to the
      zoom-depth prior (``planner.effective_p_subdiv`` with the
      workload's band), so a cold estimator plans EXACTLY like the
      prior-only planner -- the cold-start contract the regression tier
      pins.

    ``predict_quantized`` additionally rounds UP onto a ``p_quantum``
    grid: rounding up keeps the capacity estimate safe, and the grid
    bounds how many distinct capacity vectors (hence compiled chunk
    programs) a feedback-driven stream can ever request.

    Every method additionally takes an optional ``tenant`` (a string id
    from the multi-tenant front door, ``launch.frontdoor``): a tenant
    refines the workload namespace to ``"<tenant>@<workload>"`` so one
    tenant's deep-zoom measurements never inflate another tenant's
    plans for the SAME workload. Prediction with a tenant falls back in
    two steps: the tenant's own buckets first, then the shared workload
    namespace (what every tenant's frames contributed when observed
    without a tenant), then the workload prior -- so a brand-new tenant
    plans from the fleet-wide measurement, not the cold prior. The
    band (clamp range, prior fallback) always comes from the workload
    part alone; workload names therefore must not contain ``"@"``
    (registry names never do).

    ``snapshot()`` / ``OccupancyEstimator.restore()`` round-trip the
    whole state (config, per-workload bands, EWMA buckets, counters)
    through a JSON-able dict, so a restarted service resumes from the
    warm plan instead of the cold prior
    (``launch.render_service.RenderService(feedback_state=...)``).
    """

    p_deep: float = P_DEEP_DEFAULT
    slope: float = SLOPE_DEFAULT
    p_min: float = P_MIN_DEFAULT
    alpha: float = 0.5  # EWMA weight of the newest chunk's measurement
    depth_quantum: float = 0.5  # depth-bucket width, in subdivision levels
    max_extrapolate: float = 2.0  # levels a measurement generalises across
    p_quantum: float = 0.05  # predict_quantized grid (plan signatures)
    # (workload key, depth bucket) -> EWMA of the envelope measured P
    _ewma: Dict[Tuple[str, int], float] = dataclasses.field(default_factory=dict)
    # workload key -> (p_deep, slope, p_min); "" uses the fields above
    _bands: Dict[str, Tuple[float, float, float]] = dataclasses.field(
        default_factory=dict)
    frames_observed: int = 0
    chunks_observed: int = 0

    def __post_init__(self):
        if not 0.0 < self.alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {self.alpha}")
        if self.depth_quantum <= 0 or self.p_quantum <= 0:
            raise ValueError("depth_quantum and p_quantum must be positive")
        if not 0.0 < self.p_min <= self.p_deep <= 1.0:
            raise ValueError(
                f"need 0 < p_min <= p_deep <= 1, got {self.p_min}/{self.p_deep}")

    # -- workload namespaces ------------------------------------------------

    def _key(self, workload, tenant=None) -> str:
        """Resolve a workload argument to its namespace key, learning
        its prior band on the way (a spec argument registers its band;
        a bare registry name resolves it lazily so restored snapshots
        and name-only callers agree with spec callers). A ``tenant``
        prefixes the key as ``"<tenant>@<workload>"`` -- the tenant
        dimension of the namespace; bands stay keyed by the workload
        part alone (``_band`` strips the prefix)."""
        if workload is None:
            name = ""
        elif isinstance(workload, str):
            name = workload
            if name and name not in self._bands:
                try:
                    from repro_torch.workloads.registry import get_workload
                    self._bands[name] = tuple(get_workload(name).prior_band)
                except KeyError:
                    pass  # unregistered name: fall back to the default band
        else:
            name = workload.name
            if name not in self._bands:
                self._bands[name] = tuple(float(b) for b in workload.prior_band)
        if "@" in name:
            raise ValueError(
                f"workload name {name!r} contains '@', which is reserved "
                "for the tenant namespace separator")
        if tenant is None or tenant == "":
            return name
        return f"{tenant}@{name}"

    def _band(self, key: str) -> Tuple[float, float, float]:
        if "@" in key:  # tenant-scoped namespace: the band is the workload's
            key = key.rsplit("@", 1)[1]
        return self._bands.get(key, (self.p_deep, self.slope, self.p_min))

    # -- observation --------------------------------------------------------

    def _bucket(self, depth: float) -> int:
        return int(round(float(depth) / self.depth_quantum))

    def _clamp(self, p: float, key: str = "") -> float:
        deep, _, p_min = self._band(key)
        return min(max(float(p), p_min), deep)

    def observe_value(self, depth: float, p: float, *,
                      workload=None, tenant=None) -> float:
        """Fold one measured P at one depth into the EWMA state.

        Returns the bucket's new EWMA. The raw measurement is clamped
        into the workload's [p_min, p_deep] band first, so the state
        space of the estimator is the band the prior lives in.
        """
        key = self._key(workload, tenant)
        b = (key, self._bucket(depth))
        self._ewma[b] = ewma(self._ewma.get(b), self._clamp(p, key),
                             self.alpha)
        self.frames_observed += 1
        return self._ewma[b]

    def observe_frames(self, depths: Sequence[float],
                       chains: Sequence[Tuple[Sequence[int], int]],
                       *, g: int, r: int, workload=None,
                       tenant=None) -> None:
        """Observe one finished chunk: per-frame (region_counts,
        leaf_count) chains at the given zoom depths.

        Within the chunk, frames sharing a depth bucket are reduced by
        MAX before the EWMA step -- capacity is an envelope problem (the
        hottest frame of a class binds its ring), so averaging frames
        inside one chunk would systematically under-size; smoothing
        belongs ACROSS chunk boundaries, where it damps measurement
        noise chunk to chunk. Frames whose chain carries no subdivision
        information (see ``measured_p_subdiv``) are skipped. Counts as
        one chunk regardless of how many frames it held.
        """
        if len(depths) != len(chains):
            raise ValueError(
                f"got {len(depths)} depths for {len(chains)} chains")
        key = self._key(workload, tenant)
        per_bucket: Dict[int, float] = {}
        for depth, (counts, leaf) in zip(depths, chains):
            p = measured_p_subdiv(counts, leaf, g=g, r=r)
            if p is None:
                continue
            b = self._bucket(depth)
            v = self._clamp(p, key)
            per_bucket[b] = max(per_bucket.get(b, v), v)
            self.frames_observed += 1
        for b, v in per_bucket.items():
            self._ewma[(key, b)] = ewma(self._ewma.get((key, b)), v,
                                        self.alpha)
        self.chunks_observed += 1

    def observe_stats(self, depths: Sequence[float], stats, *,
                      g: int, r: int, workload=None, tenant=None) -> None:
        """Observe a finished batched/sharded dispatch from its
        ``ASKStats`` (uses ``stats.frame_chains()``)."""
        self.observe_frames(depths, stats.frame_chains(), g=g, r=r,
                            workload=workload, tenant=tenant)

    def observe_report(self, report, *, g: int, r: int) -> None:
        """Observe a finished planned run (``planner.PlanReport``).

        Depths come from the plan's per-frame estimates and the
        namespace from the plan's stamped workload, so the measurements
        land where the next ``plan_frames(..., observed=...)`` for the
        same problem will look. Reports built from hand-made plans
        without estimates cannot be observed this way (pass depths to
        ``observe_frames`` instead).
        """
        ests = report.plan.estimates
        if len(ests) != report.frames:
            raise ValueError(
                "plan carries no per-frame estimates; use observe_frames "
                "with explicit depths")
        name = report.plan.workload
        band = getattr(report.plan, "workload_band", None)
        if name and band is not None:
            # learn the band from the plan stamp, so parametric workload
            # instances whose names are not registry keys (e.g.
            # "multibrot(m=4)") still clamp against their OWN band
            self._bands.setdefault(name, tuple(float(b) for b in band))
        depths = [e.depth for e in ests]
        chains = list(zip(report.region_counts, report.frame_leaf_counts))
        self.observe_frames(depths, chains, g=g, r=r, workload=name or None)

    # -- prediction ---------------------------------------------------------

    def prior(self, depth: float, *, workload=None, tenant=None) -> float:
        """The zoom-depth prior this estimator falls back to (the
        workload's own band when one is given; the band never depends
        on the tenant, so ``tenant`` is accepted only for signature
        symmetry with the other prediction methods)."""
        del tenant  # the prior band is a workload property
        deep, slope, p_min = self._band(self._key(workload))
        return effective_p_subdiv(depth, p_deep=deep, slope=slope,
                                  p_min=p_min)

    def _nearest_bucket(self, depth: float, key: str) -> Optional[int]:
        buckets = [b for (k, b) in self._ewma if k == key]
        if not buckets:
            return None
        b = float(depth) / self.depth_quantum
        nearest = min(buckets, key=lambda k: (abs(k - b), k))
        if abs(nearest - b) * self.depth_quantum > self.max_extrapolate:
            return None
        return nearest

    def _lookup(self, depth: float, workload, tenant):
        """Namespace-resolved nearest bucket: the tenant's own buckets
        first, the shared workload namespace second. Returns (key,
        bucket) with bucket None when neither holds anything in range."""
        key = self._key(workload, tenant)
        b = self._nearest_bucket(depth, key)
        if b is None and tenant:
            key = self._key(workload)
            b = self._nearest_bucket(depth, key)
        return key, b

    def measured(self, depth: float, *, workload=None,
                 tenant=None) -> Optional[float]:
        """Nearest observed bucket's EWMA within ``max_extrapolate``
        levels of ``depth`` (the tenant's namespace when given, falling
        back to the shared workload namespace); None when every
        observation is too far."""
        key, b = self._lookup(depth, workload, tenant)
        return None if b is None else self._ewma[(key, b)]

    def predict(self, depth: float, *, workload=None, tenant=None) -> float:
        """Blended planning P at ``depth``. Always inside the band.

        When a measurement is near enough, the prediction is that
        bucket's EWMA shifted by the PRIOR's trend between the bucket
        centre and ``depth`` -- the measurement supplies the level, the
        prior supplies the depth shape -- so a zooming trajectory whose
        frames land slightly deeper than every observation so far is
        not systematically under-predicted. With no measurement in
        range the prediction IS the prior (the cold-start contract).
        With a ``tenant``, the tenant's own buckets are consulted
        before the shared workload namespace.
        """
        key, b = self._lookup(depth, workload, tenant)
        if b is None:
            return self._clamp(self.prior(depth, workload=workload), key)
        shift = (self.prior(depth, workload=workload)
                 - self.prior(b * self.depth_quantum, workload=workload))
        return self._clamp(self._ewma[(key, b)] + shift, key)

    def predict_quantized(self, depth: float, *, workload=None,
                          tenant=None) -> float:
        """``predict`` rounded UP onto the ``p_quantum`` grid (then
        clamped to the band's p_deep). Monotone in the raw prediction
        and never below it up to the p_deep cap -- rounding up keeps
        capacity sizing safe while bounding the set of distinct plan
        signatures a stream can request."""
        p = self.predict(depth, workload=workload, tenant=tenant)
        q = math.ceil(p / self.p_quantum - 1e-12) * self.p_quantum
        deep, _, _ = self._band(self._key(workload))
        return min(q, deep)

    # -- introspection / persistence ----------------------------------------

    @property
    def is_cold(self) -> bool:
        """True until the first observation lands: every prediction is
        the prior, the cold-start contract of the serving loop."""
        return not self._ewma

    def buckets(self, workload=None, tenant=None) -> Dict[float, float]:
        """One namespace's observed state as {bucket centre depth:
        EWMA P} (a copy; the pre-workload ``snapshot()`` view)."""
        key = self._key(workload, tenant)
        return {b * self.depth_quantum: v
                for (k, b), v in sorted(self._ewma.items()) if k == key}

    def workloads_observed(self) -> Tuple[str, ...]:
        """Namespace keys holding at least one observation ("" is the
        default namespace)."""
        return tuple(sorted({k for (k, _) in self._ewma}))

    def snapshot(self) -> dict:
        """Full state as a JSON-able dict (``json.dumps`` clean).

        The inverse is ``OccupancyEstimator.restore``; the round-trip is
        exact up to float64 repr, so a service restarted from a saved
        snapshot plans every chunk exactly as the warm original would.
        """
        return {
            "version": 1,
            "config": {
                "p_deep": self.p_deep, "slope": self.slope,
                "p_min": self.p_min, "alpha": self.alpha,
                "depth_quantum": self.depth_quantum,
                "max_extrapolate": self.max_extrapolate,
                "p_quantum": self.p_quantum,
            },
            "bands": {k: list(v) for k, v in sorted(self._bands.items())},
            "ewma": [[k, b, v] for (k, b), v in sorted(self._ewma.items())],
            "frames_observed": self.frames_observed,
            "chunks_observed": self.chunks_observed,
        }

    @classmethod
    def restore(cls, state: dict) -> "OccupancyEstimator":
        """Rebuild an estimator from ``snapshot()`` output (parsed JSON).

        Snapshot files live outside the process (service restarts read
        whatever is on disk), so restore SANITIZES instead of ingesting
        blindly: non-finite or out-of-range EWMA entries and malformed
        band triples are dropped (falling back to the prior, exactly as
        if never observed) rather than poisoning later ``predict()``
        calls -- a NaN EWMA would flow straight through ``_clamp``'s
        min/max into every capacity vector planned from it. Entries for
        workloads this process never serves are harmless and kept (they
        are only consulted under their own namespace). Structurally
        unusable snapshots (wrong version, bad config) still raise.
        """
        version = state.get("version")
        if version != 1:
            raise ValueError(f"unknown estimator snapshot version {version!r}")
        est = cls(**state["config"])
        bands = {}
        for k, v in state.get("bands", {}).items():
            try:
                band = tuple(float(x) for x in v)
            except (TypeError, ValueError):
                continue
            if len(band) != 3 or not all(math.isfinite(x) for x in band):
                continue
            deep, slope, p_min = band
            if not (0.0 < p_min <= deep <= 1.0) or slope < 0.0:
                continue
            bands[str(k)] = band
        est._bands = bands
        ewma = {}
        for entry in state.get("ewma", []):
            try:
                k, b, v = entry
                key, bucket, val = str(k), int(b), float(v)
            except (TypeError, ValueError):
                continue
            if not math.isfinite(val) or not 0.0 < val <= 1.0:
                continue
            ewma[(key, bucket)] = val
        est._ewma = ewma
        est.frames_observed = max(0, int(state.get("frames_observed", 0) or 0))
        est.chunks_observed = max(0, int(state.get("chunks_observed", 0) or 0))
        return est
