"""EngineOptions: one object for every ``solve_batch`` serving knob.

Counterpart of ``EngineOptions`` in ``repro/workloads/options.py``, with
the same fields, ``coerce``, ``from_kwargs``, ``apply_to`` and
``engine_kwargs``. ``solve_batch(problem, bounds,
options=EngineOptions(...))`` is the canonical spelling; the flat keyword
arguments fold into one through ``from_kwargs``. The port serves every
engine, ``"ask_scan"`` (the default), ``"ask_tuned"`` (the tuned tier,
applied by switching the problem's ``KernelPolicy`` backend, so it
composes with every other option) and ``"ask_pooled"``, with ``plan``,
``observed``, ``quantize``, ``num_buckets``, ``mesh`` (a
``launch.mesh.FramesMesh``) with ``pad_to``, and ``policy`` (kernel
routing). ``block_until_ready`` is accepted and has nothing to do: the
port reads the stats back after the canvases are written. ``FrontDoorOptions`` (``launch.frontdoor``) and
``TileOptions`` (``launch.tiles``) are the JAX package's, field for field,
with the same defaults and errors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

from repro_torch.kernels.policy import KernelPolicy

__all__ = ["EngineOptions", "FrontDoorOptions", "TileOptions"]

_ENGINES = ("ask_scan", "ask_tuned", "ask_pooled")

# the flat solve_batch kwargs that map onto first-class fields
_FIELD_KWARGS = ("plan", "observed", "mesh", "pad_to", "capacities",
                 "p_subdiv", "safety_factor", "num_buckets", "quantize",
                 "policy", "block_until_ready")


@dataclasses.dataclass(frozen=True)
class EngineOptions:
    """Everything that shapes one batched-serving dispatch. All fields
    default to unset (None or empty), and only set ones are forwarded."""

    engine: str = "ask_scan"  # "ask_scan" | "ask_tuned" | "ask_pooled"
    plan: Any = None          # planner switch: True | int K | CapacityPlan
    observed: Any = None      # core.feedback.OccupancyEstimator
    mesh: Any = None          # frame-axis sharding: a launch.mesh.FramesMesh
    pad_to: Optional[int] = None
    capacities: Optional[Tuple[int, ...]] = None
    p_subdiv: Optional[float] = None
    safety_factor: Optional[float] = None
    num_buckets: Optional[int] = None
    quantize: Any = None
    policy: Union[KernelPolicy, str, None] = None  # kernel routing override
    block_until_ready: Optional[bool] = None
    extra: Tuple[Tuple[str, Any], ...] = ()  # expert knobs (p_deep, ...)

    def __post_init__(self):
        if self.engine not in _ENGINES:
            raise ValueError(
                f"engine must be one of {_ENGINES}, got {self.engine!r}")
        if self.policy is not None:
            object.__setattr__(self, "policy",
                               KernelPolicy.coerce(self.policy))
        if self.capacities is not None:
            object.__setattr__(self, "capacities",
                               tuple(int(c) for c in self.capacities))
        extra = self.extra
        if not isinstance(extra, tuple):
            extra = tuple(sorted(dict(extra).items()))
        else:
            extra = tuple(sorted((str(k), v) for k, v in extra))
        object.__setattr__(self, "extra", extra)

    @classmethod
    def coerce(cls, value) -> "EngineOptions":
        """Pass an instance through; accept an engine name as shorthand."""
        if value is None:
            return cls()
        if isinstance(value, cls):
            return value
        if isinstance(value, str):
            return cls(engine=value)
        raise TypeError(
            f"options must be EngineOptions or engine name, got {type(value)}")

    @classmethod
    def from_kwargs(cls, kw: dict, *, engine: str = "ask_scan") -> "EngineOptions":
        """Fold a legacy flat-kwargs dict into an EngineOptions: known keys
        become fields, the rest land in ``extra``; ``kw`` is not changed."""
        kw = dict(kw)
        fields = {name: kw.pop(name) for name in _FIELD_KWARGS if name in kw}
        return cls(engine=engine, extra=tuple(sorted(kw.items())), **fields)

    def apply_to(self, problem):
        """``problem`` with this option set's kernel routing applied (the
        tuned engine and/or an explicit policy); the problem itself when
        neither changes it."""
        pol = self.policy if self.policy is not None else problem.policy
        if self.engine == "ask_tuned":
            pol = pol.with_backend("tuned")
        if pol == problem.policy:
            return problem
        return dataclasses.replace(problem, policy=pol)

    def engine_kwargs(self) -> dict:
        """The flat kwargs the engines take: the set fields, without
        ``engine``, ``mesh``, ``plan`` and ``policy``, plus ``extra``."""
        out = {}
        for name in ("observed", "pad_to", "capacities", "p_subdiv",
                     "safety_factor", "num_buckets", "quantize",
                     "block_until_ready"):
            value = getattr(self, name)
            if value is not None:
                out[name] = value
        out.update(self.extra)
        return out


@dataclasses.dataclass(frozen=True)
class FrontDoorOptions:
    """Everything that shapes the multi-tenant front door
    (``launch.frontdoor.FrontDoor``): admission, coalescing fairness,
    deadline handling, and backpressure.

    * ``max_queue`` bounds ADMITTED-but-not-dispatched requests across
      all tenants; a full queue either blocks ``submit`` until serving
      drains it (``on_full="block"``) or sheds the request with a typed
      ``AdmissionRejected`` (``on_full="shed"``).
    * ``max_in_flight`` bounds dispatched-but-not-finalised shared
      batches -- the front door's pipeline depth (2 = double buffering:
      batch k+1 computes behind batch k's demux).
    * ``quantum`` is the deficit-round-robin allotment: frames one
      tenant may take per rotation before the next tenant is served.
      The DRR service-gap bound is ``quantum x active tenants``.
    * ``max_batch_frames`` caps coalesced batch width (None: the
      service's ``chunk_frames``).
    * Deadline model: a batch's dispatch width shrinks so that
      ``overhead_s + width * per_frame_s`` fits inside the most urgent
      member's remaining slack; both seeds are refined online by an
      EWMA (weight ``latency_alpha``) of measured batch latency. With
      ``shed_expired`` (default) a request whose deadline has already
      passed when the coalescer reaches it is shed with a typed
      ``DeadlineExceeded`` instead of burning shared batch capacity.
    * ``tenant_feedback`` files each frame's measured occupancy under
      its tenant's estimator namespace (``core.feedback``), so one
      tenant's deep zoom refines its own plans without inflating
      others'.
    """

    max_queue: int = 64
    max_in_flight: int = 2
    max_batch_frames: Optional[int] = None
    quantum: int = 2
    on_full: str = "block"  # "block" | "shed"
    shed_expired: bool = True
    overhead_s: float = 0.0
    per_frame_s: float = 0.0
    latency_alpha: float = 0.5
    tenant_feedback: bool = False

    def __post_init__(self):
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        if self.max_in_flight < 1:
            raise ValueError(
                f"max_in_flight must be >= 1, got {self.max_in_flight}")
        if self.max_batch_frames is not None and self.max_batch_frames < 1:
            raise ValueError(
                f"max_batch_frames must be >= 1, got {self.max_batch_frames}")
        if self.quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {self.quantum}")
        if self.on_full not in ("block", "shed"):
            raise ValueError(
                f"on_full must be 'block' or 'shed', got {self.on_full!r}")
        if self.overhead_s < 0 or self.per_frame_s < 0:
            raise ValueError("latency model seeds must be >= 0")
        if not 0.0 < self.latency_alpha <= 1.0:
            raise ValueError(
                f"latency_alpha must be in (0, 1], got {self.latency_alpha}")


@dataclasses.dataclass(frozen=True)
class TileOptions:
    """Everything that shapes the tile service (``launch.tiles``).

    * ``max_bytes`` bounds the dwell cache (LRU by byte accounting --
      one entry costs its canvas ``nbytes``); 0 disables caching (every
      tile is a miss, the service degenerates to batched rendering).
    * ``depth_bias`` shifts the viewport -> tile-depth mapping: 0 picks
      the deepest grid whose tiles are at least as wide as the viewport
      (<= 4 tiles per square viewport), +1 halves tile width (finer
      tiles, more sharing across overlapping pans, more frames per
      request), -1 doubles it.
    * ``schema`` is the address schema version: it is part of every
      ``TileAddress``, so bumping it (``TileCache.invalidate`` does)
      orphans every cached entry at once -- the invalidation hook for
      "the renderer changed, addresses no longer mean the same bytes".
    * ``progressive`` turns on split-scan serving (``core.progressive``):
      misses yield a coarse preview canvas early, then refine to the
      exact final canvas, with refinement of batch k overlapping the
      coarse pass of batch k+1. ``checkpoint_level`` is the scan level
      the preview is painted at (None: ``min(1, levels)``).
    """

    max_bytes: int = 64 << 20
    depth_bias: int = 0
    schema: int = 1
    progressive: bool = False
    checkpoint_level: Optional[int] = None

    def __post_init__(self):
        if self.max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {self.max_bytes}")
        if self.schema < 0:
            raise ValueError(f"schema must be >= 0, got {self.schema}")
