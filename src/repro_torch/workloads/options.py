"""EngineOptions: one object for every ``solve_batch`` serving knob.

Counterpart of ``EngineOptions`` in ``repro/workloads/options.py``, with
the same fields, ``coerce``, ``from_kwargs`` and ``engine_kwargs``.
``solve_batch(problem, bounds, options=EngineOptions(...))`` is the
canonical spelling; the flat keyword arguments fold into one through
``from_kwargs``. The port serves ``engine="ask_scan"`` (the default) and
``"ask_pooled"``, with ``plan``, ``observed``, ``quantize`` and
``num_buckets``; ``solve_batch`` raises ``NotImplementedError`` for
``engine="ask_tuned"`` (slice 11) and ``mesh`` (slice 12), and ``policy``
raises here: kernel routing comes with ROADMAP queue 1 slice 11. ``block_until_ready`` is
accepted and has nothing to do: the port reads the stats back after the
canvases are written. ``FrontDoorOptions`` and ``TileOptions`` come with
the serving slice (10).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

__all__ = ["EngineOptions"]

# ask_tuned is accepted here and raises in solve_batch (slice 11)
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
    mesh: Any = None          # frame-axis sharding (slice 12)
    pad_to: Optional[int] = None
    capacities: Optional[Tuple[int, ...]] = None
    p_subdiv: Optional[float] = None
    safety_factor: Optional[float] = None
    num_buckets: Optional[int] = None
    quantize: Any = None
    policy: Any = None        # kernel routing (slice 11): must stay None
    block_until_ready: Optional[bool] = None
    extra: Tuple[Tuple[str, Any], ...] = ()  # expert knobs (p_deep, ...)

    def __post_init__(self):
        if self.engine not in _ENGINES:
            raise ValueError(
                f"engine must be one of {_ENGINES}, got {self.engine!r}")
        if self.policy is not None:
            raise NotImplementedError(
                "policy= is not ported yet: kernel routing and the tuned "
                "tier come with ROADMAP queue 1 slice 11")
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
