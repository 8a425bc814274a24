"""Mariani-Silver subdivision (paper Sec. 6), one frame or a batch of them.

Counterpart of ``repro/workloads/frame_problem.py`` without the tuned
path. ``FrameProblem`` implements the ``ASKProblem`` adapter for
one workload, so the same object runs under the engines the paper compares
and under the batch engines:

  Ex     -- ``exhaustive`` below                   (one flat kernel)
  DP     -- ``repro_torch.core.dp_emul.run_dp``    (one dispatch per tree node)
  ASK    -- ``repro_torch.core.ask.run_ask``       (one dispatch per level)
  fused  -- ``repro_torch.core.ask.run_ask_fused`` (one dispatch per frame,
            worst-case capacities: ``solve(p, "ask_fused")``)
  scan   -- ``repro_torch.core.ask.run_ask_scan``  (one dispatch per frame,
            a ring sized by the cost model: ``solve(p, "ask_scan")``)
  batch  -- ``repro_torch.core.ask.run_ask_scan_batch`` (one dispatch per
            batch, a ring per frame: ``solve_batch``'s default engine)
  pooled -- ``repro_torch.core.pooled``            (one dispatch per batch,
            one shared ring: ``solve(p, "ask_pooled")``, ``solve_batch``
            with ``EngineOptions(engine="ask_pooled")``)
  plans  -- ``repro_torch.core.planner``           (``solve_batch(...,
            plan=...)``: a dispatch per capacity bucket, retries)
  shards -- ``solve_batch(..., mesh=...)`` and ``dispatch_batch``: the
            batch engines over a ``launch.mesh.FramesMesh``, one pool a
            device (``run_ask_scan_sharded``, ``run_ask_pooled_sharded``)
  split  -- ``repro_torch.core.progressive``      (a preview after the
            first levels, then the exact canvas: ``preview_step`` and
            ``pooled_preview_step`` paint it)

Per level, ``level_step`` runs the border query Q (``perimeter_query``),
compacts the homogeneous regions into a fill-OLT through the scan kernel
(``ops.compact_ranks``) and fills them (T,
``region_fill``), and returns the subdivide flags; ``leaf_step`` runs the
last-level work A (``region_dwell``). The canvas is updated in place and
returned, where the JAX version is functional. Every kernel reads the
live row count of its OLT on the device (the OLTs are padded to a power
of two), so a level needs no host sync of its own and no kernel computes
a padding row. On the card Q and A read the frame's window from a [4] f32
plane in device memory (``window``), so a CUDA graph of the level loop,
captured once per ``graph_key``, serves any bounds copied into it
(``reading``). ``pooled_level_step`` and ``pooled_leaf_step`` do the same
for the pooled engine's frame-tagged rows on its banded [F*n, n] canvas,
each row in its own frame's plane; both batch engines run them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple, Union

import torch

from repro_torch.core import olt
from repro_torch.core.ask import (ASKStats, dispatch_ask_scan_sharded,
                                  run_ask, run_ask_fused, run_ask_scan,
                                  run_ask_scan_batch, run_ask_scan_sharded,
                                  synchronize)
from repro_torch.core.dp_emul import run_dp
from repro_torch.core.pooled import (bounds_array,
                                     dispatch_ask_pooled_sharded,
                                     run_ask_pooled, run_ask_pooled_batch,
                                     run_ask_pooled_sharded)
from repro_torch.kernels import _build, ops, ref
from repro_torch.workloads.registry import get_workload
from repro_torch.workloads.spec import WorkloadSpec

__all__ = ["FrameProblem", "MandelbrotProblem", "exhaustive", "solve",
           "solve_batch", "dispatch_batch"]

# engines of the JAX package that later slices port (ROADMAP queue 1)
_LATER = {"ask_tuned": 11}


@dataclasses.dataclass(frozen=True)
class FrameProblem:
    """ASKProblem adapter for Mariani-Silver subdivision of one workload.

    ``workload`` is a registry name or a ``WorkloadSpec``; ``bounds``
    defaults to the workload's own window. ``device`` is where the canvas
    and the OLTs live: "cuda" (the default) runs the CUDA kernels and
    raises when there is no card; "cpu" runs the plain versions. ``plane``
    (no part of the problem's identity) is where the card's Q and A read
    the window: None is ``_build.plane_tensor``'s of ``bounds``.
    """

    n: int
    g: int = 2
    r: int = 2
    B: int = 32
    max_dwell: int = 512
    bounds: Union[Tuple[float, float, float, float], None] = None
    scheme: str = "sbr"  # "sbr" | "mbr"  (paper Sec. 4.3)
    tile: int = 256  # MBR tile side
    workload: Union[str, WorkloadSpec] = "mandelbrot"
    device: Union[str, torch.device] = "cuda"
    plane: Optional[torch.Tensor] = dataclasses.field(
        default=None, compare=False, repr=False)

    def __post_init__(self):
        spec = get_workload(self.workload)
        object.__setattr__(self, "workload", spec)
        bounds = spec.default_bounds if self.bounds is None else self.bounds
        object.__setattr__(self, "bounds", tuple(float(b) for b in bounds))
        _build.on_card(self.device)  # raises for a missing card
        object.__setattr__(self, "device", torch.device(self.device))
        if self.scheme not in ("sbr", "mbr"):
            raise ValueError(f"unknown scheme {self.scheme!r}")
        if self.n % self.g:
            raise ValueError("n must be divisible by g")
        side = self.n // self.g
        while side > self.B:
            if side % self.r:
                raise ValueError(
                    f"subdivision chain broken: side {side} not divisible by r={self.r}")
            side //= self.r

    # -- ASKProblem protocol ------------------------------------------------

    def init_state(self) -> torch.Tensor:
        return torch.zeros((self.n, self.n), dtype=torch.int32,
                           device=self.device)

    def root_coords(self) -> torch.Tensor:
        g = torch.arange(self.g, device=self.device)
        cy, cx = torch.meshgrid(g, g, indexing="ij")
        return torch.stack([cy.reshape(-1), cx.reshape(-1)],
                           dim=-1).to(torch.int32)

    def region_side(self, level: int) -> int:
        return self.n // (self.g * self.r ** level)

    def level_step(self, state: torch.Tensor, coords: torch.Tensor,
                   valid: torch.Tensor, *,
                   level: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Q on the valid prefix of ``coords``, then T on its homogeneous
        regions (in place). Returns (state, subdivide flags)."""
        side = self.region_side(level)
        count = valid.sum(dtype=torch.int32).reshape(1)
        homog, common = ops.perimeter_query(
            coords, count, side=side, n=self.n, bounds=self.bounds,
            max_dwell=self.max_dwell, workload=self.workload, plane=self.plane)
        rows = torch.cat([coords, common[:, None]], dim=1)  # (cy, cx, value)
        fill, fill_count = olt.compact_gather(
            rows, homog, coords.shape[0], ranks_count=ops.compact_ranks(homog))
        ops.region_fill(state, fill[:, :2].contiguous(),
                        fill[:, 2].contiguous(), fill_count.reshape(1), side=side,
                        n=self.n, scheme=self.scheme, tile=self.tile)
        return state, valid & ~homog

    def leaf_step(self, state: torch.Tensor, coords: torch.Tensor,
                  valid: torch.Tensor, *, level: int) -> torch.Tensor:
        """A on the valid prefix of ``coords`` (in place). Returns state."""
        count = valid.sum(dtype=torch.int32).reshape(1)
        return ops.region_dwell(
            state, coords, count, side=self.region_side(level), n=self.n,
            bounds=self.bounds, max_dwell=self.max_dwell, scheme=self.scheme,
            tile=self.tile, workload=self.workload, plane=self.plane)

    def preview_step(self, state: torch.Tensor, coords: torch.Tensor,
                     valid: torch.Tensor, *, level: int) -> torch.Tensor:
        """The split scan's cheap paint of the live set
        (``core.progressive``): every valid region of ``coords``,
        homogeneous or not, is filled with its border's common value (the
        dwell of its first border point), by one Q and one T, with no
        per-pixel dwell (``leaf_step``'s work). In place on ``state``, a
        copy of the scan's canvas: the scan's own state is never painted.
        Returns state."""
        side = self.region_side(level)
        count = valid.sum(dtype=torch.int32).reshape(1)
        _, common = ops.perimeter_query(
            coords, count, side=side, n=self.n, bounds=self.bounds,
            max_dwell=self.max_dwell, workload=self.workload, plane=self.plane)
        return ops.region_fill(state, coords, common, count, side=side,
                               n=self.n, scheme=self.scheme, tile=self.tile)

    # -- one-dispatch protocol (CUDA-graph replays, core.ask) ---------------

    def graph_key(self) -> tuple:
        """What a captured level loop holds fixed: every field but the
        window (``bounds`` and ``plane``), which the card's kernels read
        from memory."""
        return tuple((f.name, getattr(self, f.name))
                     for f in dataclasses.fields(self)
                     if f.name not in ("bounds", "plane"))

    def window(self) -> torch.Tensor:
        """The [4] f32 plane of this frame's window on its device."""
        if self.plane is not None:
            return self.plane
        return _build.plane_tensor(self.n, self.bounds, self.device)

    def reading(self, plane: torch.Tensor) -> "FrameProblem":
        """This problem with its card kernels reading the window from
        ``plane`` (a graph's static input)."""
        return dataclasses.replace(self, plane=plane)


    # -- pooled protocol (cross-frame worklists, core.pooled) ---------------
    # ``rows`` is a frame-tagged [N, 3] = (frame, cy, cx) worklist of the
    # whole batch, ``state`` the banded [F*n, n] canvas and ``planes`` the
    # [F, 4] per-frame planes (ops.pooled_planes; JAX passes bounds_all).

    def pooled_level_step(self, state: torch.Tensor, rows: torch.Tensor,
                          valid: torch.Tensor, *, level: int,
                          planes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Q on the valid prefix of ``rows``, then T on its homogeneous
        regions (in place); both compactions go through the scan kernel.
        Returns (state, subdivide flags)."""
        side = self.region_side(level)
        count = valid.sum(dtype=torch.int32).reshape(1)
        homog, common = ops.perimeter_query_pooled(
            rows, count, planes, side=side, max_dwell=self.max_dwell,
            workload=self.workload)
        homog = homog & valid
        fill_rows = torch.cat([rows, common[:, None]], dim=1)  # (f, cy, cx, v)
        fill, fill_count = olt.compact_gather(
            fill_rows, homog, rows.shape[0],
            ranks_count=ops.compact_ranks(homog))
        ops.region_fill_pooled(state, fill[:, :3].contiguous(),
                               fill[:, 3].contiguous(), fill_count.reshape(1),
                               side=side, n=self.n)
        return state, valid & ~homog

    def pooled_preview_step(self, state: torch.Tensor, rows: torch.Tensor,
                            valid: torch.Tensor, *, level: int,
                            planes: torch.Tensor) -> torch.Tensor:
        """``preview_step`` on frame-tagged rows of the banded canvas: the
        pooled Q's common value of each valid row, filled by the pooled T
        (in place). Returns state."""
        side = self.region_side(level)
        count = valid.sum(dtype=torch.int32).reshape(1)
        _, common = ops.perimeter_query_pooled(
            rows, count, planes, side=side, max_dwell=self.max_dwell,
            workload=self.workload)
        return ops.region_fill_pooled(state, rows, common, count, side=side,
                                      n=self.n)

    def pooled_leaf_step(self, state: torch.Tensor, rows: torch.Tensor,
                         valid: torch.Tensor, *, level: int,
                         planes: torch.Tensor) -> torch.Tensor:
        """A on the valid prefix of ``rows`` (in place). Returns state."""
        count = valid.sum(dtype=torch.int32).reshape(1)
        return ops.region_dwell_pooled(
            state, rows, count, planes, side=self.region_side(level), n=self.n,
            max_dwell=self.max_dwell, workload=self.workload)


# the paper's case study is the default-workload FrameProblem
MandelbrotProblem = FrameProblem


def exhaustive(n: int, *, max_dwell: int = 512, bounds=None,
               workload: Union[str, WorkloadSpec, None] = None,
               device="cuda"):
    """Ex: the flat one-kernel baseline (paper Sec. 6.1). Returns
    (canvas [n, n] int32, ASKStats); ``wall_s`` ends after the device
    finished."""
    spec = None if workload is None else get_workload(workload)
    if bounds is None:
        bounds = ref.DEFAULT_BOUNDS if spec is None else spec.default_bounds
    dev = torch.device(device)
    t0 = time.perf_counter()
    canvas = ops.mandelbrot(n, bounds=tuple(bounds), max_dwell=max_dwell,
                            workload=spec, device=dev)
    synchronize(dev)
    return canvas, ASKStats(levels=0, kernel_launches=1,
                            wall_s=time.perf_counter() - t0)


def solve(problem: FrameProblem, method: str = "ask", **kw):
    """Dispatcher: method in {ex, ask, ask_fused, ask_scan, ask_pooled,
    dp}; ``kw`` goes to the engine (``ask_scan`` and ``ask_pooled`` take
    ``capacities``, ``p_subdiv`` and ``safety_factor``, ``ask_fused``
    ``capacity_factor``). ``ask_tuned`` raises ``NotImplementedError``
    naming its ROADMAP slice."""
    if method == "ex":
        return exhaustive(problem.n, max_dwell=problem.max_dwell,
                          bounds=problem.bounds, workload=problem.workload,
                          device=problem.device, **kw)
    if method == "ask":
        return run_ask(problem, **kw)
    if method == "ask_fused":
        return run_ask_fused(problem, **kw)
    if method == "ask_scan":
        return run_ask_scan(problem, **kw)
    if method == "ask_pooled":
        return run_ask_pooled(problem, **kw)
    if method == "dp":
        return run_dp(problem, **kw)
    if method in _LATER:
        raise NotImplementedError(
            f"method {method!r} is not ported yet: ROADMAP queue 1 slice "
            f"{_LATER[method]}")
    raise ValueError(f"unknown method {method!r}")


# what solve_batch does not serve yet, and the ROADMAP queue 1 slice that
# brings it
_BATCH_LATER = {"ask_tuned": (11, "the tuned tier")}


def _not_ported(what: str):
    slice_, name = _BATCH_LATER[what]
    return NotImplementedError(
        f"{what!r} is not ported yet: {name} comes with ROADMAP queue 1 "
        f"slice {slice_}")


def solve_batch(problem: FrameProblem, bounds_batch, *, options=None,
                mesh=None, plan=None, **kw):
    """Batched frame serving: render F frames, ``bounds_batch`` [F, 4]
    (re0, im0, re1, im1) per frame, in one engine dispatch.

    ``options`` (an ``EngineOptions`` or an engine name) configures the
    call, as in JAX; the flat keyword arguments are its legacy spelling,
    and mixing the two raises ``ValueError``. Engines:

    * ``"ask_scan"`` (the default, and the legacy path's): every frame
      with a ring of its own, the frames run as one worklist
      (``core.ask.run_ask_scan_batch``); returns (canvases [F, n, n],
      ASKStats);
    * ``"ask_pooled"``: one shared ring for all frames' regions
      (``core.pooled.run_ask_pooled_batch``), the same return.

    ``mesh`` (a ``launch.mesh.FramesMesh``) shards the frames over its
    devices, frame-major, one pool a shard
    (``core.ask.run_ask_scan_sharded``, ``core.pooled.
    run_ask_pooled_sharded``; ``pad_to`` sets the padding multiple), with
    the same return; the planner takes it too. Bounds are computed in the traced f32 spelling (``ref.pooled_planes``)
    on both. ``plan`` (an int K of buckets, True, or a
    ``planner.CapacityPlan``) routes through the capacity planner
    (``planner.solve_planned``, or ``planner.solve_pooled`` for the pooled
    engine, where an int does not apply) and returns (canvases on the
    problem's device, ``planner.PlanReport``) with ``overflow_dropped``
    0. ``observed=`` (a ``core.feedback.OccupancyEstimator``) without a
    plan sizes the engine from measured occupancy as JAX threads it: per
    frame P into the pooled ring, the hottest frame's P into the scan
    (``quantize=True`` rounds it onto the estimator's grid); with a plan
    it goes to the planner. ``block_until_ready`` has nothing to do: the
    stats are read back after the canvases are written. ``ask_tuned``
    raises ``NotImplementedError`` naming its slice.
    """
    from repro_torch.workloads.options import EngineOptions

    if options is not None:
        if mesh is not None or plan is not None or kw:
            legacy = [k for k, v in (("mesh", mesh), ("plan", plan))
                      if v is not None] + sorted(kw)
            raise ValueError(
                f"pass options= OR the legacy kwargs {legacy}, not both")
        opts = EngineOptions.coerce(options)
        mesh, plan, kw = opts.mesh, opts.plan, opts.engine_kwargs()
        engine = opts.engine
    else:
        engine = "ask_scan"  # the legacy flat-kwarg path predates engines
    if engine == "ask_tuned":
        raise _not_ported(engine)
    bounds = bounds_array(bounds_batch)
    planned = plan is not None and plan is not False
    kw.pop("block_until_ready", None)
    if not planned:
        # observed= without plan=: the estimator sizes the engine, per
        # frame P into the pooled ring, the hottest frame's into the scan
        observed = kw.pop("observed", None)
        quantize = kw.pop("quantize", None)
        if quantize and observed is None:
            raise ValueError(
                "quantize=True needs observed=: the p_quantum grid lives "
                "on the OccupancyEstimator")
        if observed is not None:
            clash = {"capacities", "p_subdiv", "frame_ps"} & kw.keys()
            if clash:
                raise ValueError(
                    f"{sorted(clash)} conflict with observed=: the "
                    "estimator sizes the ring -- drop them or drop "
                    "observed=")
            from repro_torch.core import planner as planner_lib
            ps = planner_lib.observed_frame_ps(
                problem, bounds, observed, quantize=bool(quantize),
                ref_width=kw.pop("ref_width", None),
                tenant=kw.pop("tenant", None))
            if engine == "ask_pooled":
                kw["frame_ps"] = list(ps)
            else:
                kw["p_subdiv"] = max(ps)
    if engine == "ask_pooled":
        if planned:
            from repro_torch.core import planner as planner_lib
            engine_only = ({"capacities", "p_subdiv", "pad_to",
                            "num_buckets"} & kw.keys())
            if engine_only:
                raise ValueError(
                    f"{sorted(engine_only)} do not apply to the pooled "
                    "planner -- it sizes ONE shared ring from the summed "
                    "per-frame occupancies (tune safety_factor / observed "
                    "/ quantize / band knobs instead)")
            plan_obj = (plan if isinstance(plan, planner_lib.CapacityPlan)
                        else None)
            if plan_obj is None and not isinstance(plan, bool):
                raise ValueError(
                    "plan=<bucket count> does not apply to ask_pooled -- "
                    "the pooled worklist IS one shared bucket; pass "
                    "plan=True or a pooled CapacityPlan")
            return planner_lib.solve_pooled(problem, bounds, plan=plan_obj,
                                            mesh=mesh, **kw)
        if mesh is None:
            return run_ask_pooled_batch(problem, bounds, **kw)
        return run_ask_pooled_sharded(problem, bounds, mesh=mesh, **kw)
    if planned:
        from repro_torch.core import planner as planner_lib
        engine_only = {"capacities", "p_subdiv", "pad_to"} & kw.keys()
        if engine_only:
            raise ValueError(
                f"{sorted(engine_only)} belong to the uniform path; the "
                "planner sizes capacities itself -- tune num_buckets / "
                "safety_factor / p_deep / slope / p_min / ref_width instead")
        plan_obj = plan if isinstance(plan, planner_lib.CapacityPlan) else None
        if plan_obj is None and not isinstance(plan, bool):
            kw.setdefault("num_buckets", int(plan))
        return planner_lib.solve_planned(problem, bounds, plan=plan_obj,
                                         mesh=mesh, **kw)
    if mesh is None:
        return run_ask_scan_batch(problem, bounds, **kw)
    return run_ask_scan_sharded(problem, bounds, mesh=mesh, **kw)


def dispatch_batch(problem: FrameProblem, bounds_batch, *, mesh=None,
                   options=None, **kw):
    """Enqueue one sharded frame batch without waiting for it (async
    serving): the non-blocking half of ``solve_batch(..., mesh=...)``.

    Returns a ``core.ask.ShardedDispatch`` (``core.pooled.PooledDispatch``
    for ``engine="ask_pooled"``) as soon as every shard is enqueued, with
    no host sync; ``.finalize()`` gives the same (canvases, ASKStats). A
    pipelined caller enqueues chunk k+1 before it finalizes chunk k, so
    the host's read-back of one overlaps the card's work on the next.
    ``options`` (an ``EngineOptions`` carrying the mesh) is the canonical
    spelling, as in ``solve_batch``. Without a mesh it raises JAX's
    ``ValueError``; ``engine="ask_tuned"`` raises ``NotImplementedError``
    (slice 11).
    """
    from repro_torch.workloads.options import EngineOptions

    if options is not None:
        if mesh is not None or kw:
            raise ValueError(
                "pass options= OR the legacy mesh=/engine kwargs, not both")
        opts = EngineOptions.coerce(options)
        mesh, kw = opts.mesh, opts.engine_kwargs()
        engine = opts.engine
    else:
        engine = "ask_scan"
    if mesh is None:
        raise ValueError(
            "dispatch_batch needs a mesh (mesh= or options.mesh)")
    if engine == "ask_tuned":
        raise _not_ported(engine)
    kw.pop("block_until_ready", None)
    if engine == "ask_pooled":
        return dispatch_ask_pooled_sharded(
            problem, bounds_array(bounds_batch), mesh=mesh, **kw)
    return dispatch_ask_scan_sharded(problem, bounds_array(bounds_batch),
                                     mesh=mesh, **kw)
