"""Public entry points of the port's kernels, routed by a ``KernelPolicy``.

Counterpart of ``repro/kernels/ops.py``. Routing is governed by one object,
:class:`repro_torch.kernels.policy.KernelPolicy` (``policy=`` on every
entry point; the legacy ``backend=`` string goes through
``policy.resolve_policy``, with a ``DeprecationWarning``). Its rungs:

  ``torch`` -- the plain PyTorch versions of ``ref.py``, on the device of
               the tensors given;
  ``cuda``  -- the default: the kernel module's wrapper, which launches the
               hand-written kernel on a CUDA tensor (or raises) and takes
               the plain version on a CPU tensor;
  ``tuned`` -- per-call choice from the tuned tier (``kernels.autotune``):
               the cache's winner when the policy names a cache file, the
               heuristics when it is cold. On the card the choice is always
               a CUDA schedule (the steps per block U of the escape loop,
               Ex's thread block); nothing picks or falls back to a plain
               version there.

Schedule precedence (lowest to highest): an explicit keyword (``block=``)
< the tuned choice < ``policy.overrides``.

Grid workloads (``kind == "grid"``: ``ssd_synth``, a gather from a
generated field) take the plain path in ``mandelbrot``, both border
queries and both leaf passes, wherever the tensors lie, as JAX computes
them with jnp outside any Pallas kernel (``_route``); there the plain
version runs over every row with the rows past the count masked, so it
makes no host sync and a CUDA graph may capture it. Their fills (T) and
compactions still launch the CUDA kernels: ``region_fill``'s and
``compact_ranks``' routes take no workload, as in JAX.

``region_fill`` and ``region_dwell`` update the canvas in place and return
it (the JAX versions are functional, through ``input_output_aliases``).
Their third argument, and ``perimeter_query``'s second, is ``count``, the
live row count as an int32 [1] tensor on the device, where JAX takes a
duplicate-padded OLT (and, for the fill and the dwell, a ``nonempty``
flag); no kernel does work for a row past it.

The pooled engine's entry points take frame-tagged rows (frame, cy, cx),
the banded [F*n, n] canvas and, where a point is computed, ``planes``
[F, 4] from ``pooled_planes`` in place of JAX's ``bounds_all`` and
``pooled_bounds``: ``perimeter_query_pooled`` (JAX computes it with jnp
through ``perimeter_query``, whose route, keyed (side, n, max_dwell), it
shares), ``region_fill_pooled``, ``region_dwell_pooled``, and
``compact_ranks``, the OLT scan, which returns the count as a 0-d tensor
on the device.

``batched_ranks`` is the MoE's ``position_in_expert``: per-column OLT ranks
of [N, E] flags (JAX's contract) or of [G, N, E] flags, one launch for
every token group; unlike JAX's, it takes any N (no cumsum fallback).

The launch counters (``launches``) live on the kernel modules' wrappers
(``mandelbrot_dwell.mandelbrot_dwell``, ...), which these functions call.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import autotune, moe_dispatch, olt_compact, ref
from repro_torch.kernels.mandelbrot_dwell import (mandelbrot_dwell,
                                                  mandelbrot_dwell_plain)
from repro_torch.kernels.perimeter_query import (
    perimeter_query as _perimeter_query,
    perimeter_query_plain,
    perimeter_query_pooled as _perimeter_query_pooled,
    perimeter_query_pooled_plain)
from repro_torch.kernels.policy import Backend, KernelPolicy, resolve_policy
from repro_torch.kernels.ref import pooled_planes as _pooled_planes
from repro_torch.kernels.region_dwell import (region_dwell as _region_dwell,
                                              region_dwell_plain)
from repro_torch.kernels.region_dwell_pooled import (
    region_dwell_pooled as _region_dwell_pooled, region_dwell_pooled_plain)
from repro_torch.kernels.region_fill import (region_fill as _region_fill,
                                             region_fill_plain)
from repro_torch.kernels.region_fill_pooled import (
    region_fill_pooled as _region_fill_pooled, region_fill_pooled_plain)

__all__ = ["mandelbrot", "perimeter_query", "region_fill", "region_dwell",
           "pooled_planes", "perimeter_query_pooled", "region_fill_pooled",
           "region_dwell_pooled", "compact_ranks", "batched_ranks"]


def _grid_workload(workload) -> bool:
    """Grid workloads (a gather from a generated field) always take the
    plain path; escape-time workloads go to the kernels."""
    return workload is not None and getattr(workload, "kind", "") == "grid"


def _route(pol: KernelPolicy, kernel: str, *, device, workload=None, **sig):
    """-> (impl, schedule params): impl "torch" (the plain version) or
    "cuda" (the kernel module's wrapper). ``sig`` is the kernel's shape
    signature (the tuning cache's key fields, ``autotune.cache_key``);
    ``device`` is where the call runs. The policy's overrides apply last,
    over the heuristics and the cache."""
    if _grid_workload(workload):
        return "torch", dict(pol.override_for(kernel))
    if pol.backend is Backend.TORCH:
        impl, params = "torch", {}
    elif pol.backend is Backend.CUDA:
        impl, params = "cuda", {}
    else:  # Backend.TUNED
        choice = autotune.choose(kernel, workload=workload,
                                 cache=pol.tuning_cache, device=device, **sig)
        impl, params = choice.impl, choice.param_dict()
    params.update(pol.override_for(kernel))
    return impl, params


def _live(count: torch.Tensor, N: int, device) -> torch.Tensor:
    """[N] bool: the rows below the device count, read with no host sync."""
    return torch.arange(N, device=device) < count.reshape(())


def _window(n: int, bounds, plane):
    """The plane of a single-frame call on the plain path: ``plane`` (the
    card's [4] copy, which a CUDA graph reads at each replay) as four 0-d
    tensors, else ``ref.plane(n, bounds)``."""
    return tuple(plane.unbind()) if plane is not None else ref.plane(n, bounds)


def _masked_query(coords, count, *, side, n, bounds, max_dwell, workload,
                  plane):
    """The border query of a grid workload: the plain version over every
    row (the rows past ``count`` cleared first), those rows then (False, 0);
    no host sync."""
    live = _live(count, coords.shape[0], coords.device)
    coords = torch.where(live[:, None], coords, 0)
    ys, xs = ref.perimeter_coords(coords, side)
    cr, ci = ref.map_plane(xs, ys, _window(n, bounds, plane))
    dw = ref.dwell_compute(cr, ci, max_dwell, workload=workload)
    homog = (dw == dw[:, :1, :1]).all(dim=2).all(dim=1)
    return homog & live, torch.where(live, dw[:, 0, 0], 0)


def _masked_dwell(canvas, coords, count, *, side, n, bounds, max_dwell,
                  workload, plane):
    """The leaf pass of a grid workload: every row's tile, added to the
    canvas as its difference to it (0 for the rows past ``count``); the
    live rows are distinct regions, so each pixel gets its tile's value. No
    host sync."""
    live = _live(count, coords.shape[0], coords.device)
    coords = torch.where(live[:, None], coords, 0)
    ys, xs = ref.region_pixels(coords, side)
    cr, ci = ref.map_plane(xs, ys, _window(n, bounds, plane))
    tiles = ref.dwell_compute(cr, ci, max_dwell, workload=workload)
    iy, ix = ref.region_index(coords, side)
    return _write_live(canvas, (iy, ix), tiles, live)


def _write_live(canvas, index, tiles, live):
    """canvas[index] = tiles on the live rows only, with no host sync: the
    dead rows (cleared to region 0) add 0 where a live row may write, so
    the writes are a ``scatter_add_`` of differences."""
    flat = canvas.view(-1)
    at = (index[0] * canvas.shape[1] + index[1]).reshape(-1)
    delta = tiles.to(canvas.dtype).reshape(-1) - flat[at]
    keep = live[:, None, None].expand(tiles.shape).reshape(-1)
    flat.scatter_add_(0, at, torch.where(keep, delta, 0))
    return canvas


def _masked_query_pooled(rows, count, planes, *, side, max_dwell, workload):
    """``_masked_query`` on frame-tagged rows, each in its frame's plane."""
    live = _live(count, rows.shape[0], rows.device)
    rows = torch.where(live[:, None], rows, 0)
    homog, common = ref.perimeter_query_pooled_ref(
        rows, planes, side=side, max_dwell=max_dwell, workload=workload)
    return homog & live, torch.where(live, common, 0)


def _masked_dwell_pooled(canvas, rows, count, planes, *, side, n, max_dwell,
                         workload):
    """``_masked_dwell`` on frame-tagged rows of the banded canvas."""
    live = _live(count, rows.shape[0], rows.device)
    rows = torch.where(live[:, None], rows, 0)
    tiles = ref.region_interior_pooled_ref(rows, planes, side=side,
                                           max_dwell=max_dwell,
                                           workload=workload)
    return _write_live(canvas, ref.pooled_region_index(rows, side, n), tiles,
                       live)


def mandelbrot(n: int, *, bounds=ref.DEFAULT_BOUNDS, max_dwell: int = 512,
               workload=None, device="cuda", block=None, backend=None,
               policy=None) -> torch.Tensor:
    """Ex: the exhaustive n x n value image on ``device`` (named for the
    seed workload; ``workload=`` makes it serve any). ``block``: Ex's
    thread block on the card, (rows, columns)."""
    pol = resolve_policy(backend, policy)
    impl, params = _route(pol, "dwell", device=device, workload=workload,
                          n=n, max_dwell=max_dwell)
    if impl == "torch":
        return mandelbrot_dwell_plain(n, bounds=bounds, max_dwell=max_dwell,
                                      workload=workload, device=device)
    return mandelbrot_dwell(n, bounds=bounds, max_dwell=max_dwell,
                            workload=workload, device=device,
                            unroll=params.get("unroll"),
                            block=params.get("block", block))


def perimeter_query(coords: torch.Tensor, count: torch.Tensor, *, side: int,
                    n: int, bounds=ref.DEFAULT_BOUNDS, max_dwell: int = 512,
                    workload=None, plane=None, backend=None, policy=None):
    """Border query Q: (homog [N] bool, common [N] int32), the rows past
    ``count`` (False, 0); see ``kernels.perimeter_query``."""
    pol = resolve_policy(backend, policy)
    impl, params = _route(pol, "perimeter_query", device=coords.device,
                          workload=workload, side=side, n=n,
                          max_dwell=max_dwell)
    kw = dict(side=side, n=n, bounds=bounds, max_dwell=max_dwell,
              workload=workload)
    if _grid_workload(workload):
        return _masked_query(coords, count, plane=plane, **kw)
    if impl == "torch":
        return perimeter_query_plain(coords, count, **kw)
    return _perimeter_query(coords, count, plane=plane,
                            unroll=params.get("unroll"), **kw)


def region_fill(canvas: torch.Tensor, coords: torch.Tensor,
                values: torch.Tensor, count: torch.Tensor, *, side: int,
                n: int, scheme: str = "sbr", tile: int = 256, backend=None,
                policy=None) -> torch.Tensor:
    """Terminal work T: fill the first ``count`` regions with their values,
    in place; see ``kernels.region_fill``."""
    pol = resolve_policy(backend, policy)
    impl, params = _route(pol, "region_fill", device=canvas.device, side=side,
                          n=n)
    if impl == "torch":
        return region_fill_plain(canvas, coords, values, count, side=side, n=n)
    return _region_fill(canvas, coords, values, count, side=side, n=n,
                        scheme=params.get("scheme", scheme),
                        tile=int(params.get("tile", tile)))


def region_dwell(canvas: torch.Tensor, coords: torch.Tensor,
                 count: torch.Tensor, *, side: int, n: int,
                 bounds=ref.DEFAULT_BOUNDS, max_dwell: int = 512,
                 scheme: str = "sbr", tile: int = 256, workload=None,
                 plane=None, backend=None, policy=None) -> torch.Tensor:
    """Last-level work A: the interior values of the first ``count`` leaf
    regions, in place; see ``kernels.region_dwell``."""
    pol = resolve_policy(backend, policy)
    impl, params = _route(pol, "region_dwell", device=canvas.device,
                          workload=workload, side=side, n=n,
                          max_dwell=max_dwell)
    kw = dict(side=side, n=n, bounds=bounds, max_dwell=max_dwell,
              workload=workload)
    if _grid_workload(workload):
        return _masked_dwell(canvas, coords, count, plane=plane, **kw)
    if impl == "torch":
        return region_dwell_plain(canvas, coords, count, **kw)
    return _region_dwell(canvas, coords, count, scheme=params.get("scheme", scheme),
                         tile=int(params.get("tile", tile)), plane=plane,
                         unroll=params.get("unroll"), **kw)


def pooled_planes(n: int, bounds_all, device) -> torch.Tensor:
    """The [F, 4] f32 per-frame planes of ``ref.pooled_planes`` as one
    tensor on ``device`` (one upload per batch; to the card from pinned
    memory, with no host sync)."""
    planes = torch.from_numpy(_pooled_planes(n, bounds_all))
    if torch.device(device).type == "cuda":
        return planes.pin_memory().to(device, non_blocking=True)
    return planes.to(device)


def perimeter_query_pooled(rows: torch.Tensor, count: torch.Tensor,
                           planes: torch.Tensor, *, side: int,
                           max_dwell: int = 512, workload=None, n=None,
                           backend=None, policy=None):
    """Q on frame-tagged rows: (homog [N] bool, common [N] int32). ``n``
    (the frame's side) keys the tuned choice, which is
    ``perimeter_query``'s, as in JAX."""
    pol = resolve_policy(backend, policy)
    impl, params = _route(pol, "perimeter_query", device=rows.device,
                          workload=workload, side=side, n=n,
                          max_dwell=max_dwell)
    kw = dict(side=side, max_dwell=max_dwell, workload=workload)
    if _grid_workload(workload):
        return _masked_query_pooled(rows, count, planes, **kw)
    if impl == "torch":
        return perimeter_query_pooled_plain(rows, count, planes, **kw)
    return _perimeter_query_pooled(rows, count, planes,
                                   unroll=params.get("unroll"), **kw)


def region_fill_pooled(canvas: torch.Tensor, rows: torch.Tensor,
                       values: torch.Tensor, count: torch.Tensor, *,
                       side: int, n: int, backend=None,
                       policy=None) -> torch.Tensor:
    """T on the banded canvas, in place; see ``kernels.region_fill_pooled``."""
    pol = resolve_policy(backend, policy)
    impl, _ = _route(pol, "region_fill_pooled", device=canvas.device,
                     side=side, n=n, F=canvas.shape[0] // n)
    fill = region_fill_pooled_plain if impl == "torch" else _region_fill_pooled
    return fill(canvas, rows, values, count, side=side, n=n)


def region_dwell_pooled(canvas: torch.Tensor, rows: torch.Tensor,
                        count: torch.Tensor, planes: torch.Tensor, *,
                        side: int, n: int, max_dwell: int = 512,
                        workload=None, backend=None,
                        policy=None) -> torch.Tensor:
    """A on frame-tagged leaf rows of the banded canvas, in place; see
    ``kernels.region_dwell_pooled``."""
    pol = resolve_policy(backend, policy)
    impl, params = _route(pol, "region_dwell_pooled", device=canvas.device,
                          workload=workload, side=side, n=n,
                          F=canvas.shape[0] // n, max_dwell=max_dwell)
    kw = dict(side=side, n=n, max_dwell=max_dwell, workload=workload)
    if _grid_workload(workload):
        return _masked_dwell_pooled(canvas, rows, count, planes, **kw)
    if impl == "torch":
        return region_dwell_pooled_plain(canvas, rows, count, planes, **kw)
    return _region_dwell_pooled(canvas, rows, count, planes,
                                unroll=params.get("unroll"), **kw)


def compact_ranks(flags: torch.Tensor, *, backend=None, policy=None):
    """Exclusive-scan OLT compaction (the atomicAdd replacement). Returns
    (ranks [N] int32, count int32 0-d), on the device."""
    pol = resolve_policy(backend, policy)
    impl, _ = _route(pol, "olt_compact", device=flags.device, n=flags.shape[0])
    scan = (olt_compact.compact_ranks_plain if impl == "torch"
            else olt_compact.compact_ranks)
    ranks, count = scan(flags)
    return ranks, count.reshape(())


def batched_ranks(flags: torch.Tensor, *, backend=None, policy=None):
    """Per-column OLT ranks. ``flags`` [N, E] returns (ranks [N, E], counts
    [E]); [G, N, E] returns (ranks [G, N, E], counts [G, E]); int32, on the
    device."""
    pol = resolve_policy(backend, policy)
    impl, _ = _route(pol, "batched_ranks", device=flags.device,
                     n=flags.shape[-2], e=flags.shape[-1])
    ranks_of = ref.batched_ranks if impl == "torch" else moe_dispatch.batched_ranks
    if flags.ndim == 2:
        ranks, counts = ranks_of(flags[None].contiguous())
        return ranks[0], counts[0]
    return ranks_of(flags)
