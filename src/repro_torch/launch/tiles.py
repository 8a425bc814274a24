"""Progressive tile service with a content-addressed dwell cache.

Counterpart of ``repro/launch/tiles.py``, a port of it: addresses and
their float64 bounds are the same bit for bit, and so are the cache and
the serving order. It differs only where canvases come to the host
(``core.readback.to_host``: a copy stream waits on the dispatch's own
event), so the preview of a miss batch reaches the host without waiting
for the refinement enqueued behind it.

The ASK ladder is naturally progressive (paper's ``g -> r -> B``
subdivision: level-0 regions are a coarse preview of the final dwell
canvas, each scan level refines it), and pan/zoom streams from many
users revisit the same regions of the plane. This module exploits both:

* a viewport is split into **quantised, workload-stamped tiles** whose
  key -- :class:`TileAddress` ``(schema, workload, n, max_dwell, depth,
  iy, ix)`` -- is a deterministic *content address*: the same address
  always reconstructs the same float64 tile bounds, so it always names
  the same rendered bytes. Quantisation is float-drift-safe: indices
  are computed in float64 on a ``1 / SNAP`` sub-grid, so two pans that
  land on the same tile under float32 coordinate noise produce the same
  key, while adjacent tiles differ by a full integer index and can
  never alias.
* cache hits are served immediately from a bounded LRU
  (:class:`TileCache`, byte accounting); misses are coalesced into
  planned batches through the existing
  ``RenderService.dispatch_planned`` seam -- so the front door's
  DRR/deadline machinery (``launch.frontdoor``) applies unchanged and a
  tile batch is indistinguishable from any other coalesced batch.
* :meth:`TileService.serve_progressive` streams **progressive**
  results through the split scan (``core.progressive``): the coarse
  checkpoint canvas of each miss batch is yielded early, then refined
  to the exact final canvas -- and because ``refine()`` enqueues on the
  device-resident carry without a host sync, the refinement of batch k
  is in flight behind the coarse pass of batch k+1, the overlap the
  pipeline-DP model calls for.

Cache coherence is by construction: addresses are pure functions of the
quantised viewport, and the renderer's identity is pinned by the
``schema`` version stamped into every address --
:meth:`TileCache.invalidate` bumps it, orphaning every cached entry at
once (the hook for "the kernels changed, old bytes are stale").
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.readback import to_host
from repro_torch.workloads.options import TileOptions

__all__ = [
    "SNAP",
    "TileAddress",
    "TileCache",
    "TileResponse",
    "TileService",
    "quantize_index",
    "tile_depth",
    "tiles_for_viewport",
]

# Quantisation sub-grid: tile-relative coordinates are rounded to the
# nearest 1/SNAP of a tile width before flooring to an index. float32
# carries ~7 significant digits, so coordinates that SHOULD coincide
# drift by well under 2**-16 of a tile; snapping absorbs that drift
# while keeping distinct tiles a full integer index apart.
SNAP = 1 << 16


@dataclasses.dataclass(frozen=True, order=True)
class TileAddress:
    """Deterministic content address of one rendered dwell tile.

    Everything that determines the rendered bytes is in the key:
    ``workload`` (the serving key / workload spec), canvas size ``n``,
    ``max_dwell``, grid ``depth`` (tile width = reference width /
    ``2**depth``), the integer grid position ``(iy, ix)``, and the
    address ``schema`` version (renderer identity -- see
    :meth:`TileCache.invalidate`). Two services computing addresses for
    the same viewport agree bit-for-bit; object identity plays no part.
    """

    schema: int
    workload: str
    n: int
    max_dwell: int
    depth: int
    iy: int
    ix: int

    def bounds(self, ref_bounds: Sequence[float]) -> Tuple[float, ...]:
        """Exact float64 tile bounds, reconstructed from the integers.

        The same address always yields the same bounds (pure float64
        arithmetic on the grid integers), which is what makes the
        address a CONTENT address: rendering it twice gives identical
        bytes.
        """
        re0, im0, re1, im1 = (float(x) for x in ref_bounds)
        tw = (re1 - re0) / float(1 << self.depth)
        th = (im1 - im0) / float(1 << self.depth)
        return (re0 + self.ix * tw, im0 + self.iy * th,
                re0 + (self.ix + 1) * tw, im0 + (self.iy + 1) * th)


def quantize_index(x: float, origin: float, tile_w: float) -> int:
    """Drift-safe grid index of coordinate ``x``: float64 tile-relative
    position, snapped to the ``1/SNAP`` sub-grid, floored. Coordinates
    within ``tile_w / SNAP`` of a tile boundary land ON the boundary, so
    float32/float64 renderings of the same pan agree."""
    u = (float(x) - float(origin)) / float(tile_w)
    return int(np.floor(np.round(u * SNAP) / SNAP))


def tile_depth(viewport_width: float, ref_width: float,
               *, bias: int = 0) -> int:
    """Grid depth for a viewport: the deepest grid whose tiles are at
    least as wide as the viewport (so a square viewport touches at most
    2x2 tiles), shifted by ``bias`` (+1 = finer). The log is snapped the
    same way as indices so widths that should be an exact power-of-two
    fraction of the reference are, under either float precision."""
    vw = float(viewport_width)
    rw = float(ref_width)
    if vw <= 0 or rw <= 0:
        raise ValueError(
            f"widths must be positive, got viewport={vw} reference={rw}")
    z = int(np.floor(np.round(np.log2(rw / vw) * SNAP) / SNAP))
    return max(0, z + int(bias))


def tiles_for_viewport(bounds: Sequence[float], *, ref_bounds: Sequence[float],
                       n: int, max_dwell: int, workload: str = "",
                       depth: Optional[int] = None, bias: int = 0,
                       schema: int = 1) -> Tuple[TileAddress, ...]:
    """The quantised tile cover of one viewport, row-major order.

    ``depth=None`` derives the grid from the viewport width
    (:func:`tile_depth`); the cover spans every tile the half-open
    viewport ``[re0, re1) x [im0, im1)`` overlaps, with edges snapped to
    the ``1/SNAP`` sub-grid so a viewport edge that SHOULD coincide with
    a tile boundary does not drag in a sliver neighbour under float
    drift. Tiles outside the reference window get negative / overflowing
    indices -- the grid extends over the whole plane.
    """
    re0, im0, re1, im1 = (float(x) for x in bounds)
    if not (re1 > re0 and im1 > im0):
        raise ValueError(f"degenerate viewport bounds {bounds!r}")
    rre0, rim0, rre1, rim1 = (float(x) for x in ref_bounds)
    if depth is None:
        depth = tile_depth(re1 - re0, rre1 - rre0, bias=bias)
    tw = (rre1 - rre0) / float(1 << depth)
    th = (rim1 - rim0) / float(1 << depth)
    ix0 = quantize_index(re0, rre0, tw)
    iy0 = quantize_index(im0, rim0, th)
    # exclusive upper edge: a viewport ending exactly on a boundary does
    # not include the tile that STARTS there
    ix1 = int(np.ceil(np.round((re1 - rre0) / tw * SNAP) / SNAP)) - 1
    iy1 = int(np.ceil(np.round((im1 - rim0) / th * SNAP) / SNAP)) - 1
    out = []
    for iy in range(iy0, max(iy0, iy1) + 1):
        for ix in range(ix0, max(ix0, ix1) + 1):
            out.append(TileAddress(schema=int(schema), workload=str(workload),
                                   n=int(n), max_dwell=int(max_dwell),
                                   depth=int(depth), iy=iy, ix=ix))
    return tuple(out)


class TileCache:
    """Bounded LRU over rendered dwell tiles, byte-accounted.

    Entries are keyed by :class:`TileAddress`; ``resident_bytes`` tracks
    the summed canvas ``nbytes`` and insertion evicts
    least-recently-used entries until the budget holds (an entry larger
    than the whole budget is evicted immediately -- the cache never
    exceeds ``max_bytes`` after ``put`` returns). ``invalidate()`` bumps
    the schema version: addresses minted afterwards carry the new
    version, every resident entry is orphaned and dropped, and stale
    addresses from before the bump can neither hit nor repopulate.
    """

    def __init__(self, max_bytes: int = 64 << 20, schema: int = 1):
        if max_bytes < 0:
            raise ValueError(f"max_bytes must be >= 0, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self.schema = int(schema)
        self._entries: "OrderedDict[TileAddress, np.ndarray]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self.resident_bytes = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, addr: TileAddress) -> bool:
        return addr in self._entries

    @property
    def hit_rate(self) -> float:
        lookups = self.hits + self.misses
        return self.hits / lookups if lookups else 0.0

    def get(self, addr: TileAddress) -> Optional[np.ndarray]:
        """The cached canvas for ``addr``, or None (counted as a miss).
        A hit refreshes the entry's LRU position."""
        if addr.schema != self.schema:
            self.misses += 1
            return None
        canvas = self._entries.get(addr)
        if canvas is None:
            self.misses += 1
            return None
        self._entries.move_to_end(addr)
        self.hits += 1
        return canvas

    def put(self, addr: TileAddress, canvas) -> None:
        """Insert (or refresh) one rendered tile; evicts LRU entries
        until the byte budget holds. Writes under a stale schema are
        dropped -- an in-flight render finishing after ``invalidate()``
        cannot resurrect pre-invalidation bytes."""
        if addr.schema != self.schema or self.max_bytes == 0:
            return
        canvas = np.asarray(canvas)
        old = self._entries.pop(addr, None)
        if old is not None:
            self.resident_bytes -= old.nbytes
        self._entries[addr] = canvas
        self.resident_bytes += canvas.nbytes
        while self.resident_bytes > self.max_bytes and self._entries:
            _, victim = self._entries.popitem(last=False)
            self.resident_bytes -= victim.nbytes
            self.evictions += 1

    def invalidate(self, schema: Optional[int] = None) -> int:
        """Orphan every cached tile by bumping the address schema
        version (or pinning it to an explicit ``schema``). Returns the
        number of entries dropped."""
        dropped = len(self._entries)
        self.schema = self.schema + 1 if schema is None else int(schema)
        self._entries.clear()
        self.resident_bytes = 0
        self.invalidations += dropped
        return dropped


@dataclasses.dataclass
class TileResponse:
    """One served viewport: the tile cover and where each tile came
    from. ``tiles`` maps every address in ``addresses`` (deduplicated,
    row-major) to its canvas; ``chunks`` carries the ``ChunkStats`` of
    each miss batch, cache counters filled in."""

    addresses: Tuple[TileAddress, ...]
    tiles: Dict[TileAddress, np.ndarray]
    hits: int
    misses: int
    dispatches: int
    chunks: Tuple[Any, ...] = ()
    previews: Tuple[Tuple[Tuple[TileAddress, ...], np.ndarray], ...] = ()

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class TileService:
    """Content-addressed tile serving over a ``RenderService``.

    ``service`` needs the front-door seam only (``workload_keys`` /
    ``chunk_frames`` / ``n`` / ``dispatch_planned``) -- the scripted
    ``tests.fakes.FakeService`` qualifies. Tile geometry comes from the
    served problem when the service exposes ``problem_for`` (the real
    ``RenderService``); otherwise pass ``ref_bounds=`` (one window or a
    ``{key: window}`` mapping) and ``max_dwell=``.

    ``serve`` answers a viewport from the cache where possible and
    coalesces the missing tiles into ``dispatch_planned`` batches of at
    most ``chunk_frames`` frames -- all batches are enqueued before the
    first is finalised, so miss batches overlap on the device exactly
    like the front door's pipelined batches. ``serve_progressive``
    additionally streams a coarse preview of every miss batch before
    its exact refinement (split scan, ``core.progressive``).
    """

    def __init__(self, service, *, options: Optional[TileOptions] = None,
                 cache: Optional[TileCache] = None, ref_bounds=None,
                 max_dwell: int = 0, stats_sink=None):
        self.service = service
        self.options = TileOptions() if options is None else options
        self.cache = (cache if cache is not None
                      else TileCache(max_bytes=self.options.max_bytes,
                                     schema=self.options.schema))
        self.stats_sink = stats_sink  # FrontDoorStats-like (observe_tiles)
        self._ref_bounds = ref_bounds
        self._max_dwell = int(max_dwell)

    # -- geometry -----------------------------------------------------------

    def _meta(self, key: str):
        """(ref_bounds, n, max_dwell, workload label) for one serving
        key -- from the real problem when the service exposes it, else
        from the constructor's overrides."""
        key = str(key)
        prob = None
        getter = getattr(self.service, "problem_for", None)
        if getter is not None:
            prob = getter(key)
        if prob is not None:
            ref = tuple(float(x) for x in prob.bounds)
            wl = key or str(getattr(prob.workload, "name", prob.workload))
            return ref, int(prob.n), int(prob.max_dwell), wl
        ref = self._ref_bounds
        if isinstance(ref, dict):
            ref = ref.get(key)
        if ref is None:
            raise ValueError(
                f"service exposes no problem_for({key!r}); pass ref_bounds= "
                "to TileService so tile addresses have a reference window")
        return (tuple(float(x) for x in ref), int(self.service.n),
                self._max_dwell, key)

    def addresses(self, viewport, *, key: str = "") -> Tuple[TileAddress, ...]:
        """The deduplicated tile cover of ``viewport`` under the current
        schema version (row-major order preserved)."""
        ref, n, max_dwell, wl = self._meta(key)
        addrs = tiles_for_viewport(
            viewport, ref_bounds=ref, n=n, max_dwell=max_dwell, workload=wl,
            bias=self.options.depth_bias, schema=self.cache.schema)
        return tuple(OrderedDict.fromkeys(addrs))

    def invalidate(self, schema: Optional[int] = None) -> int:
        """Bump the address schema version (see
        :meth:`TileCache.invalidate`); future addresses carry it."""
        return self.cache.invalidate(schema)

    # -- serving ------------------------------------------------------------

    def serve(self, viewport, *, key: str = "",
              tenant: str = "") -> TileResponse:
        """Serve one viewport: cache hits immediately, misses rendered
        through coalesced ``dispatch_planned`` batches and cached.
        ``tenant`` optionally attributes the miss frames (lands in
        ``ChunkStats.tenants`` like any front-door batch)."""
        ref, _, _, _ = self._meta(key)
        addrs = self.addresses(viewport, key=key)
        tiles: Dict[TileAddress, np.ndarray] = {}
        misses: List[TileAddress] = []
        for a in addrs:
            canvas = self.cache.get(a)
            if canvas is None:
                misses.append(a)
            else:
                tiles[a] = canvas
        hits = len(addrs) - len(misses)
        width = int(self.service.chunk_frames)
        batches = [misses[i:i + width] for i in range(0, len(misses), width)]
        handles = []
        for batch in batches:  # enqueue ALL before finalising any
            handles.append(self.service.dispatch_planned(
                [a.bounds(ref) for a in batch], key=key,
                tenants=(str(tenant),) * len(batch) if tenant else ()))
        chunks = []
        for batch, handle in zip(batches, handles):
            result = handle.finalize()
            canvases = to_host(result.canvases, getattr(result, "ready", None))
            for j, a in enumerate(batch):
                self.cache.put(a, canvases[j])
                tiles[a] = canvases[j]
            result.chunk.cache_hits = hits
            result.chunk.cache_misses = len(batch)
            result.chunk.cache_bytes = self.cache.resident_bytes
            chunks.append(result.chunk)
        if self.stats_sink is not None:
            self.stats_sink.observe_tiles(hits, len(misses),
                                          self.cache.resident_bytes)
        return TileResponse(addresses=addrs, tiles=tiles, hits=hits,
                            misses=len(misses), dispatches=len(batches),
                            chunks=tuple(chunks))

    def serve_progressive(self, viewport, *, key: str = "") -> Iterator[tuple]:
        """Stream one viewport progressively. Yields, in order:

        * ``("hit", address, canvas)`` per cached tile, immediately;
        * ``("preview", addresses, coarse)`` per miss batch -- the
          coarse checkpoint canvases ``[f, n, n]`` of the split scan;
        * ``("tile", address, canvas)`` per miss, the exact refined
          canvas (bit-identical to an uncached ``ask_scan`` render),
          delivered exactly once and inserted into the cache.

        Batch k's refinement is enqueued before batch k+1's coarse
        half, without a host sync in between -- on the device timeline
        the refinement of batch k overlaps the coarse pass of batch k+1.
        A refined frame that reports overflow (the split scan has no
        retry loop) is re-rendered through ``dispatch_planned``, whose
        retry machinery is exact by construction.
        """
        from repro_torch.core.progressive import dispatch_progressive_batch

        getter = getattr(self.service, "problem_for", None)
        if getter is None:
            raise RuntimeError(
                "progressive serving needs the real render service "
                "(problem_for); the scripted fakes serve via serve()")
        prob = getter(key)
        ref, _, _, _ = self._meta(key)
        addrs = self.addresses(viewport, key=key)
        misses: List[TileAddress] = []
        for a in addrs:
            canvas = self.cache.get(a)
            if canvas is None:
                misses.append(a)
            else:
                yield ("hit", a, canvas)
        width = int(self.service.chunk_frames)
        batches = [misses[i:i + width] for i in range(0, len(misses), width)]
        pending = []
        for batch in batches:
            bounds = np.asarray([a.bounds(ref) for a in batch],
                                dtype=np.float64)
            d = dispatch_progressive_batch(
                prob, bounds, checkpoint_level=self.options.checkpoint_level)
            refine = d.refine()  # enqueue refinement FIRST (overlap)
            # the preview's own event, not the refine behind it
            preview = to_host(d.preview(block_until_ready=False), d.ready)
            yield ("preview", tuple(batch), preview)
            pending.append((batch, refine))
        for batch, refine in pending:
            states, stats = refine.finalize()
            canvases = to_host(states, refine.ready)
            overflow = getattr(stats, "frame_overflow", ()) or (0,) * len(batch)
            redo = [j for j, o in enumerate(overflow) if o]
            if redo:
                exact = self.service.dispatch_planned(
                    [batch[j].bounds(ref) for j in redo],
                    key=key).finalize()
                fixed = to_host(exact.canvases, exact.ready)
                canvases = np.array(canvases)
                for i, j in enumerate(redo):
                    canvases[j] = fixed[i]
            for j, a in enumerate(batch):
                self.cache.put(a, canvases[j])
                yield ("tile", a, canvases[j])
        if self.stats_sink is not None:
            self.stats_sink.observe_tiles(
                len(addrs) - len(misses), len(misses),
                self.cache.resident_bytes)
