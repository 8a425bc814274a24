"""The port's tile service (``repro_torch.launch.tiles``) against JAX's
(``repro.launch.tiles``) on the CPU.

Addresses are content addresses, so the port must mint the same ones:
``quantize_index``, ``tile_depth``, ``tiles_for_viewport`` and
``TileAddress.bounds`` are held equal to JAX's bit for bit on random
viewports (float32 and float64 spellings, every depth bias). The cache
(LRU under byte pressure, invalidation) and the service over a scripted
``FakeService`` (``tests/fakes.py``) run the same scenarios through both
packages: the same batches, schedules, ``TileResponse`` fields, cache
counters and front-door counters. Over the real render services (n=128,
g=4, r=2, B=16, max_dwell=64) both engines' served tiles, cached and
fresh, equal JAX's and an exact ``solve_batch`` render, and the
progressive stream yields each batch's preview before its exact tiles,
previews and tiles equal to JAX's. Tolerance: exact.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from fakes import FakeService, VirtualClock
from repro.launch import frontdoor as jfd
from repro.launch import render_service as jrs
from repro.launch import tiles as jtiles
from repro.workloads import FrameProblem as JFrameProblem
from repro.workloads.options import TileOptions as JTileOptions
from repro_torch.launch import frontdoor as tfd
from repro_torch.launch import render_service as trs
from repro_torch.launch import tiles as ttiles
from repro_torch.launch.mesh import make_frames_mesh
from repro_torch.workloads import FrameProblem, TileOptions, solve_batch

torch.set_num_threads(1)

REF = (-2.0, -1.5, 1.0, 1.5)
PACKAGES = {"torch": (ttiles, TileOptions, tfd),
            "jax": (jtiles, JTileOptions, jfd)}


def _addr(mod, ix, iy=0, depth=3, schema=1):
    return mod.TileAddress(schema=schema, workload="w", n=64, max_dwell=32,
                           depth=depth, iy=iy, ix=ix)


def _key(a):
    return dataclasses.astuple(a)


# ---------------------------------------------------------------------------
# quantisation and addresses, against JAX's on random viewports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_addresses_and_bounds_equal_jax(dtype):
    """Random viewports in either float spelling, at every depth bias: the
    same tile covers, the same float64 bounds (bit for bit), the same
    indices and depths, as JAX's."""
    rng = np.random.default_rng(7)
    ref = tuple(float(x) for x in REF)
    for _ in range(300):
        x0, y0 = rng.uniform(-3.0, 2.0), rng.uniform(-2.0, 2.0)
        w = float(np.exp(rng.uniform(np.log(1e-4), np.log(4.0))))
        view = tuple(float(v) for v in np.asarray(
            (x0, y0, x0 + w, y0 + w * rng.uniform(0.5, 2.0)), dtype))
        bias = int(rng.integers(-1, 3))
        kw = dict(ref_bounds=ref, n=64, max_dwell=32, workload="w",
                  bias=bias)
        got = ttiles.tiles_for_viewport(view, **kw)
        want = jtiles.tiles_for_viewport(view, **kw)
        assert [_key(a) for a in got] == [_key(a) for a in want]
        for a in got[:4]:
            assert a.bounds(ref) == jtiles.TileAddress(*_key(a)).bounds(ref)
        assert ttiles.tile_depth(w, 3.0, bias=bias) == \
            jtiles.tile_depth(w, 3.0, bias=bias)
        tw = 3.0 / (1 << max(0, got[0].depth))
        assert ttiles.quantize_index(view[0], ref[0], tw) == \
            jtiles.quantize_index(view[0], ref[0], tw)
    assert ttiles.SNAP == jtiles.SNAP


def test_quantisation_properties():
    """Drift safety and no aliasing on the port's own functions: float32
    noise near a boundary snaps onto it, adjacent tiles never alias, and
    powers of two pick their exact grid."""
    tw = (REF[2] - REF[0]) / 8
    for frac in (0.0, 0.25, 0.999):
        x64 = REF[0] + (2 + frac) * tw
        assert ttiles.quantize_index(float(np.float32(x64)), REF[0], tw) == 2
    edge = REF[0] + 3 * tw
    for eps in (0.0, tw / (4 * ttiles.SNAP), -tw / (4 * ttiles.SNAP)):
        assert ttiles.quantize_index(edge + eps, REF[0], tw) == 3
    for depth in (1, 3, 6, 10):
        t = (REF[2] - REF[0]) / (1 << depth)
        seen = set()
        for i in range(-4, 12):
            addrs = ttiles.tiles_for_viewport(
                (REF[0] + i * t, REF[1], REF[0] + (i + 1) * t, REF[1] + t),
                ref_bounds=REF, n=64, max_dwell=32, depth=depth)
            assert len(addrs) == 1 and addrs[0] not in seen
            seen.add(addrs[0])
    rw = REF[2] - REF[0]
    for z in range(12):
        assert ttiles.tile_depth(rw / (1 << z), rw) == z
        assert ttiles.tile_depth(float(np.float32(rw / (1 << z))), rw) == z
    with pytest.raises(ValueError):
        ttiles.tile_depth(0.0, rw)
    with pytest.raises(ValueError):
        ttiles.tiles_for_viewport((0.0, 0.0, 0.0, 1.0), ref_bounds=REF, n=64,
                                  max_dwell=32)


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def test_cache_equals_jax():
    """Hits, LRU eviction under byte pressure, oversized entries and
    invalidation: the same counters and contents as JAX's cache on the
    same sequence of puts and gets."""
    tile = np.zeros((4, 4), np.int32)  # 64 bytes
    seqs = {}
    for name, (mod, _, _) in PACKAGES.items():
        cache = mod.TileCache(max_bytes=3 * tile.nbytes)
        log = []
        for i in range(3):
            cache.put(_addr(mod, i), tile + i)
        log.append(cache.get(_addr(mod, 0)) is not None)
        cache.put(_addr(mod, 3), tile + 3)
        log.append([cache.get(_addr(mod, i)) is not None for i in range(4)])
        cache.put(_addr(mod, 9), np.zeros((64, 64), np.int32))  # oversized
        log.append((len(cache), cache.resident_bytes, cache.evictions))
        stale = _addr(mod, 1)
        log.append(cache.invalidate())
        cache.put(stale, tile)
        log.append((cache.get(stale), cache.schema, len(cache)))
        log.append((cache.hits, cache.misses, cache.invalidations,
                    cache.hit_rate))
        seqs[name] = log
    assert seqs["torch"] == seqs["jax"]
    assert seqs["torch"][1] == [True, False, True, True]
    with pytest.raises(ValueError):
        ttiles.TileCache(max_bytes=-1)


def test_tile_options_match_jax():
    assert [(f.name, f.default) for f in dataclasses.fields(TileOptions)] \
        == [(f.name, f.default) for f in dataclasses.fields(JTileOptions)]
    for bad in (dict(max_bytes=-1), dict(schema=-1)):
        with pytest.raises(ValueError) as want:
            JTileOptions(**bad)
        with pytest.raises(ValueError) as got:
            TileOptions(**bad)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# the service over the scripted fake
# ---------------------------------------------------------------------------

def _fake_tiles(pkg, **kw):
    mod, opts, fd = PACKAGES[pkg]
    svc = FakeService(keys=("",), chunk_frames=kw.pop("chunk_frames", 4),
                      n=8, clock=VirtualClock())
    if "depth_bias" in kw:
        kw["options"] = opts(depth_bias=kw.pop("depth_bias"))
    sink = fd.FrontDoorStats()
    return mod.TileService(svc, ref_bounds=REF, max_dwell=32,
                           stats_sink=sink, **kw), svc, sink


def _response(r):
    return ([_key(a) for a in r.addresses], r.hits, r.misses, r.dispatches,
            sorted((_key(a), c.tobytes()) for a, c in r.tiles.items()),
            [vars(c) for c in r.chunks], r.hit_rate)


@pytest.mark.parametrize("scenario", ["repeat", "overlap", "coalesce",
                                      "invalidate"])
def test_service_on_fake_equals_jax(scenario):
    """Miss then hit, overlapping pans (exactly-once rendering), 9 misses
    coalesced into [4, 4, 1] batches all enqueued before the first
    finalize, and a schema bump forcing re-renders: the port's responses,
    batches (with their virtual times), cache and front-door counters
    equal JAX's."""
    v1 = (REF[0], REF[1], REF[0] + 0.75, REF[1] + 0.75)
    views = {"repeat": [v1, v1],
             "overlap": [v1, (REF[0] + 0.375, REF[1], REF[0] + 1.125,
                              REF[1] + 0.75)],
             "coalesce": [(REF[0], REF[1], REF[0] + 0.9, REF[1] + 0.9)],
             "invalidate": [v1, None, v1]}[scenario]
    kw = dict(depth_bias=2) if scenario == "coalesce" else {}
    runs = {}
    for pkg in PACKAGES:
        ts, svc, sink = _fake_tiles(pkg, **kw)
        out = []
        for v in views:
            if v is None:
                out.append(ts.invalidate())
            else:
                out.append(_response(ts.serve(v)))
        runs[pkg] = (out, [dataclasses.astuple(b) for b in svc.batches],
                     vars(sink), ts.cache.resident_bytes)
    assert runs["torch"] == runs["jax"]
    out, batches, sink, resident = runs["torch"]
    if scenario == "repeat":
        assert out[1][1] == len(out[1][0]) and out[1][3] == 0
        assert sink["tile_hits"] == sink["tile_misses"] == len(out[0][0])
    if scenario == "overlap":
        dispatched = [b for rec in batches for b in rec[6]]
        assert len(dispatched) == len(set(dispatched)) and out[1][1] > 0
    if scenario == "coalesce":
        assert [b[2] for b in batches] == [4, 4, 1]
        assert [b[3] for b in batches] == [0.0, 0.0, 0.0]  # enqueued at once
        assert [b[4] for b in batches] == [4.0, 8.0, 9.0]
    if scenario == "invalidate":
        assert out[2][1] == 0 and all(a[0] == 2 for a in out[2][0])


# ---------------------------------------------------------------------------
# the real services
# ---------------------------------------------------------------------------

def _real(engine="ask_scan", chunk=4, dwell=64):
    kw = dict(n=128, g=4, r=2, B=16, max_dwell=dwell)
    jmesh = jax.make_mesh((1,), ("frames",), axis_types=(AxisType.Auto,))
    jp, tp = JFrameProblem(**kw, backend="jnp"), FrameProblem(**kw,
                                                              device="cpu")
    return (jrs.RenderService(jp, mesh=jmesh, chunk_frames=chunk,
                              feedback=True, engine=engine),
            trs.RenderService(tp, mesh=make_frames_mesh(device="cpu"),
                              chunk_frames=chunk, feedback=True,
                              engine=engine), tp)


VIEW = (-1.0, -0.25, -0.5, 0.25)


@pytest.mark.parametrize("engine", ["ask_scan", "ask_pooled"])
def test_cached_tiles_equal_jax_and_exact_render(engine):
    """Served twice (fresh, then from the cache): every tile equals JAX's
    and an exact ``solve_batch`` render of its address's bounds."""
    jsvc, tsvc, prob = _real(engine)
    got = [ttiles.TileService(tsvc, options=TileOptions(depth_bias=1))]
    want = [jtiles.TileService(jsvc, options=JTileOptions(depth_bias=1))]
    r1, r2 = got[0].serve(VIEW), got[0].serve(VIEW)
    w1, w2 = want[0].serve(VIEW), want[0].serve(VIEW)
    assert [_key(a) for a in r1.addresses] == [_key(a) for a in w1.addresses]
    assert (r1.misses, r1.dispatches, r2.hits, r2.misses) == \
        (w1.misses, w1.dispatches, w2.hits, w2.misses) == \
        (len(r1.addresses), -(-len(r1.addresses) // 4), len(r1.addresses), 0)
    for c, w in zip(r1.chunks, w1.chunks):
        assert {k: v for k, v in vars(c).items()
                if k not in ("dispatch_s", "fetch_s")} == \
            {k: v for k, v in vars(w).items()
             if k not in ("dispatch_s", "fetch_s")}
    ref = tuple(float(x) for x in prob.bounds)
    fresh, _ = solve_batch(prob, np.asarray(
        [a.bounds(ref) for a in r1.addresses]), p_subdiv=1.0)
    for j, a in enumerate(r1.addresses):
        b = jtiles.TileAddress(*_key(a))
        assert isinstance(r1.tiles[a], np.ndarray)
        np.testing.assert_array_equal(r1.tiles[a], fresh[j].numpy())
        np.testing.assert_array_equal(r2.tiles[a], fresh[j].numpy())
        np.testing.assert_array_equal(r1.tiles[a], np.asarray(w1.tiles[b]))


def test_progressive_serve_equals_jax():
    """The progressive stream, chunk 2: per miss batch a preview before
    its exact tiles (the refine enqueued before the preview is read),
    every preview and tile equal to JAX's, the tiles exact and delivered
    once; a second pass is all cache hits. The scripted fake, which has
    no ``problem_for``, refuses progressive serving."""
    jsvc, tsvc, prob = _real(chunk=2, dwell=65)
    opts = dict(progressive=True, depth_bias=1)
    ts = ttiles.TileService(tsvc, options=TileOptions(**opts))
    events = list(ts.serve_progressive(VIEW))
    want = list(jtiles.TileService(jsvc, options=JTileOptions(**opts))
                .serve_progressive(VIEW))
    kinds = [e[0] for e in events]
    assert kinds == [e[0] for e in want]
    assert kinds.count("preview") >= 2 and "hit" not in kinds
    previewed = set()
    for (k, a, c), (_, wa, wc) in zip(events, want):
        if k == "preview":
            assert [_key(x) for x in a] == [_key(x) for x in wa]
            assert c.shape == (len(a), 128, 128)
            previewed.update(a)
        else:  # each batch's preview comes before its own exact tiles
            assert _key(a) == _key(wa) and a in previewed
        assert isinstance(c, np.ndarray)
        np.testing.assert_array_equal(c, np.asarray(wc))
    tiles = {a: c for k, a, c in events if k == "tile"}
    addrs = ts.addresses(VIEW)
    assert set(tiles) == set(addrs) and len(tiles) == len(addrs)
    ref = tuple(float(x) for x in prob.bounds)
    fresh, _ = solve_batch(prob, np.asarray([a.bounds(ref) for a in addrs]),
                           p_subdiv=1.0)
    for j, a in enumerate(addrs):
        np.testing.assert_array_equal(tiles[a], fresh[j].numpy())
    again = [e[0] for e in ts.serve_progressive(VIEW)]
    assert set(again) == {"hit"} and len(again) == len(addrs)
    fake, _, _ = _fake_tiles("torch")
    with pytest.raises(RuntimeError, match="problem_for"):
        list(fake.serve_progressive(VIEW))
