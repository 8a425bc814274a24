"""The generator: the same seed gives the same frames; any seed gives the
same frames round by round, in another order."""

import itertools

from bench.yardstick import harness, traffic

CELLS = ("mandelbrot-16k.frame-zoom", "julia-16k.frame-zoom",
         "mandelbrot-16k.stream-tenants")


def _take(cell, seed, count):
    c = harness.load_cell(cell)
    return list(itertools.islice(traffic.frames(c.config, c.mix, seed), count))


def test_same_seed_same_frames():
    for cell in CELLS:
        assert _take(cell, 2**31 + 7, 200) == _take(cell, 2**31 + 7, 200)


def test_seeds_only_reorder_each_round():
    for cell in CELLS:
        k = harness.load_cell(cell).mix["tenants"]
        a, b = _take(cell, 1, 5 * k), _take(cell, 3 * 2**40 + 1, 5 * k)
        assert a != b
        for r in range(5):
            ra = sorted((f.tenant, f.depth, f.bounds) for f in a[r * k:(r + 1) * k])
            rb = sorted((f.tenant, f.depth, f.bounds) for f in b[r * k:(r + 1) * k])
            assert ra == rb


def test_trajectories_zoom_and_restart():
    c = harness.load_cell("mandelbrot-16k.frame-zoom")
    mix = c.mix
    frames = _take("mandelbrot-16k.frame-zoom", 5, mix["tenants"] * 130)
    t0 = [f for f in frames if f.tenant == 0]
    assert [f.depth for f in t0[:3]] == [0, 1, 2]
    assert t0[128].depth == 0 and t0[128].bounds == t0[0].bounds
    w = [f.bounds[2] - f.bounds[0] for f in t0[:128]]
    assert abs(w[0] / w[127] - mix["zoom_per_frame"] ** 127) < 1e-6 * w[0] / w[127]
    starts = sorted({f.depth for f in frames[:mix["tenants"]]})
    assert starts == [k * mix["depth_stride"] for k in range(mix["tenants"])]


def test_centers_lie_in_the_boundary_band():
    for cell in CELLS:
        c = harness.load_cell(cell)
        cfg = c.config
        for cx, cy in traffic.centers(cfg, c.mix):
            d = traffic.coarse_dwell(1, (cx - 1e-9, cy - 1e-9, cx + 1e-9, cy + 1e-9),
                                     cfg["max_dwell"], cfg["workload"],
                                     cfg)[0, 0]
            assert c.mix["centers"]["dwell_low"] <= d < cfg["max_dwell"]
