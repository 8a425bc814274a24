"""The plain reference against the port's CPU path at n=256, both
workloads, both window spellings; and its controls fail."""

import itertools

import numpy as np
import pytest

from bench.reference import mariani_silver as ms
from bench.yardstick import traffic

WINDOWS = {
    "mandelbrot": [(-1.5, -1.0, 0.5, 1.0), (-0.7453, 0.1127, -0.7413, 0.1167),
                   (-0.1011, 0.9563, -0.1001, 0.9573)],
    "julia": [(-1.6, -1.6, 1.6, 1.6), (-0.1625, 0.1875, -0.0625, 0.2875),
              (-0.5425, 0.3075, -0.5325, 0.3175)],
}
P = dict(c=(-0.7269, 0.1889))


@pytest.mark.parametrize("workload", sorted(WINDOWS))
def test_reference_equals_the_port(workload):
    from repro_torch.workloads import FrameProblem, solve, solve_batch
    for b in WINDOWS[workload]:
        p = FrameProblem(n=256, g=4, r=2, B=16, max_dwell=128,
                         workload=workload, bounds=b, device="cpu")
        canvas, _ = solve(p, "ask_scan", safety_factor=1e9)
        ref = ms.render(256, 4, 2, 16, 128, workload, b, "static", params=P)
        assert int((ref != canvas).sum()) == 0
        batch, _ = solve_batch(p, np.asarray([b], np.float32),
                               safety_factor=1e9)
        ref = ms.render(256, 4, 2, 16, 128, workload, b, "traced", params=P)
        assert int((ref != batch[0]).sum()) == 0


def test_spellings_differ_on_a_deep_window():
    b = WINDOWS["mandelbrot"][2]
    a = ms.render(256, 4, 2, 16, 128, "mandelbrot", b, "static")
    t = ms.render(256, 4, 2, 16, 128, "mandelbrot", b, "traced")
    assert int((a != t).sum()) > 0


@pytest.mark.parametrize("variant", ["bf16", "fmad"])
@pytest.mark.parametrize("workload", sorted(WINDOWS))
def test_controls_fail_the_check(workload, variant):
    """The control, the reference below the contract in the program's
    place, differs from the reference on every window tried."""
    for b in WINDOWS[workload]:
        ref = ms.render(256, 4, 2, 16, 128, workload, b, "static", params=P)
        ctl = ms.render(256, 4, 2, 16, 128, workload, b, "static", params=P,
                        variant=variant)
        assert int((ctl != ref).sum()) > 0


def test_reference_blocks_do_not_change_it():
    b = WINDOWS["mandelbrot"][1]
    a = ms.render(256, 4, 2, 16, 128, "mandelbrot", b, "static")
    small = ms.render(256, 4, 2, 16, 128, "mandelbrot", b, "static",
                      points=1000)
    assert bool((a == small).all())


def test_reference_on_the_traffic_windows():
    cfg = dict(workload="mandelbrot", max_dwell=128,
               bounds=(-1.5, -1.0, 0.5, 1.0))
    mix = dict(centers=dict(coarse_n=64, dwell_low=32), tenants=2,
               depth_stride=40, frames=128, zoom_per_frame=1.05)
    from repro_torch.workloads import FrameProblem, solve
    for f in itertools.islice(traffic.frames(cfg, mix, 11), 4):
        p = FrameProblem(n=256, g=4, r=2, B=16, max_dwell=128,
                         bounds=f.bounds, device="cpu")
        canvas, _ = solve(p, "ask_scan", safety_factor=1e9)
        ref = ms.render(256, 4, 2, 16, 128, "mandelbrot", f.bounds, "static")
        assert int((ref != canvas).sum()) == 0
