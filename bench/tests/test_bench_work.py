"""The subdivision replay's work, against counts worked by hand and
against the port's own stats."""

import pytest
import torch

from bench.yardstick import work


def _hand_canvas():
    """n=8, g=2, r=2, B=2: one level of four 4x4 regions, then 2x2
    leaves. Every dwell is 5 but (0, 5), on the top border of region
    (0, 1), which is 9."""
    c = torch.full((8, 8), 5, dtype=torch.int32)
    c[0, 5] = 9
    return c


def test_hand_counts():
    w = {k: float(v) for k, v in work.frame_work(
        _hand_canvas(), g=2, r=2, B=2, max_dwell=10,
        workload="mandelbrot").items()}
    # three homogeneous borders need all 16 dwells (80 steps each); the
    # fourth needs f = 5 and the witness min(9, 5) + 1 = 6
    assert w["query_flops"] == 8 * (3 * 80 + 11)
    assert w["live"] == 4 and w["query_bytes"] == 4 * 13 + 4
    # region (0, 1) splits into four 2x2 leaves: 16 pixels, dwells 15 x 5
    # + 9 = 84, all below max_dwell
    assert w["leaves"] == 4
    assert w["leaf_flops"] == 4 * 16 + 8 * 84 + 3 * 16
    assert w["leaf_bytes"] == 16 * 4 + 4 * 12


def test_max_dwell_pixels_take_no_escape_test():
    w = work.frame_work(_hand_canvas(), g=2, r=2, B=2, max_dwell=9,
                        workload="mandelbrot")
    assert float(w["leaf_flops"]) == 4 * 16 + 8 * 84 + 3 * 15


def test_border_work_witness():
    d = torch.tensor([[3, 3, 3, 3], [3, 7, 1, 3], [6, 2, 9, 6]])
    homog, steps = work.border_work(d)
    assert homog.tolist() == [True, False, False]
    # [3, 7, 1, 3]: f = 3, witnesses min(7, 3) + 1 = 4 and min(1, 3) + 1 = 2
    # [6, 2, 9, 6]: f = 6, witnesses 3 and 7
    assert steps.tolist() == [12.0, 5.0, 9.0]


@pytest.mark.parametrize("workload", ["mandelbrot", "julia"])
def test_replay_equals_the_ports_stats(workload):
    from repro_torch.workloads import FrameProblem, solve
    for b in [None, (-0.7453, 0.1127, -0.7413, 0.1167)]:
        p = FrameProblem(n=256, g=4, r=2, B=16, max_dwell=128,
                         workload=workload, bounds=b, device="cpu")
        canvas, st = solve(p, "ask_scan", safety_factor=1e9)
        w = work.frame_work(canvas, g=4, r=2, B=16, max_dwell=128,
                            workload=workload)
        assert float(w["leaves"]) == st.leaf_count
        assert float(w["live"]) == sum(st.region_counts)


def test_least_seconds_takes_the_larger_bound():
    assert work.least_seconds(67e12, 0) == 1.0
    assert work.least_seconds(0, 3.35e12) == 1.0
