"""The port's split scan (``repro_torch.core.progressive``) against JAX's
(``repro.core.progressive``) on the CPU, mirroring tests/test_progressive.py.

Single frame and batched, at checkpoint levels None, 0, 1 and tau (and a
request past tau, clamped to it), at worst-case capacities and at
capacities small enough to drop regions: the preview equals
JAX's pixel for pixel, the refined canvas equals JAX's and the port's own
unsplit engine (``run_ask_scan`` / ``run_ask_scan_batch``) at the same
capacities, and every ``ASKStats`` field equals JAX's
(``kernel_launches`` 2). JAX runs its ``jnp`` kernels (the lowering its
own tests hold the Pallas kernels to; it keeps the compiles short), the
port its plain versions. Tolerance: exact. Sizes: n=128, g=4, r=2,
B=8 (two levels, so that the checkpoints differ), max_dwell=32.
"""

import numpy as np
import pytest
import torch

from repro.core import progressive as jprog
from repro.workloads import FrameProblem as JFrameProblem
from repro_torch.core import ask, progressive
from repro_torch.workloads import FrameProblem

torch.set_num_threads(1)

WORKLOADS = ("mandelbrot", "julia", "burning_ship", "multibrot")
SMALL = dict(n=128, g=4, r=2, B=8, max_dwell=32)
CHECKPOINTS = (None, 0, 1, 2, 9)  # tau = 2; 9 clamps to it
SIZING = {"worst": dict(safety_factor=1e9),
          "drops": dict(capacities=(12, 24, 40))}
STAT_FIELDS = ("levels", "kernel_launches", "region_counts", "leaf_count",
               "overflow_dropped", "frame_overflow", "frame_leaf_counts",
               "olt_caps", "ring_rows")


def _both(workload):
    return (JFrameProblem(**SMALL, workload=workload, backend="jnp"),
            FrameProblem(**SMALL, workload=workload, device="cpu"))


def _frames(workload):
    """Three windows of one workload: its default window, a zoom into it
    and a window far outside the set."""
    re0, im0, re1, im1 = FrameProblem(n=64, g=4, B=16, workload=workload,
                                      device="cpu").bounds
    cx, cy, w = (re0 + re1) / 2, (im0 + im1) / 2, re1 - re0
    return np.asarray([(re0, im0, re1, im1),
                       (cx - w / 8, cy - w / 8, cx + w / 8, cy + w / 8),
                       (40.0, 40.0, 41.0, 41.0)], np.float32)


def _same_stats(got, want):
    for f in STAT_FIELDS:
        assert getattr(got, f) == getattr(want, f), f


def test_checkpoint_for_matches_jax():
    for kw in (SMALL, dict(n=64, g=4, r=2, B=16, max_dwell=16),
               dict(n=64, g=2, r=2, B=64, max_dwell=16)):
        jp, tp = JFrameProblem(**kw), FrameProblem(**kw, device="cpu")
        for k in (None, 0, 1, 2, 3, 99):
            assert progressive.checkpoint_for(tp, k) == \
                jprog.checkpoint_for(jp, k)
        for fn, p in ((progressive.checkpoint_for, tp),
                      (jprog.checkpoint_for, jp)):
            with pytest.raises(ValueError, match=">= 0"):
                fn(p, -1)


@pytest.mark.parametrize("sizing", SIZING)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_split_scan_matches_jax(workload, sizing):
    """One frame: preview, refined canvas and stats equal JAX's at every
    checkpoint; the canvas equals the unsplit run_ask_scan's."""
    jp, tp = _both(workload)
    kw = SIZING[sizing]
    unsplit, ust = ask.run_ask_scan(tp, **kw)
    for k in CHECKPOINTS:
        jpre, jstate, jst = jprog.run_ask_scan_progressive(
            jp, checkpoint_level=k, **kw)
        pre, state, st = progressive.run_ask_scan_progressive(
            tp, checkpoint_level=k, **kw)
        assert pre.dtype == torch.int32 and pre.shape == (128, 128)
        np.testing.assert_array_equal(pre.numpy(), np.asarray(jpre))
        np.testing.assert_array_equal(state.numpy(), np.asarray(jstate))
        _same_stats(st, jst)
        assert torch.equal(state, unsplit)
        assert st.kernel_launches == 2
        assert (st.region_counts, st.leaf_count, st.overflow_dropped) == \
            (ust.region_counts, ust.leaf_count, ust.overflow_dropped)
    if sizing == "drops":
        assert st.overflow_dropped > 0
    if sizing == "worst":
        assert st.overflow_dropped == 0


@pytest.mark.parametrize("sizing", SIZING)
@pytest.mark.parametrize("workload", WORKLOADS)
def test_split_batch_matches_jax(workload, sizing):
    """A batch: the previews (pooled Q and T on frame-tagged rows) and the
    refined canvases and stats equal JAX's vmapped halves at every
    checkpoint, and the canvases the unsplit batched scan's."""
    jp, tp = _both(workload)
    b = _frames(workload)
    kw = SIZING[sizing]
    unsplit, ust = ask.run_ask_scan_batch(tp, b, **kw)
    for k in CHECKPOINTS:
        jd = jprog.dispatch_progressive_batch(jp, b, checkpoint_level=k, **kw)
        jr = jd.refine()
        jpre = jd.preview()
        jstates, jst = jr.finalize()
        d = progressive.dispatch_progressive_batch(tp, b, checkpoint_level=k,
                                                   **kw)
        assert d.checkpoint == jd.checkpoint
        r = d.refine()  # before the preview, as a pipelined caller does
        pre = d.preview()
        states, st = r.finalize()
        assert pre.shape == (3, 128, 128)
        np.testing.assert_array_equal(pre.numpy(), np.asarray(jpre))
        np.testing.assert_array_equal(states.numpy(), np.asarray(jstates))
        _same_stats(st, jst)
        assert torch.equal(states, unsplit)
        assert st.kernel_launches == 2
        assert (st.region_counts, st.frame_overflow) == \
            (ust.region_counts, ust.frame_overflow)
    if sizing == "drops":
        assert st.overflow_dropped > 0


def test_preview_paints_the_live_set():
    """At the checkpoint every region still live is painted with its
    border's first dwell; the preview and the scan's canvas differ only
    there, and the refined canvas is not painted."""
    tp = FrameProblem(**SMALL, device="cpu")
    d = progressive.dispatch_progressive(tp, checkpoint_level=1,
                                         safety_factor=1e9)
    pre = d.preview()
    state, _ = d.refine().finalize()
    exact, _ = ask.run_ask_scan(tp, safety_factor=1e9)
    assert torch.equal(state, exact)
    painted = pre != state
    assert painted.any() and (pre > 0).all()


def test_refine_and_finalize_are_one_shot():
    tp = FrameProblem(**SMALL, device="cpu")
    for d in (progressive.dispatch_progressive(tp),
              progressive.dispatch_progressive_batch(tp, _frames("julia"))):
        r = d.refine()
        with pytest.raises(RuntimeError, match="one-shot"):
            d.refine()
        r.finalize()
        with pytest.raises(RuntimeError, match="one-shot"):
            r.finalize()


def test_dispatches_refined_out_of_order():
    """Two frames' coarse halves in flight, refined in reverse order: each
    equals its own unsplit canvas."""
    a = FrameProblem(**SMALL, device="cpu")
    b = FrameProblem(**SMALL, bounds=(-0.8, 0.0, -0.6, 0.2), device="cpu")
    da = progressive.dispatch_progressive(a, safety_factor=1e9)
    db = progressive.dispatch_progressive(b, safety_factor=1e9)
    sb, _ = db.refine().finalize()
    sa, _ = da.refine().finalize()
    assert torch.equal(sa, ask.run_ask_scan(a, safety_factor=1e9)[0])
    assert torch.equal(sb, ask.run_ask_scan(b, safety_factor=1e9)[0])


def test_exports_match_jax():
    assert sorted(progressive.__all__) == sorted(jprog.__all__)
