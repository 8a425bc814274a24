"""A whole run on the CPU, at a size a test can hold, with the timed path
broken underneath: the check has to come out false for each fault the
cells can have, and true with nothing broken."""

import time

import pytest

from bench.yardstick import entries, harness


def _cell(name):
    cell = harness.load_cell(name)
    return cell._replace(config=dict(cell.config, n=256, B=16, max_dwell=128),
                         mix=dict(cell.mix, warm_rounds=1))


def _run(name, seconds=1.5, entry_factory=None):
    return harness.run(_cell(name), 2**33 + 5, seconds, False, device="cpu",
                       process_start=time.time(), log=lambda m: None,
                       entry_factory=entry_factory)


@pytest.fixture
def unchanged_leaves(monkeypatch):
    """A leaves the canvas as it found it."""
    from repro_torch.workloads import FrameProblem
    monkeypatch.setattr(FrameProblem, "leaf_step",
                        lambda self, state, *a, **k: state)
    monkeypatch.setattr(FrameProblem, "pooled_leaf_step",
                        lambda self, state, *a, **k: state)


@pytest.fixture
def altered_leaf(monkeypatch):
    """A's first leaf pixel of every frame is off by one."""
    from repro_torch.workloads import FrameProblem
    leaf, pooled = FrameProblem.leaf_step, FrameProblem.pooled_leaf_step

    def single(self, state, coords, valid, *, level):
        state = leaf(self, state, coords, valid, level=level)
        if bool(valid[0]):
            side = self.region_side(level)
            state[coords[0, 0] * side + 1, coords[0, 1] * side + 1] += 1
        return state

    def many(self, state, rows, valid, *, level, planes):
        state = pooled(self, state, rows, valid, level=level, planes=planes)
        side = self.region_side(level)
        for j in range(rows.shape[0]):
            if bool(valid[j]):
                f, cy, cx = (int(v) for v in rows[j])
                state[f * self.n + cy * side + 1, cx * side + 1] += 1
        return state

    monkeypatch.setattr(FrameProblem, "leaf_step", single)
    monkeypatch.setattr(FrameProblem, "pooled_leaf_step", many)


class HalfChunk(entries.load("stream")):
    """Half of each chunk's frames left out: their canvases never
    written."""

    def request(self):
        done = super().request()
        for c in done.canvases[len(done.canvases) // 2:]:
            c.zero_()
        return done


@pytest.mark.parametrize("cell", ["mandelbrot-16k.frame-zoom",
                                  "julia-16k.frame-zoom",
                                  "mandelbrot-16k.stream-tenants"])
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["frames_probed"]["value"] == res["attempted"]


@pytest.mark.parametrize("cell", ["mandelbrot-16k.frame-zoom",
                                  "mandelbrot-16k.stream-tenants"])
def test_state_left_unchanged_is_caught(cell, unchanged_leaves):
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["mismatched_pixels"]["value"] > 0


@pytest.mark.parametrize("cell", ["julia-16k.frame-zoom",
                                  "mandelbrot-16k.stream-tenants"])
def test_altered_answer_is_caught(cell, altered_leaf):
    res = _run(cell)
    assert not res["correct"]
    assert res["checks"]["mismatched_frames"]["value"] > 0


def test_half_of_a_chunk_left_out_is_caught():
    res = _run("mandelbrot-16k.stream-tenants", seconds=3.0,
               entry_factory=HalfChunk)
    assert not res["correct"]
    assert res["checks"]["probe_mismatches"]["value"] > 0
    assert res["failed"] > 0


def test_dropped_regions_fail_the_run():
    class Dropping(entries.load("frame")):
        def request(self):
            return super().request()._replace(dropped=3)

    res = _run("mandelbrot-16k.frame-zoom", entry_factory=Dropping)
    assert not res["correct"]
    assert res["failed"] == res["attempted"]
    assert res["metrics"]["mpix_per_s"]["value"] == 0.0


@pytest.mark.parametrize("variant", ["bf16", "fmad"])
@pytest.mark.parametrize("cell", ["mandelbrot-16k.frame-zoom",
                                  "julia-16k.frame-zoom",
                                  "mandelbrot-16k.stream-tenants"])
def test_control_fails_the_harness_check(cell, variant):
    """The control (``bench/control.py``): the reference below f32 in the
    program's place, through the harness's own run and comparison."""
    from bench.control import control_entry
    res = _run(cell, seconds=1e-3, entry_factory=control_entry(variant))
    assert not res["correct"]
    assert res["checks"]["mismatched_pixels"]["value"] > 0
    assert res["checks"]["frames_compared"]["value"] == 1


class _Trace:
    """A recording session on the CPU, read as a trace that shows every
    kernel role of the entry."""

    @staticmethod
    def read(prof, chips):
        from bench.yardstick import trace
        names = [k for e in ("frame", "stream")
                 for ks in entries.load(e).kernels.values() for k in ks]
        return trace.Trace({k: 1e-3 for k in names}, {k: 1 for k in names},
                           0.5, 1.0, {})


@pytest.fixture
def cpu_trace(monkeypatch):
    import contextlib
    from bench.yardstick import trace
    monkeypatch.setattr(trace, "read", _Trace.read)
    monkeypatch.setattr(trace, "recording", contextlib.nullcontext)


def _traced(name, entry_factory=None):
    return harness.run(_cell(name), 2**33 + 9, 1.5, True, device="cpu",
                       process_start=time.time(), log=lambda m: None,
                       entry_factory=entry_factory)


@pytest.mark.parametrize("cell", ["mandelbrot-16k.frame-zoom",
                                  "mandelbrot-16k.stream-tenants"])
def test_traced_work_is_read_off_matching_canvases(cell, cpu_trace):
    res = _traced(cell)
    assert res["correct"], res["checks"]
    assert res["checks"]["rerender_mismatches"]["value"] == 0
    assert res["checks"]["frames_rerendered"]["value"] == res["attempted"]
    assert "roofline_pct.region_dwell" in res["metrics"] or \
        "roofline_pct.region_dwell_pooled" in res["metrics"]


@pytest.mark.parametrize("entry", ["frame", "stream"])
def test_a_rerender_that_differs_fails_the_traced_run(entry, cpu_trace):
    class Off(entries.load(entry)):
        def rerender(self, frames):
            for canvas in super().rerender(frames):
                yield canvas + 1

    cell = {"frame": "julia-16k.frame-zoom",
            "stream": "mandelbrot-16k.stream-tenants"}[entry]
    res = _traced(cell, entry_factory=Off)
    assert not res["correct"]
    assert res["checks"]["rerender_mismatches"]["value"] > 0
