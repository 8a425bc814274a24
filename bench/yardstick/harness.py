"""One run of one cell: set-up, the measured window, the check against
the plain reference, and the result's line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name in ``BENCHMARK.json``:
``bench/configs/<config>.json``, ``bench/traffic/<traffic>.json`` and
``bench/metrics/<metric>.py`` (a ``read(ctx)`` that returns the value, or
None when the run holds nothing for it to read); a configuration's
workload names its escape arithmetic, ``bench/reference/kinds/<kind>.py``,
and a mix its entry, ``bench/entries/<entry>.py``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import time
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from bench.reference import mariani_silver
from bench.yardstick import entries, named, trace, traffic, work

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


# checks whose limit is a least value; the others' is a most
AT_LEAST = ("frames_compared", "frames_probed", "frames_rerendered")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    config = json.loads((BENCH / "configs" / f"{cell['config']}.json")
                        .read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                     .read_text())

    def mine(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    reported = {m["name"] for m in e2e}
    layers = [m for m in bench["per_layer"]
              if mine(m) and m["moves"] in reported]
    return Cell(name, int(cell["chips"]), config, mix, e2e, layers)


def reader(metric: str) -> Callable:
    """The ``read`` function of ``bench/metrics/<metric>.py``."""
    return named.load("metrics", metric).read


class Context(NamedTuple):
    """What a per-layer reader reads."""

    trace: trace.Trace
    work: dict  # summed ``work.frame_work`` over the window's frames
    frames: int
    chunks: list  # the service's ChunkStats of the window's requests
    window_s: float


def _own(canvas: torch.Tensor) -> torch.Tensor:
    """The canvas in storage of its own: a frame kept for the check does
    not hold its whole chunk's canvases."""
    whole = canvas.untyped_storage().nbytes()
    return canvas if whole == canvas.numel() * canvas.element_size() \
        else canvas.clone()


def _sample(mix: dict, seed: int):
    """A reservoir of the window's frames drawn from the seed."""
    rng = traffic.rng(seed, 1)
    k = int(mix["check"]["sampled"])
    kept, seen = [], 0

    def offer(frame, canvas):
        nonlocal seen
        seen += 1
        if len(kept) < k:
            kept.append((frame, _own(canvas)))
        else:
            j = int(rng.integers(seen))
            if j < k:
                kept[j] = (frame, _own(canvas))

    return kept, offer


def _probes(config: dict, mix: dict, seed: int, device) -> tuple:
    """(ys, xs) of ``mix["check"]["probes"]`` pixels on the borders of the
    g x g level-0 regions, drawn from the seed: every frame's canvas
    holds their exact dwells, so every frame of the window is checked
    there."""
    rng = traffic.rng(seed, 2)
    k, n, g = int(mix["check"]["probes"]), config["n"], config["g"]
    side = n // g
    line = rng.integers(g, size=k) * side + rng.choice([0, side - 1], size=k)
    along = rng.integers(n, size=k)
    rows = rng.random(k) < 0.5
    return (torch.as_tensor(np.where(rows, line, along), device=device),
            torch.as_tensor(np.where(rows, along, line), device=device))


def _p95(values) -> float:
    if len(values) < 2:
        return float(values[0]) if values else float("nan")
    return statistics.quantiles(values, n=20)[18]


class Window(NamedTuple):
    """What the measured window left."""

    lat_ms: list  # each request's wall
    frames: list  # each frame, in order
    chunks: list  # the service's ChunkStats, a request
    pixels: int  # of the frames completed whole
    failed: int
    dropped: int
    kept: list  # (frame, canvas) kept for the check
    probed: torch.Tensor  # [frames, probes] canvas values
    seconds: float
    setup_s: float


def _window(entry, cell: Cell, seed: int, seconds: float, probes,
            process_start: float) -> Window:
    """Closed-loop requests for ``seconds``, marked ``trace.WINDOW``."""
    kept, offer = _sample(cell.mix, seed)
    ys, xs = probes
    probed, lat_ms, chunks, frames = [], [], [], []
    failed = pixels = dropped = 0
    n2 = cell.config["n"] ** 2
    with torch.profiler.record_function(trace.WINDOW):
        t_start = time.perf_counter()
        setup_s = time.time() - process_start
        t_end = t_start
        while time.perf_counter() < t_start + seconds:
            t0 = time.perf_counter()
            done = entry.request()
            t_end = time.perf_counter()
            lat_ms.append((t_end - t0) * 1e3)
            chunks.append(done.chunk)
            frames.extend(done.frames)
            dropped += done.dropped
            if done.dropped:
                failed += len(done.frames)
            else:
                pixels += n2 * len(done.frames)
            for f, c in zip(done.frames, done.canvases):
                offer(f, c)
            probed.append(torch.stack([c[ys, xs] for c in done.canvases]))
    return Window(lat_ms, frames, [c for c in chunks if c is not None],
                  pixels, failed, dropped, kept, torch.cat(probed).cpu(),
                  t_end - t_start, setup_s)


def _layers(cell: Cell, entry, prof, win: Window, probes, log) -> tuple:
    """(per-layer values, busy seconds, breakdown, rerender check) of a
    traced window. The work is read off each window frame's canvas made
    again by the entry's own path; each such canvas has to hold what the
    window's held at its probes, and the kept frame's whole."""
    t0 = time.perf_counter()
    tr = trace.read(prof, cell.chips)
    log(f"trace read in {time.perf_counter() - t0:.2f} s")
    missing = sorted(role for role, names in entry.kernels.items()
                     if not any(tr.counts.get(k) for k in names))
    if missing:
        raise RuntimeError(f"the traced window shows no kernel of {missing}: "
                           f"{sorted(tr.counts)}")
    t0 = time.perf_counter()
    cfg = cell.config
    ys, xs = probes
    kept = {f.index: c for f, c in win.kept}
    totals: dict = {}
    differ = count = 0
    for i, canvas in enumerate(entry.rerender(win.frames)):
        frame = win.frames[i]
        differ += int((canvas[ys, xs].cpu() != win.probed[i]).sum())
        if frame.index in kept:
            differ += int((canvas != kept[frame.index]).sum())
        w = work.frame_work(canvas, g=cfg["g"], r=cfg["r"], B=cfg["B"],
                            max_dwell=cfg["max_dwell"],
                            workload=cfg["workload"])
        for k, v in w.items():
            totals[k] = totals.get(k, 0) + v
        count += 1
    log(f"work of {count} frames read off their canvases, made again, in "
        f"{time.perf_counter() - t0:.2f} s; {differ} pixels differ from "
        "the window's")
    ctx = Context(tr, {k: float(v) for k, v in totals.items()},
                  len(win.frames), win.chunks, win.seconds)
    values = {}
    for m in cell.per_layer:
        value = reader(m["name"])(ctx)
        if value is not None:
            values[m["name"]] = dict(value=value, unit=m["unit"])
    log("kernels: " + json.dumps(trace.top(tr.device_s, 20)))
    rerendered = dict(rerender_mismatches=dict(value=differ, limit=0),
                      frames_rerendered=dict(value=count,
                                             limit=len(win.frames)))
    return values, tr.busy_s, dict(device_ops=trace.top(tr.device_s),
                                   idle_gaps=trace.top(tr.idle_by_host)), \
        rerendered


def run(cell: Cell, seed: int, seconds: float, traced: bool, *,
        device="cuda", process_start: float, log=print,
        entry_factory=None) -> dict:
    """One run; returns the result's line (a dict). A traced run's window
    is at most the mix's ``trace_seconds``: its trace is read event by
    event, and a stream's eager launches make many."""
    config, mix = cell.config, cell.mix
    if traced:
        seconds = min(seconds, float(mix.get("trace_seconds", seconds)))
    on_card = torch.device(device).type == "cuda"

    def mark(what):
        log(f"set-up: {what} at {time.time() - process_start:.3f} s")

    mark("harness loaded")
    entry = (entry_factory or entries.load(mix["entry"]))(
        config, mix, device, cell.chips)
    entry.start(traffic.frames(config, mix, seed))
    probes = _probes(config, mix, seed, device)
    mark("entry made, card up")
    with trace.recording() if traced else contextlib.nullcontext() as prof:
        warm = len(entry.request().frames)
        mark("first request (kernels loaded, graph captured)")
        while warm < traffic.warm_frames(mix):
            warm += len(entry.request().frames)
        if on_card:
            torch.cuda.synchronize()
        mark(f"{warm} warm frames")
        win = _window(entry, cell, seed, seconds, probes, process_start)
    peak = 0
    if on_card:
        torch.cuda.synchronize()
        peak = max(torch.cuda.max_memory_allocated(d)
                   for d in range(cell.chips))
    log(f"window: {len(win.lat_ms)} requests, {len(win.frames)} frames in "
        f"{win.seconds:.3f} s; set-up {win.setup_s:.3f} s")
    if traced:
        metrics, busy_s, breakdown, rerendered = _layers(
            cell, entry, prof, win, probes, log)
    entry.close()
    del entry

    spelling = entries.load(mix["entry"]).spelling
    checks = check(config, win.kept, win.dropped, spelling, log)
    want = mariani_silver.points(
        config["n"], config["max_dwell"], config["workload"],
        [f.bounds for f in win.frames], spelling, *probes, params=config,
        device=device).cpu()
    bad_frames = int((win.probed != want).any(1).sum())
    checks["probe_mismatches"] = dict(
        value=int((win.probed != want).sum()), limit=0)
    checks["frames_probed"] = dict(value=len(win.frames), limit=1)
    if traced:
        checks.update(rerendered)
    log(f"check: {bad_frames} of {len(win.frames)} frames differ at some of "
        f"{probes[0].numel()} border pixels")
    failed = win.failed + max(checks["mismatched_frames"]["value"], bad_frames)
    correct = all(c["value"] >= c["limit"] if k in AT_LEAST else
                  c["value"] <= c["limit"] for k, c in checks.items())

    if not traced:
        values = dict(mpix_per_s=win.pixels / win.seconds / 1e6,
                      request_ms_p95=_p95(win.lat_ms), setup_s=win.setup_s)
        metrics = {m["name"]: dict(value=values[m["name"]], unit=m["unit"])
                   for m in cell.end_to_end}
    dev = dict(platform="gpu" if on_card else "cpu",
               kind=torch.cuda.get_device_name(0) if on_card else "cpu",
               count=cell.chips, memory_peak_bytes=peak)
    result = dict(correct=bool(correct), attempted=len(win.frames),
                  failed=failed, metrics=metrics, device=dev)
    if traced:
        dev.update(busy_s=busy_s, window_s=win.seconds)
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def check(config: dict, frames, dropped: int, spelling: str, log) -> dict:
    """Every pixel of each kept frame against the plain reference, and the
    regions dropped in the window. Returns the numbers compared, each with
    its limit."""
    mism = bad = 0
    for frame, canvas in frames:
        t0 = time.perf_counter()
        ref = mariani_silver.render(
            config["n"], config["g"], config["r"], config["B"],
            config["max_dwell"], config["workload"], frame.bounds, spelling,
            params=config, device=canvas.device)
        m = int((ref != canvas).sum())
        del ref
        log(f"check: frame {frame.index} (tenant {frame.tenant}, depth "
            f"{frame.depth}) {m} pixels differ; reference "
            f"{time.perf_counter() - t0:.2f} s")
        mism += m
        bad += m > 0
    return dict(mismatched_pixels=dict(value=mism, limit=0),
                mismatched_frames=dict(value=bad, limit=0),
                overflow_dropped=dict(value=dropped, limit=0),
                frames_compared=dict(value=len(frames), limit=1))
