#!/usr/bin/env python3
"""Measure, on one NVIDIA card, what the escape kernels' design rests on.

    python3 tools/escape_design.py [--baseline DIR]... [--rounds R] [--no-sweep]

``chip_smoke.py`` drives and checks the port's main path; this script
measures once the choices that the escape kernels of
``src/repro_torch/kernels/csrc`` make, on the shapes of chip_smoke's
phases (t) and (p) (n=16384, g=4, r=2, B=32, max_dwell=512; the pooled
batch of 8 mandelbrot frames at worst-case capacities):

* the steps per block U of the escape loop. Every escape library is built
  at U = 4, 8 and 16, from a copy of the sources under ``build/`` whose
  ``kUnroll`` constants are set to U (the sources fix 8 for Ex and Q, 16
  for A). Every escape call of one Ex and one ASK run per
  workload, and of the pooled batch, is timed at each U (CUDA events) and
  held against the default build's output: the dwell does not depend on U,
  so any mismatch fails the run. Beside each time: lane slots per useful
  escape step (as in chip_smoke) and the SASS step loop of the build;
* lane refill. The lane efficiency of the leaves (the sum of dwells over
  the lane-steps issued), from the canvas: before refill (a warp per
  32-pixel row, run to its slowest lane) and with refill at each U,
  simulated block by block. For the pooled A also the slowest warp's
  blocks over the mean, had the items been dealt to the warps by a fixed
  stride instead of from the kernel's counter;
* with ``--baseline DIR`` (the root of another checkout, e.g. a ``git
  archive`` of an earlier commit; repeatable), the SASS step loop of the
  escape libraries built from DIR's kernel sources, whether each kernel
  instance of ``SAME_SASS_LIBS`` (the batched ranks) compiles to the same
  SASS from both trees' sources (also with ``--no-sweep``), and DIR compared with
  this tree end to end: each checkout's own code, in a subprocess, times
  its border queries (Q of one ASK run per workload, the pooled Q) as
  device time and with CUDA events; T (events and device time) and A
  (events) of the same ASK run; the pooled batch's fills (events); the
  OLT scan at the pooled batch's sizes, 128 to 524288 random bool flags,
  and the batched ranks at the MoE's prefill and decode shapes (device
  time); and the walls of each ASK frame and of the pooled batch. The order is the
  baselines, this tree, the U sweep, this tree, the baselines in reverse;
  ``--rounds R`` repeats each side's sequence R times, since the walls
  move between processes. ``--no-sweep`` runs the comparison alone, in
  the order baselines, this tree, this tree, baselines.

The border queries take tens of microseconds a call, so the sweep times
them as device time (chip_smoke's ``graph_ms``: replays of a CUDA graph)
and, beside it, with CUDA events around eager calls, which also hold the
wrapper's host work; Ex and A with CUDA events.

Needs one CUDA card, nvcc and cuobjdump. Prints the card's name and power
limit, one line per measurement and, last, one JSON object with them all.
"""

from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402

UNROLLS = (4, 8, 16)
ESCAPE_LIBS = ("mandelbrot_dwell", "perimeter_query", "region_dwell",
               "region_dwell_pooled")
SOURCES = _build.CSRC
SOURCES_AT: dict = {}  # unroll -> a copy of the sources built at it


def copy_at(unroll: int) -> Path:
    """A copy of the kernel sources, under build/, in which every escape
    kernel runs ``unroll`` steps a block."""
    dst = _build.BUILD_DIR.parent / "escape_design" / f"csrc_u{unroll}"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(SOURCES, dst)
    for lib in ESCAPE_LIBS:
        path = dst / f"{lib}.cu"
        text, k = re.subn(r"constexpr int kUnroll = \d+;",
                          f"constexpr int kUnroll = {unroll};", path.read_text())
        if k != 1:
            raise RuntimeError(f"{path.name}: {k} kUnroll constants, not 1")
        path.write_text(text)
    return dst


def use_sources(csrc: Path) -> None:
    """Load the libraries built from ``csrc`` (building them on first use)."""
    _build.CSRC = csrc
    _build._LIBS.clear()
    _build._FUNCS.clear()


def use_build(unroll) -> None:
    """Load the escape libraries built at ``unroll`` steps a block (None:
    the sources' own)."""
    use_sources(SOURCES_AT[unroll] if unroll else SOURCES)


def step_loops(paths: dict) -> dict:
    """{library: {instance: SASS step-loop instructions}} of built
    libraries (chip_smoke.sass_loops)."""
    return {lib: {i: c["instr"] for i, c in cs.sass_loops(path).items()}
            for lib, path in paths.items()}


def lane_steps(items, max_dwell: int, unroll: int):
    """Lane-steps that lane refill issues on the dwells ``items`` [N, P]
    (each warp item's pixels in row-major order), simulated exactly: a
    pixel of dwell d holds its lane for min(d // unroll + 1,
    ceil(max_dwell / unroll)) blocks, and at each block's end the lanes
    that finished take the next pixels in lane order (the least-loaded
    lane, the lowest on a tie). Returns (issued lane-steps, blocks [N]: each
    item's warp time in blocks)."""
    d = items.to(torch.int32)
    N, P = d.shape
    held = torch.clamp(d // unroll + 1, max=-(-max_dwell // unroll))
    free = torch.zeros((N, 32), dtype=torch.int32, device=d.device)
    free[:, :min(32, P)] = held[:, :32]
    at = torch.arange(N, device=d.device)
    for j in range(32, P):
        lane = free.argmin(1)
        free[at, lane] += held[:, j]
    blocks = free.amax(1)
    return 32 * unroll * float(blocks.double().sum()), blocks


def lane_efficiency(chunks, max_dwell: int) -> dict:
    """The leaves' lane efficiency before refill (``row_per_warp``) and
    with refill at each U (``refill_u<U>``), from [k, P] chunks of items;
    ``blocks``: each item's blocks at U = 16."""
    chunks = list(chunks)
    useful = sum(float(c.double().sum()) for c in chunks)
    out = dict(row_per_warp=cs.row_per_warp_efficiency(chunks))
    blocks = []
    for u in UNROLLS:
        issued = 0.0
        for c in chunks:
            i, b = lane_steps(c, max_dwell, u)
            issued += i
            if u == 16:
                blocks.append(b)
        out[f"refill_u{u}"] = useful / issued
    out["blocks"] = torch.cat(blocks)
    return out


def fresh(shape, dev):
    """A canvas no kernel has written: -1 everywhere."""
    return torch.full(shape, -1, dtype=torch.int32, device=dev)


def differ(got, want) -> int:
    if isinstance(got, tuple):
        return sum(int((g.int() != w.int()).sum()) for g, w in zip(got, want))
    return int((got != want).sum())


def single(dev, wl: str) -> dict:
    """The escape calls of one Ex and one ASK run of ``wl`` at each U, and
    the leaves' lane efficiency."""
    from repro_torch.kernels import ref
    from repro_torch.workloads import FrameProblem, solve
    n = cs.FULL["n"]
    use_build(None)
    calls: list = []
    p = FrameProblem(**cs.FULL, workload=wl, device=dev)
    with cs.recording(ops, calls, keep_canvas=False):
        ex, _ = solve(p, "ex")
        solve(p, "ask")
    calls = [c for c in calls if c["name"] != "region_fill"]
    scratch = fresh((n, n), dev)

    def run(call):
        region = call["name"] == "region_dwell"
        return cs.kernel_of(call, fresh((n, n), dev) if region else None)

    want = [run(c) for c in calls]
    out = {}
    for call in calls:
        row = out.setdefault(cs.KERNEL_OF[call["name"]], dict(steps=0.0))
        row["steps"] += cs.bound_of(call, ex, wl)[3]
    for u in UNROLLS:
        use_build(u)
        for call, w in zip(calls, want):
            row = out[cs.KERNEL_OF[call["name"]]]
            reps = 3 if call["name"] == "mandelbrot" else 10
            query = call["name"] == "perimeter_query"
            timer = cs.graph_ms if query else (lambda fn: cs.cuda_ms(fn, reps))
            row[f"ms_u{u}"] = row.get(f"ms_u{u}", 0.0) + timer(
                lambda: cs.kernel_of(call, scratch))
            if query:
                row[f"event_ms_u{u}"] = row.get(f"event_ms_u{u}", 0.0) + \
                    cs.cuda_ms(lambda: cs.kernel_of(call, scratch), reps)
            row[f"mismatches_u{u}"] = (row.get(f"mismatches_u{u}", 0)
                                       + differ(run(call), w))
    for row in out.values():
        for u in UNROLLS:
            row[f"slots_per_step_u{u}"] = cs.slots_per_step(row[f"ms_u{u}"],
                                                            row["steps"])
    leaf = next(c for c in calls if c["name"] == "region_dwell")
    k, side = cs.live_rows(leaf), leaf["kw"]["side"]
    ys, xs = ref.region_index(leaf["args"][1][:k], side)
    step = max(1, (1 << 26) // (side * side))
    eff = lane_efficiency((ex[ys[a:a + step], xs[a:a + step]]
                           .reshape(-1, side * side) for a in range(0, k, step)),
                          cs.FULL["max_dwell"])
    eff.pop("blocks")
    out["region_dwell"]["lane_eff"] = eff
    return out


def pooled(dev) -> dict:
    """The pooled Q and A calls of chip_smoke's phase (p) batch at each U,
    the leaves' lane efficiency and the tail of a fixed stride."""
    from repro_torch.workloads import EngineOptions, FrameProblem, solve_batch
    n, md = cs.POOLED["n"], cs.POOLED["max_dwell"]
    bounds = cs.mixed_bounds()
    F = len(bounds)
    use_build(None)
    calls: list = []
    with cs.recording_pooled(ops, calls):
        canvas, _ = solve_batch(
            FrameProblem(**cs.POOLED, device=dev), bounds,
            options=EngineOptions(engine="ask_pooled", safety_factor=1e9))
    banded = canvas.view(F * n, n)
    names = ("perimeter_query_pooled", "region_dwell_pooled")
    calls = [c for c in calls if c["name"] in names]
    out = {name: dict(steps=0.0) for name in names}
    for call in calls:
        out[call["name"]]["steps"] += cs.pooled_bound(call, banded)[3]

    def run_all():
        """Every call once: the queries' outputs and A's canvas."""
        a = fresh((F * n, n), dev)
        got = [cs.pooled_kernel(c, a) for c in calls]
        return [g for c, g in zip(calls, got) if c["name"] == names[0]], a

    want_q, want_a = run_all()
    timed = fresh((F * n, n), dev)
    for u in UNROLLS:
        use_build(u)
        for call in calls:
            row = out[call["name"]]
            query = call["name"] == names[0]
            timer = cs.graph_ms if query else (lambda fn: cs.cuda_ms(fn, 3))
            row[f"ms_u{u}"] = row.get(f"ms_u{u}", 0.0) + timer(
                lambda: cs.pooled_kernel(call, timed))
            if query:
                row[f"event_ms_u{u}"] = row.get(f"event_ms_u{u}", 0.0) + \
                    cs.cuda_ms(lambda: cs.pooled_kernel(call, timed), 10)
        got_q, got_a = run_all()
        out[names[0]][f"mismatches_u{u}"] = sum(
            differ(g, w) for g, w in zip(got_q, want_q))
        out[names[1]][f"mismatches_u{u}"] = int((got_a != want_a).sum())
        del got_a
    del want_a, timed
    for row in out.values():
        for u in UNROLLS:
            row[f"slots_per_step_u{u}"] = cs.slots_per_step(row[f"ms_u{u}"],
                                                            row["steps"])
    chunks = []
    for call in (c for c in calls if c["name"] == names[1]):
        k, side = cs.pooled_live(call), call["kw"]["side"]
        rpi = _build.rows_per_item(side)
        chunks += [v.reshape(-1, rpi * side) for v in
                   cs.region_values(banded, call["args"][1][:k], side, n)]
    eff = lane_efficiency(chunks, md)
    blocks = eff.pop("blocks").double()
    # the kernel's grid: 8 warps a block, a few blocks per SM
    warps = 8 * _build.grid_for(dev, -(-blocks.numel() // 8), 256)
    per_warp = torch.zeros(warps, dtype=torch.float64, device=dev)
    per_warp.index_add_(0, torch.arange(blocks.numel(), device=dev) % warps,
                        blocks)
    out[names[1]]["lane_eff"] = eff
    out[names[1]]["static_stride_tail"] = float(per_warp.max() / per_warp.mean())
    return out


# Run in a subprocess with a checkout's root as argv[1] (another checkout
# or this one): its own chip_smoke and repro_torch run one ASK frame per
# workload and the pooled batch. Each border query is timed as device time
# (graph_ms) and with CUDA events around eager calls (cuda_ms: the
# wrapper's host work included), summed over the calls; T as events
# (``fill_ms``, as chip_smoke's phase (t) times it) and device time
# (``fill_graph_ms``), A and the pooled fill as events; the batched ranks at
# the MoE's prefill and decode shapes as device time, on int32 flags of the
# MoE's density from a seed; each frame's ASK wall and the batch's wall
# (worst-case and default capacities) are the median of 5 warm runs
# (host_ms). Prints {workload, "pooled" or "batched_ranks": times} as JSON.
# It uses only what the checkouts it compares (this one and its parent) have.
CHECKOUT_TIMES = """
import json, sys
sys.path[:0] = [sys.argv[1] + "/src", sys.argv[1]]
import torch
import chip_smoke as cs
from repro_torch.core import pooled
from repro_torch.kernels import _build, moe_dispatch, olt_compact, ops
from repro_torch.workloads import EngineOptions, FrameProblem, solve, solve_batch
_build.build()
dev = torch.device("cuda", 0)
n = cs.FULL["n"]

def wall(run):
    runs = sorted(cs.host_ms(run) for _ in range(5))
    return dict(wall_ms=runs[2], wall_ms_range=[runs[0], runs[-1]])

def queries(calls, name, kernel):
    qs = [c for c in calls if c["name"] == name]
    return dict(graph_ms=sum(cs.graph_ms(lambda: kernel(c)) for c in qs),
                event_ms=sum(cs.cuda_ms(lambda: kernel(c), 10) for c in qs))

def regions(calls, name, kernel, reps):
    return sum(cs.cuda_ms(lambda: kernel(c), reps)
               for c in calls if c["name"] == name)

out = {}
canvas = torch.zeros((n, n), dtype=torch.int32, device=dev)
for wl in cs.WORKLOADS:
    p = FrameProblem(**cs.FULL, workload=wl, device=dev)
    calls = []
    with cs.recording(ops, calls, keep_canvas=False):
        solve(p, "ask")
    on_canvas = lambda c: cs.kernel_of(c, canvas)
    out[wl] = dict(**wall(lambda: solve(p, "ask")),
                   **queries(calls, "perimeter_query", cs.kernel_of),
                   fill_ms=regions(calls, "region_fill", on_canvas, 10),
                   fill_graph_ms=sum(cs.graph_ms(lambda: on_canvas(c))
                                     for c in calls
                                     if c["name"] == "region_fill"),
                   dwell_ms=regions(calls, "region_dwell", on_canvas, 3))
    del calls
    torch.cuda.empty_cache()
del canvas
p = FrameProblem(**cs.POOLED, device=dev)
bounds = cs.mixed_bounds()
worst = EngineOptions(engine="ask_pooled", safety_factor=1e9)
calls = []
with cs.recording_pooled(ops, calls):  # the level loop, launched eagerly
    pooled.pooled_pipeline(
        p, pooled._resolve_pooled_capacities(p, len(bounds), None, None, 0.7,
                                             1e9),
        ops.pooled_planes(n, bounds, dev),
        torch.ones((len(bounds),), dtype=torch.bool, device=dev))
default = wall(lambda: solve_batch(p, bounds,
                                   options=EngineOptions(engine="ask_pooled")))
out["pooled"] = dict(**wall(lambda: solve_batch(p, bounds, options=worst)),
                     default_wall_ms=default["wall_ms"],
                     default_wall_ms_range=default["wall_ms_range"],
                     **queries(calls, "perimeter_query_pooled",
                               lambda c: cs.pooled_kernel(c, None)))
banded = torch.zeros((len(bounds) * n, n), dtype=torch.int32, device=dev)
out["pooled"]["fill_ms"] = regions(calls, "region_fill_pooled",
                                   lambda c: cs.pooled_kernel(c, banded), 10)
del calls, banded
torch.cuda.empty_cache()
out["olt_compact"] = {}
for N in (128, 512, 2048, 8192, 16384, 32768, 131072, 524288):
    gen = torch.Generator(device=dev).manual_seed(N)
    f = torch.rand(N, generator=gen, device=dev) < 0.37
    out["olt_compact"][str(N)] = dict(
        graph_ms=cs.graph_ms(lambda: olt_compact.compact_ranks(f)))
out["batched_ranks"] = {}
for shape in ((4, 6144, 64), (1, 48, 64)):
    gen = torch.Generator(device=dev).manual_seed(0)
    f = (torch.rand(shape, generator=gen, device=dev) < 6 / 64).to(torch.int32)
    out["batched_ranks"][str(list(shape))] = dict(
        graph_ms=cs.graph_ms(lambda: moe_dispatch.batched_ranks(f)))
print(json.dumps(out))
"""


def checkout_times(root: Path) -> dict:
    """The border queries' times and the walls of the checkout at ``root``,
    run by its own code (``CHECKOUT_TIMES``)."""
    done = subprocess.run([sys.executable, "-c", CHECKOUT_TIMES, str(root)],
                          capture_output=True, text=True, timeout=900)
    if done.returncode != 0:
        raise RuntimeError(f"{root}: checkout times failed:\n"
                           f"{done.stderr[-4000:]}")
    return json.loads(done.stdout.splitlines()[-1])


def compare(roots, stage: str, result: dict) -> None:
    """``checkout_times`` of each root in turn, logged and kept in
    ``result["checkouts"][stage]``."""
    for root in roots:
        times = checkout_times(root.resolve())
        result.setdefault("checkouts", {}).setdefault(stage, []).append(
            dict(root=str(root), **times))
        cs.log(f"checkout {root} ({stage}): {json.dumps(times)}")


def baseline_sass(root: Path) -> dict:
    """The SASS step loops of the escape libraries built from the kernel
    sources of the checkout at ``root``."""
    use_sources(root / "src" / "repro_torch" / "kernels" / "csrc")
    try:
        built = _build.build(ESCAPE_LIBS)
        return step_loops({k: v["path"] for k, v in built.items()})
    finally:
        use_build(None)


SAME_SASS_LIBS = ("moe_dispatch",)  # held, instance by instance, to DIR's


def sass_text(library) -> dict:
    """{kernel instance: its SASS instructions, addresses and encodings
    left out} of a built library (``cuobjdump -sass``). An instance is
    named by its mangled symbol with the hash of its anonymous namespace
    (which changes with the source's text) left out."""
    text = subprocess.run([cs.cuda_tool("cuobjdump"), "-sass", str(library)],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        lines = chunk.splitlines()
        found = (re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
                 for line in lines[1:])
        name = re.sub(r"_GLOBAL__N__[0-9a-f]{8}_\d+_(\w+?_cu)_[0-9a-f]{8}",
                      r"_GLOBAL__N__\1", lines[0].strip())
        out[name] = [
            re.sub(r"\.L_x_\d+", ".L", m.group(1)) for m in found if m]
    return out


def same_sass(root: Path) -> dict:
    """For each library of ``SAME_SASS_LIBS``, built from this tree's and
    from the checkout at ``root``'s kernel sources: {instance: whether its
    SASS is the same instruction for instruction} over both builds'
    instances, and the instructions of each."""
    mine = {lib: sass_text(b["path"])
            for lib, b in _build.build(SAME_SASS_LIBS).items()}
    use_sources(root / "src" / "repro_torch" / "kernels" / "csrc")
    try:
        theirs = {lib: sass_text(b["path"])
                  for lib, b in _build.build(SAME_SASS_LIBS).items()}
    finally:
        use_build(None)
    return {lib: {i: dict(same=mine[lib].get(i) == theirs[lib].get(i),
                          instructions=[len(mine[lib].get(i, [])),
                                        len(theirs[lib].get(i, []))])
                  for i in sorted(set(mine[lib]) | set(theirs[lib]))}
            for lib in SAME_SASS_LIBS}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--baseline", type=Path, action="append", default=[],
                        help="root of another checkout, to be compared with "
                             "this one (repeatable)")
    parser.add_argument("--rounds", type=int, default=1,
                        help="rounds of the comparison on each side of the "
                             "sweep (the walls move between processes)")
    parser.add_argument("--no-sweep", action="store_true",
                        help="compare the checkouts only: baselines, this "
                             "tree, this tree, baselines")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("escape_design: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    cs.log(smi.strip().splitlines()[0])
    clock = float(smi.split(",")[2].split()[0])
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cs.CARD["slots_per_s"] = sms * cs.LANES_PER_SM * clock * 1e6

    same = {str(root): same_sass(root.resolve()) for root in args.baseline}
    for root, libs in same.items():
        cs.log(f"SASS against {root} (this tree, {root}): {json.dumps(libs)}")
    if args.no_sweep:
        result: dict = dict(same_sass=same)
        compare([*args.baseline, ROOT, ROOT, *reversed(args.baseline)],
                "no sweep", result)
        print(json.dumps(result))
        return 0
    t0 = time.perf_counter()
    use_build(None)
    _build.build()  # every library the path needs, one nvcc each
    result = dict(sass={}, same_sass=same)
    for u in UNROLLS:
        SOURCES_AT[u] = copy_at(u)
        use_build(u)
        built = _build.build(ESCAPE_LIBS)
        result["sass"][f"u{u}"] = step_loops(
            {k: v["path"] for k, v in built.items()})
        cs.log(f"SASS step loops at U={u}: {json.dumps(result['sass'][f'u{u}'])}")
    for root in args.baseline:
        result["sass"][str(root)] = baseline_sass(root.resolve())
        cs.log(f"SASS step loops of {root}: "
               f"{json.dumps(result['sass'][str(root)])}")
    cs.log(f"built in {time.perf_counter() - t0:.1f} s")
    # baselines, this tree; the U sweep; this tree, baselines in reverse
    if args.baseline:
        compare([*args.baseline, ROOT] * args.rounds, "before", result)

    for wl in cs.WORKLOADS:
        result[wl] = single(dev, wl)
        cs.log(f"{wl}: {json.dumps(result[wl])}")
        torch.cuda.empty_cache()
    result["pooled"] = pooled(dev)
    cs.log(f"pooled: {json.dumps(result['pooled'])}")
    if args.baseline:
        torch.cuda.empty_cache()
        compare([ROOT, *reversed(args.baseline)] * args.rounds, "after", result)
    bad = {f"{cell} {name} U={u}": row[f"mismatches_u{u}"]
           for cell, rows in result.items()
           if cell in (*cs.WORKLOADS, "pooled")
           for name, row in rows.items() for u in UNROLLS
           if row[f"mismatches_u{u}"]}
    print(json.dumps(result))
    if bad:
        print(f"escape_design: outputs depend on U: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
