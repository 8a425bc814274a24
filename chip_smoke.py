#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (``$CUDA_HOME`` or /usr/local/cuda) and the
checkout around this script; it builds the four kernels of
``src/repro_torch/kernels/csrc`` first. It exits non-zero, printing no
result, when there is no card or no checkout, and when any phase fails
(nothing is caught).

Phases:
  (a) each kernel against its plain PyTorch version on the card, on the
      inputs that ``run_ask`` itself produces at n=2048, g=4, r=2, B=32,
      max_dwell=512, for the four escape-time workloads, plus Ex. region_fill
      must match exactly; the dwell kernels may differ in at most 1 pixel per
      million, because the plain version's FMA goes through f64 (rounded to
      odd, exact in theory; the bound is what the card's FMA may still
      disagree on).
  (b) the main path at full size: n=16384 (a 1 GiB int32 canvas), g=4, r=2,
      B=32, max_dwell=512 (the paper's parameters): ``solve(p, "ex")`` and
      ``solve(p, "ask")`` for each workload. The kernels' launch counts are
      set to 0 just before and read just after; each must be > 0.
  (t) timing at the phase-(b) shapes, for each workload: every kernel
      launch of one ASK run and one Ex run, replayed on the same inputs with
      CUDA events, beside its bound and its plain version (held against the
      kernel with the tolerance of phase a) and, for region_fill, one
      ``index_put_`` of the same writes. The ``kernels`` line reports
      mandelbrot's times and the mismatches of all four workloads.
  (c) DP against ASK at n=1024 (mandelbrot): the canvases must be equal.
  (g) the golden check: run_ask on the card at n=256, g=4, r=2, B=16,
      max_dwell=128 must equal tests/golden/<workload>_256.pgm exactly.

Its last lines are the ``kernels`` JSON line and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
WORKLOADS = ("mandelbrot", "julia", "burning_ship", "multibrot")
SMALL = dict(n=2048, g=4, r=2, B=32, max_dwell=512)
FULL = dict(n=16384, g=4, r=2, B=32, max_dwell=512)
GOLDEN = dict(n=256, g=4, r=2, B=16, max_dwell=128)
DP = dict(n=1024, g=4, r=2, B=32, max_dwell=512)
# H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# f32 flops per escape step (an FMA counts 2), the final escape test, and
# map_coords' two FMAs; see the rounding contract in kernels/ref.py
STEP_FLOPS = {"mandelbrot": 8, "julia": 8, "burning_ship": 8, "multibrot": 14}
TEST_FLOPS, MAP_FLOPS = 3, 4
KERNEL_OF = {"mandelbrot": "mandelbrot_dwell", "perimeter_query": "perimeter_query",
             "region_fill": "region_fill", "region_dwell": "region_dwell"}
KERNELS = {  # name -> (source, TPU kernel it replaces)
    "mandelbrot_dwell": ("src/repro_torch/kernels/csrc/mandelbrot_dwell.cu",
                         "src/repro/kernels/mandelbrot_dwell.py:44"),
    "perimeter_query": ("src/repro_torch/kernels/csrc/perimeter_query.cu",
                        "src/repro/kernels/perimeter_query.py:55"),
    "region_fill": ("src/repro_torch/kernels/csrc/region_fill.cu",
                    "src/repro/kernels/region_fill.py:42"),
    "region_dwell": ("src/repro_torch/kernels/csrc/region_dwell.cu",
                     "src/repro/kernels/region_dwell.py:51"),
}


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


# -- recording what the main path hands each kernel ---------------------------

@contextlib.contextmanager
def recording(ops, calls: list, keep_canvas: bool):
    """Swap the entry points in ``kernels.ops`` for ones that record each
    call: its arguments (the canvas left out), its output, and with
    ``keep_canvas`` the canvas before and after a region call."""

    saved = {k: getattr(ops, k) for k in
             ("mandelbrot", "perimeter_query", "region_fill", "region_dwell")}

    def tap(name):
        fn = saved[name]
        region = name.startswith("region")

        def keep(i, a):
            if region and i == 0:
                return None  # the canvas
            return a.clone() if isinstance(a, torch.Tensor) else a

        def wrapped(*args, **kw):
            before = args[0].clone() if region and keep_canvas else None
            out = fn(*args, **kw)
            calls.append(dict(
                name=name, args=tuple(keep(i, a) for i, a in enumerate(args)),
                kw=dict(kw), before=before,
                out=(out.clone() if keep_canvas else None) if region else out))
            return out

        return wrapped

    try:
        for k in saved:
            setattr(ops, k, tap(k))
        yield calls
    finally:
        for k, fn in saved.items():
            setattr(ops, k, fn)


def plain_of(call, canvas=None):
    """The plain version's output for one recorded call (region calls in
    place on ``canvas``)."""
    from repro_torch.kernels import (mandelbrot_dwell, perimeter_query,
                                     region_dwell, region_fill)
    name, a, kw = call["name"], call["args"], dict(call["kw"])
    if name == "mandelbrot":
        return mandelbrot_dwell.mandelbrot_dwell_plain(a[0], **kw)
    if name == "perimeter_query":
        return perimeter_query.perimeter_query_plain(*a, **kw)
    kw.pop("scheme"), kw.pop("tile")
    if name == "region_fill":
        return region_fill.region_fill_plain(canvas, *a[1:], **kw)
    return region_dwell.region_dwell_plain(canvas, *a[1:], **kw)


def kernel_of(call, canvas=None):
    """The kernel's output for one recorded call (region calls in place on
    ``canvas``)."""
    from repro_torch.kernels import ops
    a, kw = call["args"], call["kw"]
    if call["name"] == "mandelbrot":
        return ops.mandelbrot(a[0], **kw)
    if call["name"] == "perimeter_query":
        return ops.perimeter_query(*a, **kw)
    return getattr(ops, call["name"])(canvas, *a[1:], **kw)


def live_rows(call) -> int:
    """The live OLT rows of a region or border call: its device count."""
    return int(call["args"][-1].item())


def pixels_of(call) -> int:
    """Points the call computes (pixels it writes, for region_fill)."""
    kw = call["kw"]
    if call["name"] == "mandelbrot":
        return call["args"][0] ** 2
    if call["name"] == "perimeter_query":
        return live_rows(call) * 4 * kw["side"]
    return live_rows(call) * kw["side"] ** 2


def tally_add(tally: dict, call, got, want) -> None:
    """Count where a kernel's output differs from the plain version's."""
    if isinstance(got, tuple):  # perimeter_query: (homog, common)
        got, want = (torch.stack([x[0].int(), x[1]]) for x in (got, want))
    bad = int((got != want).sum())
    err = int((got.long() - want.long()).abs().max()) if got.numel() else 0
    name = KERNEL_OF[call["name"]]
    t = tally.setdefault(name, dict(mismatches=0, pixels=0, max_abs_err=0))
    t["mismatches"] += bad
    t["pixels"] += pixels_of(call)
    t["max_abs_err"] = max(t["max_abs_err"], err)


def check_tally(tally: dict, phase: str) -> None:
    for name, t in tally.items():
        allowed = 0 if name == "region_fill" else t["pixels"] // 1_000_000
        if t["mismatches"] > allowed:
            fail(f"phase {phase}: {name} differs from its plain version in "
                 f"{t['mismatches']} outputs (allowed {allowed} of "
                 f"{t['pixels']} pixels)")


# -- timing and bounds -----------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn) -> float:
    """Wall time of one run of ``fn`` that ends in a synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def escape_flops(dwell, max_dwell: int, workload: str) -> float:
    """f32 flops the escape loop needs for these dwells (data-dependent)."""
    d = dwell.double()
    tests = (dwell < max_dwell).double()
    return float((MAP_FLOPS + d * STEP_FLOPS[workload] + tests * TEST_FLOPS).sum())


def bound_of(call, ex_canvas, workload: str):
    """(least ms, flops, bytes) of one kernel call on this card's peaks:
    bytes moved once over HBM bandwidth vs the f32 flops these inputs need,
    with the dwells read off the Ex canvas of the same frame. Only the live
    rows of an OLT count: the padding is no work the call must do."""
    from repro_torch.kernels import ref
    name, a, kw = call["name"], call["args"], call["kw"]
    md = kw.get("max_dwell", 0)
    if name == "mandelbrot":
        flops = escape_flops(ex_canvas, md, workload)
        nbytes = ex_canvas.numel() * 4
    elif name == "perimeter_query":
        k = live_rows(call)
        ys, xs = ref.perimeter_coords(a[0][:k], kw["side"])
        flops = escape_flops(ex_canvas[ys.long(), xs.long()], md, workload)
        nbytes = k * (8 + 5) + 4
    else:
        k, side = live_rows(call), kw["side"]
        nbytes = k * side * side * 4 + k * 12
        flops = 0.0
        if name == "region_dwell":
            ys, xs = ref.region_index(a[1][:k], side)
            flops = escape_flops(ex_canvas[ys, xs], md, workload)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, t_ops * 1e3, t_bytes * 1e3


def library_fill(call, canvas):
    """One ``index_put_`` that writes what a region_fill call writes."""
    from repro_torch.kernels import ref
    a, side = call["args"], call["kw"]["side"]
    k = int(a[3].item())
    ys, xs = (t.reshape(-1) for t in ref.region_index(a[1][:k], side))
    vals = a[2][:k, None, None].expand(k, side, side).reshape(-1)
    return lambda: canvas.index_put_((ys, xs), vals)


# -- the phases ----------------------------------------------------------------

def read_pgm(path: Path):
    import numpy as np
    raw = path.read_bytes()
    header, pixels = raw.split(b"\n", 1)
    _, w, h, _ = header.split()
    return np.frombuffer(pixels, dtype=np.uint8).reshape(int(h), int(w)).astype(np.int32)


def phase_a(dev) -> dict:
    from repro_torch.kernels import ops
    from repro_torch.workloads import FrameProblem, solve
    tally: dict = {}
    for wl in WORKLOADS:
        calls: list = []
        p = FrameProblem(**SMALL, workload=wl, device=dev)
        with recording(ops, calls, keep_canvas=True):
            solve(p, "ask")
            solve(p, "ex")
        for call in calls:
            if call["name"].startswith("region"):
                tally_add(tally, call, call["out"], plain_of(call, call["before"]))
            else:
                tally_add(tally, call, call["out"], plain_of(call))
        log(f"(a) {wl}: {len(calls)} kernel calls held against plain: " +
            ", ".join(f"{k} {v['mismatches']}/{v['pixels']}"
                      for k, v in tally.items()))
    check_tally(tally, "a")
    missing = set(KERNELS) - set(tally)
    if missing:
        fail(f"phase a: no call of {sorted(missing)}")
    return tally


def phase_b(dev) -> dict:
    """The main path, counted: every launch count set to 0, then Ex and ASK
    once per workload, then the counts read. Wall times are the median of
    5 further runs (host clock, each ending in a synchronize)."""
    from repro_torch.kernels import ops
    from repro_torch.workloads import FrameProblem, solve
    wrappers = [ops.mandelbrot, ops.perimeter_query, ops.region_fill,
                ops.region_dwell]
    problems = {wl: FrameProblem(**FULL, workload=wl, device=dev)
                for wl in WORKLOADS}
    n, md = FULL["n"], FULL["max_dwell"]
    rows = {}
    for w in wrappers:
        w.launches = 0
    for wl, p in problems.items():
        ex, _ = solve(p, "ex")
        ask, st = solve(p, "ask")
        for name, c in (("ex", ex), ("ask", ask)):
            if c.shape != (n, n) or c.dtype != torch.int32:
                fail(f"phase b: {wl} {name} canvas {c.dtype} {tuple(c.shape)}")
            if int(c.min()) < 0 or int(c.max()) > md:
                fail(f"phase b: {wl} {name} dwell outside [0, {md}]")
        rows[wl] = dict(kernel_launches=st.kernel_launches,
                        region_counts=list(st.region_counts),
                        leaf_count=st.leaf_count, olt_caps=list(st.olt_caps),
                        ask_vs_ex_share=int((ex != ask).sum()) / (n * n))
        del ex, ask
    launches = {name: w.launches for name, w in zip(KERNELS, wrappers)}
    log(f"(b) launches on the main path: {json.dumps(launches)}")
    for name, k in launches.items():
        if k == 0:
            fail(f"phase b: {name} was never launched on the main path")
    for wl, p in problems.items():
        for method in ("ex", "ask"):
            runs = sorted(host_ms(lambda: solve(p, method)) for _ in range(5))
            rows[wl][f"{method}_ms"] = runs[2]
            rows[wl][f"{method}_ms_range"] = [runs[0], runs[-1]]
        log(f"(b) {wl}: " + json.dumps(rows[wl]))
    return dict(rows=rows, launches=launches)


def phase_t(dev, wl: str) -> dict:
    """Per-kernel device time at the phase-(b) shapes of one workload,
    summed over the launches of one ASK run and one Ex run, beside the
    plain versions (held against the kernels) and the library yardstick."""
    from repro_torch.kernels import ops
    from repro_torch.workloads import FrameProblem, solve
    p = FrameProblem(**FULL, workload=wl, device=dev)
    calls: list = []
    with recording(ops, calls, keep_canvas=False):
        ex, _ = solve(p, "ex")
        solve(p, "ask")
    n = FULL["n"]
    scratch = torch.zeros((n, n), dtype=torch.int32, device=dev)
    out = {k: dict(ms=0.0, plain_ms=None, bound_ms=0.0, ops_ms=0.0,
                   bytes_ms=0.0, library_ms=None) for k in KERNELS}
    tally: dict = {}
    for call in calls:
        region = call["name"].startswith("region")
        row = out[KERNEL_OF[call["name"]]]
        reps = 3 if call["name"] == "mandelbrot" else 10
        row["ms"] += cuda_ms(lambda: kernel_of(call, scratch), reps)
        bound, t_ops, t_bytes = bound_of(call, ex, wl)
        row["bound_ms"] += bound
        row["ops_ms"] += t_ops
        row["bytes_ms"] += t_bytes
        got = kernel_of(call, scratch.clone() if region else None)
        want = []
        row["plain_ms"] = (row["plain_ms"] or 0.0) + host_ms(lambda: want.append(
            plain_of(call, scratch.clone() if region else None)))
        tally_add(tally, call, got, want[0])
        if call["name"] == "region_fill":
            row["library_ms"] = (row["library_ms"] or 0.0) + cuda_ms(
                library_fill(call, scratch), 10)
        del got, want
    check_tally(tally, "t")
    for k, row in out.items():
        row["bound_by"] = ("operations" if row["ops_ms"] >= row["bytes_ms"]
                           else "bytes")
        row.update(tally.get(k, {}))
        log(f"(t) {wl} {k}: " + json.dumps(row))
    return out


def phase_c(dev) -> None:
    from repro_torch.workloads import FrameProblem, solve
    p = FrameProblem(**DP, workload="mandelbrot", device=dev)
    ask, ask_st = solve(p, "ask")
    t0 = time.perf_counter()
    dp, dp_st = solve(p, "dp")
    dp_ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(dp, ask):
        fail(f"phase c: DP and ASK differ in {int((dp != ask).sum())} pixels")
    if dp_st.region_counts != ask_st.region_counts or \
            dp_st.leaf_count != ask_st.leaf_count:
        fail("phase c: DP and ASK count different regions")
    log(f"(c) DP == ASK at n={DP['n']}: DP {dp_st.kernel_launches} launches, "
        f"ASK {ask_st.kernel_launches}, ratio "
        f"{dp_st.kernel_launches / ask_st.kernel_launches:.1f}; "
        f"DP wall {dp_ms:.1f} ms")


def phase_g(dev) -> None:
    from repro_torch.workloads import FrameProblem, solve
    for wl in WORKLOADS:
        canvas, _ = solve(FrameProblem(**GOLDEN, workload=wl, device=dev), "ask")
        want = read_pgm(ROOT / "tests" / "golden" / f"{wl}_256.pgm")
        bad = int((canvas.cpu().numpy() != want).sum())
        if bad:
            fail(f"phase g: {wl} differs from its golden in {bad} pixels")
    log("(g) run_ask on the card equals the four goldens")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this needs an "
              "NVIDIA card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}: run it from "
              "a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    log(smi.splitlines()[0])
    log(f"device: {kind}; torch {torch.__version__}; CUDA {torch.version.cuda}; "
        f"capability {torch.cuda.get_device_capability(0)}; "
        f"count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} libraries "
        "(nvcc in parallel)")
    for name, b in built.items():  # one line per library: ptxas -v summary
        regs = re.findall(r"Used (\d+) registers", b["log"])
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill", b["log"]))
        log(f"  {name}: registers per instance {'/'.join(regs)}, spill bytes "
            f"{spills}, built in {b['seconds']:.1f} s")

    t0 = time.perf_counter()
    small = phase_a(dev)
    log(f"(a) done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    main_path = phase_b(dev)
    log(f"(b) done in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    timing = {wl: phase_t(dev, wl) for wl in WORKLOADS}
    log(f"(t) done in {time.perf_counter() - t0:.1f} s")
    phase_c(dev)
    phase_g(dev)

    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = timing["mandelbrot"][name]
        held = [small[name]] + [timing[wl][name] for wl in WORKLOADS]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=main_path["launches"][name],
            max_abs_err=max(h["max_abs_err"] for h in held),
            mismatches=sum(h["mismatches"] for h in held),
            ms=t["ms"], plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
            bound_by=t["bound_by"], library_ms=t["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
