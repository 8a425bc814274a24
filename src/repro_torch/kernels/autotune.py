"""The tuned tier: schedule sweeps, a JSON tuning cache, heuristics.

Counterpart of ``repro/kernels/autotune.py``. The paper's cost model
(Sec. 5) predicts how many dispatches ASK needs; how fast each dispatch's
kernel runs is scheduling, which this module sweeps:

* ``tune(kernel, ...)`` times every candidate (impl, params) for one kernel
  at one static signature and records the winner;
* ``tune_problem(problem, ...)`` walks a ``FrameProblem``'s subdivision
  chain and tunes every kernel the ASK pipeline launches (Ex at ``n``, Q
  and A at every level side, the OLT scan at every ring capacity and, with
  ``pooled_frames``, the pooled engine's banded kernels);
* ``TuningCache`` keeps the winners as JSON, in JAX's format
  (``CACHE_VERSION`` 1), keyed like the CUDA graphs of the one-dispatch
  engines: kernel, workload, dtype, platform and the kernel's shape
  signature (``cache_key``);
* ``choose(kernel, ...)`` is what ``kernels.ops`` asks when the policy's
  backend is ``tuned``: the cache's entry, else ``heuristic()``.

Candidates. On the card every candidate is a CUDA schedule of the
hand-written kernel (impl ``cuda``): the steps per block U of the escape
loop, 4, 8 or 16 (``repro::escape_time<K, U>``; the dwell does not depend
on it), for Ex, Q, A and pooled A, and for Ex also its thread block,
16 x 16 (the default), 8 x 32 or 4 x 32 (rows x columns; one thread a
pixel). T, the scan, pooled T and the batched ranks have one candidate
each, their kernel. The plain version (impl ``torch``) is never a
candidate on the card and never the heuristic's answer there; a cache
entry whose key names a card and whose impl is ``torch`` raises. On the
CPU the only candidate is the plain version. Each candidate's output is
held against the default schedule's, bit for bit, before its time counts;
one that differs, or fails to build or launch, raises.

Timing on the card is device time, read with CUDA events: after a warm-up
call, a CUDA graph of as many back-to-back calls as make about a
millisecond is replayed ``reps`` times, and the best replay over its
calls is kept (an eager call of tens of microseconds would time the host's
enqueue). On the CPU the best of ``reps`` calls on the host clock.

The cache key's platform is ``cpu`` on the CPU, where the key equals JAX's
letter for letter, and ``cuda-sm_<capability>`` on a card, so that a cache
measured on one kind of card is never read on another.

CLI::

    python -m repro_torch.kernels.autotune --tiny --n 128 --max-dwell 32 \\
        --out build/tc.json [--device cpu]
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import _build

__all__ = [
    "CACHE_VERSION",
    "Choice",
    "TuningCache",
    "cache_key",
    "choose",
    "clear_memo",
    "heuristic",
    "tune",
    "tune_problem",
    "DEFAULT_SCHEDULES",
]

CACHE_VERSION = 1

# Kernels the harness times (JAX's list): T and the batched ranks have no
# axis beyond impl, so they are routed by the heuristics alone.
_TUNABLE = ("dwell", "perimeter_query", "region_dwell", "olt_compact",
            "region_fill_pooled", "region_dwell_pooled")

# The schedules the card's kernels launch by default: each .cu's kUnroll
# (and Ex's 16 x 16 block). The heuristics name them, so a cold cache
# launches the same kernels as the ``cuda`` rung.
DEFAULT_SCHEDULES = {
    "dwell": {"block": (16, 16), "unroll": 8},
    "perimeter_query": {"unroll": 16},
    "region_dwell": {"unroll": 16},
    "region_dwell_pooled": {"unroll": 16},
}


# ---------------------------------------------------------------------------
# Choice: one resolved (impl, params) decision


@dataclasses.dataclass(frozen=True)
class Choice:
    """One routing decision: which implementation and which schedule.

    ``params`` is a sorted tuple of (name, value) pairs, hashable.
    ``source`` is where the decision came from (``heuristic`` / ``cache``
    / ``measured``); ``us`` the measured time in microseconds, if any.
    """

    impl: str  # "torch" | "cuda"
    params: Tuple[Tuple[str, Any], ...] = ()
    source: str = "heuristic"
    us: Optional[float] = None

    def __post_init__(self):
        if self.impl not in ("torch", "cuda"):
            raise ValueError(f"impl must be 'torch' or 'cuda', got {self.impl!r}")
        frozen = tuple(sorted(
            (str(k), tuple(v) if isinstance(v, list) else v)
            for k, v in (dict(self.params).items()
                         if not isinstance(self.params, tuple)
                         else self.params)))
        object.__setattr__(self, "params", frozen)

    def param_dict(self) -> Dict[str, Any]:
        return dict(self.params)

    def to_entry(self) -> Dict[str, Any]:
        return {
            "impl": self.impl,
            "params": {k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in self.params},
            "source": self.source,
            "us": self.us,
        }

    @classmethod
    def from_entry(cls, entry: Mapping[str, Any]) -> "Choice":
        params = tuple(sorted(
            (k, tuple(v) if isinstance(v, list) else v)
            for k, v in dict(entry.get("params", {})).items()))
        return cls(impl=entry["impl"], params=params,
                   source=entry.get("source", "cache"),
                   us=entry.get("us"))


# ---------------------------------------------------------------------------
# Cache keys


def platform(device) -> str:
    """The key's platform: ``cpu``, or ``cuda-sm_<capability>`` of the
    card (raises where there is none)."""
    if not _build.on_card(device):
        return "cpu"
    major, minor = torch.cuda.get_device_capability(torch.device(device))
    return f"cuda-sm_{major}{minor}"


def cache_key(kernel: str, *, workload=None, dtype: str = "int32",
              device="cuda", **sig: Any) -> str:
    """Stable string key of one kernel variant: kernel name, workload
    name, canvas dtype, the platform of ``device`` (``platform``) and the
    kernel's shape signature (n, side, max_dwell, ...), as JAX builds it."""
    wl = getattr(workload, "name", workload) or "mandelbrot"
    parts = [kernel, f"wl={wl}", f"dtype={dtype}",
             f"plat={platform(device)}"]
    for k in sorted(sig):
        v = sig[k]
        if isinstance(v, (tuple, list)):
            v = "x".join(str(x) for x in v)
        parts.append(f"{k}={v}")
    return "|".join(parts)


def _check_entry(key: str, choice: Choice) -> None:
    """A card's key must name a CUDA schedule: the plain version is never
    picked on the card."""
    if "|plat=cuda-" in key and choice.impl != "cuda":
        raise ValueError(
            f"tuning cache entry {key!r} names impl {choice.impl!r} on a "
            "card: the tuned tier runs only the CUDA kernels there")


# ---------------------------------------------------------------------------
# TuningCache: JSON persistence


class TuningCache:
    """Measured winners, persisted as versioned JSON::

        {"version": 1,
         "entries": {"<cache_key>": {"impl": ..., "params": {...},
                                     "source": ..., "us": ...}, ...}}
    """

    def __init__(self, entries: Optional[Dict[str, Choice]] = None):
        self.entries: Dict[str, Choice] = dict(entries or {})

    def get(self, key: str) -> Optional[Choice]:
        return self.entries.get(key)

    def put(self, key: str, choice: Choice) -> None:
        _check_entry(key, choice)
        self.entries[key] = choice

    def to_json(self) -> str:
        return json.dumps(
            {"version": CACHE_VERSION,
             "entries": {k: c.to_entry()
                         for k, c in sorted(self.entries.items())}},
            indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "TuningCache":
        data = json.loads(text)
        version = data.get("version")
        if version != CACHE_VERSION:
            raise ValueError(
                f"tuning cache version {version!r} != {CACHE_VERSION}; "
                "re-run `python -m repro_torch.kernels.autotune` to regenerate")
        return cls({k: Choice.from_entry(e)
                    for k, e in data.get("entries", {}).items()})

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            fh.write(self.to_json() + "\n")

    @classmethod
    def load(cls, path: str) -> "TuningCache":
        with open(path) as fh:
            return cls.from_json(fh.read())


# (cache path or None, key) -> Choice: keeps ``choose`` O(1) on the calls
# of a level loop and reads each cache file once
_MEMO: Dict[Tuple[Optional[str], str], Choice] = {}
_FILE_CACHES: Dict[str, Optional[TuningCache]] = {}


def clear_memo() -> None:
    """Drop the in-process memo (tests; after re-tuning a cache file)."""
    _MEMO.clear()
    _FILE_CACHES.clear()


def _load_file_cache(path: str) -> Optional[TuningCache]:
    ap = os.path.abspath(path)
    if ap not in _FILE_CACHES:
        try:
            _FILE_CACHES[ap] = TuningCache.load(ap)
        except (OSError, ValueError, KeyError):
            _FILE_CACHES[ap] = None  # missing or unreadable: heuristics
    return _FILE_CACHES[ap]


# ---------------------------------------------------------------------------
# Heuristics: the cold-cache answer


def heuristic(kernel: str, *, workload=None, device="cuda", **sig: Any) -> Choice:
    """The rule table used when no cache entry matches. Grid workloads and
    the CPU take the plain version; on the card every kernel runs its CUDA
    kernel in its default schedule (``DEFAULT_SCHEDULES``), so a cold
    cache launches the same kernels as the ``cuda`` rung."""
    if kernel not in _TUNABLE + ("region_fill", "batched_ranks"):
        raise ValueError(f"unknown kernel {kernel!r}")
    if getattr(workload, "kind", "escape") == "grid" or not _build.on_card(device):
        return Choice("torch")
    return Choice("cuda", tuple(sorted(DEFAULT_SCHEDULES.get(kernel, {}).items())))


def choose(kernel: str, *, workload=None, cache: Optional[str] = None,
           dtype: str = "int32", device="cuda", **sig: Any) -> Choice:
    """The routing decision for one kernel call: the in-process memo, then
    the JSON cache (when ``cache`` names a readable file), then
    ``heuristic()``. A card's entry that names the plain version raises."""
    key = cache_key(kernel, workload=workload, dtype=dtype, device=device,
                    **sig)
    memo_key = (os.path.abspath(cache) if cache else None, key)
    hit = _MEMO.get(memo_key)
    if hit is not None:
        return hit
    choice = None
    if cache:
        fc = _load_file_cache(cache)
        if fc is not None:
            stored = fc.get(key)
            if stored is not None:
                _check_entry(key, stored)
                choice = dataclasses.replace(stored, source="cache")
    if choice is None:
        choice = heuristic(kernel, workload=workload, device=device, **sig)
    _MEMO[memo_key] = choice
    return choice


# ---------------------------------------------------------------------------
# Measurement


def _candidates(kernel: str, *, workload=None, tiny: bool = False,
                device="cuda", **sig: Any):
    """Yield (impl, params) candidates for one kernel signature."""
    if getattr(workload, "kind", "escape") == "grid" or not _build.on_card(device):
        yield ("torch", {})
        return
    unrolls = _build.UNROLLS[::2] if tiny else _build.UNROLLS
    if kernel == "dwell":
        blocks = _build.EX_BLOCKS[:1] if tiny else _build.EX_BLOCKS
        for u in unrolls:
            for blk in blocks:
                yield ("cuda", {"block": blk, "unroll": u})
    elif kernel in ("perimeter_query", "region_dwell", "region_dwell_pooled"):
        for u in unrolls:
            yield ("cuda", {"unroll": u})
    else:  # data movement and scans: the kernel is the only candidate
        yield ("cuda", {})


def _bounds_of(workload):
    from repro_torch.kernels import ref
    return (tuple(workload.default_bounds) if workload is not None
            else ref.DEFAULT_BOUNDS)


def _inputs(kernel: str, *, workload=None, device="cuda", **sig: Any) -> dict:
    """The inputs a runner of ``kernel`` times, as JAX's runner draws them
    (numpy ``default_rng(0)``): up to 64 random regions (rows) of the
    signature's side, random flags, zero canvases; on ``device``."""
    from repro_torch.kernels import ops
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
    if kernel == "olt_compact":
        return dict(flags=t(rng.integers(0, 2, size=int(sig["n"]))))
    if kernel == "dwell":
        return {}
    side, n = int(sig["side"]), int(sig["n"])
    regions = n // side
    if kernel in ("perimeter_query", "region_dwell"):
        N = min(64, regions * regions)
        coords = t(rng.integers(0, regions, size=(N, 2)))
        return dict(coords=coords, count=t([N]),
                    canvas=torch.zeros((n, n), dtype=torch.int32, device=dev))
    F = int(sig["F"])
    N = min(64, F * regions * regions)
    rows = t(np.stack([rng.integers(0, F, size=N),
                       rng.integers(0, regions, size=N),
                       rng.integers(0, regions, size=N)], axis=1))
    canvas = torch.zeros((F * n, n), dtype=torch.int32, device=dev)
    out = dict(rows=rows, count=t([N]), canvas=canvas)
    if kernel == "region_fill_pooled":
        out["values"] = t(rng.integers(0, 256, size=N))
    else:
        out["planes"] = ops.pooled_planes(
            n, np.tile(np.asarray(_bounds_of(workload), np.float32), (F, 1)),
            dev)
    return out


def _build_runner(kernel: str, impl: str, params: Dict[str, Any], *,
                  workload=None, device="cuda", inputs=None, **sig: Any):
    """A zero-arg callable that runs one candidate on ``inputs``
    (``_inputs`` when None) and returns its output: the image, the
    query's answers, the scan's ranks and count, or the canvas that a
    region kernel writes in place."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.policy import KernelPolicy
    if kernel not in _TUNABLE:
        raise ValueError(f"no runner for kernel {kernel!r}")
    if inputs is None:
        inputs = _inputs(kernel, workload=workload, device=device, **sig)
    pol = KernelPolicy(backend=impl, overrides={kernel: params} if params else {})
    x = inputs
    if kernel == "dwell":
        n, md = int(sig["n"]), int(sig["max_dwell"])
        return lambda: ops.mandelbrot(n, bounds=_bounds_of(workload),
                                      max_dwell=md, workload=workload,
                                      device=device, policy=pol)
    if kernel == "olt_compact":
        return lambda: ops.compact_ranks(x["flags"], policy=pol)
    side, n = int(sig["side"]), int(sig["n"])
    if kernel == "perimeter_query":
        return lambda: ops.perimeter_query(
            x["coords"], x["count"], side=side, n=n, bounds=_bounds_of(workload),
            max_dwell=int(sig["max_dwell"]), workload=workload, policy=pol)
    if kernel == "region_dwell":
        return lambda: ops.region_dwell(
            x["canvas"], x["coords"], x["count"], side=side, n=n,
            bounds=_bounds_of(workload), max_dwell=int(sig["max_dwell"]),
            workload=workload, policy=pol)
    if kernel == "region_fill_pooled":
        return lambda: ops.region_fill_pooled(
            x["canvas"], x["rows"], x["values"], x["count"], side=side, n=n,
            policy=pol)
    return lambda: ops.region_dwell_pooled(
        x["canvas"], x["rows"], x["count"], x["planes"], side=side, n=n,
        max_dwell=int(sig["max_dwell"]), workload=workload, policy=pol)


def _snapshot(out):
    """A copy of a runner's output (a tensor or a tuple of tensors)."""
    if isinstance(out, torch.Tensor):
        return (out.clone(),)
    return tuple(o.clone() for o in out)


def _host_us(run, reps: int) -> float:
    run()  # warm
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        run()
        best = min(best, (time.perf_counter() - t0) * 1e6)
    return best


_STREAMS: dict = {}  # device index -> the stream of the timing graphs


def _device_us(run, reps: int, device: torch.device) -> float:
    """Device time of one call on the card: a CUDA graph of back-to-back
    calls (about a millisecond of them) replayed ``reps`` times, timed with
    CUDA events; the best replay over its calls. Warmed on the capture
    stream first (the scan makes its look-back scratch there)."""
    stream = _STREAMS.get(device.index)
    if stream is None:
        stream = _STREAMS[device.index] = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with torch.cuda.stream(stream):
        run()
        start.record(stream)
        run()
        end.record(stream)
    end.synchronize()
    calls = max(1, min(20, math.ceil(1.0 / max(start.elapsed_time(end), 1e-3))))
    graph = torch.cuda.CUDAGraph()
    with _build.keeping_captured(), torch.cuda.graph(graph, stream=stream):
        for _ in range(calls):
            run()
    best = float("inf")
    with torch.cuda.stream(stream):
        graph.replay()
        for _ in range(max(1, reps)):
            start.record(stream)
            graph.replay()
            end.record(stream)
            end.synchronize()
            best = min(best, start.elapsed_time(end) * 1e3 / calls)
    torch.cuda.current_stream(device).wait_stream(stream)
    del graph
    return best


def tune(kernel: str, *, workload=None, cache: Optional[TuningCache] = None,
         reps: int = 3, tiny: bool = False, device="cuda",
         report: Optional[list] = None, **sig: Any) -> Choice:
    """Time every candidate of one (kernel, signature) on ``device`` and
    return the winner as a ``Choice(source="measured")``, recorded in
    ``cache``. Each candidate's output must equal the default schedule's
    (``heuristic``) bit for bit, or this raises. ``report``, a list, gets
    one dict a candidate: its params, time and whether it is the default."""
    dev = torch.device(device)
    on_card = _build.on_card(dev)
    inputs = _inputs(kernel, workload=workload, device=dev, **sig)
    canvas = inputs.get("canvas")
    default = heuristic(kernel, workload=workload, device=dev, **sig)

    def runner(impl, params):
        return _build_runner(kernel, impl, params, workload=workload,
                             device=dev, inputs=inputs, **sig)

    def output(run):  # on a zeroed canvas, for the region kernels
        if canvas is not None:
            canvas.zero_()
        return _snapshot(run())

    want = output(runner(default.impl, default.param_dict()))
    best: Optional[Choice] = None
    for impl, params in _candidates(kernel, workload=workload, tiny=tiny,
                                    device=dev, **sig):
        cand = Choice(impl, tuple(sorted(params.items())), source="measured")
        is_default = (cand.impl, cand.params) == (default.impl, default.params)
        run = runner(impl, params)
        if not is_default:
            bad = [i for i, (g, w) in enumerate(zip(output(run), want))
                   if not torch.equal(g, w)]
            if bad:
                raise RuntimeError(
                    f"tune({kernel!r}, {sig}): schedule {impl} {params} "
                    f"differs from the default {default.param_dict()} in "
                    f"output(s) {bad}")
        us = _device_us(run, reps, dev) if on_card else _host_us(run, reps)
        cand = dataclasses.replace(cand, us=us)
        if report is not None:
            report.append(dict(params=params, us=us, default=is_default))
        if best is None or us < best.us:
            best = cand
    assert best is not None
    if cache is not None:
        cache.put(cache_key(kernel, workload=workload, device=dev, **sig), best)
    return best


def tune_problem(problem, *, cache: Optional[TuningCache] = None,
                 reps: int = 3, tiny: bool = False, pooled_frames: int = 0,
                 report: Optional[dict] = None) -> TuningCache:
    """Tune every kernel the ASK pipeline launches for ``problem``, on its
    device: Ex at ``n``, Q and A at every level side (the first and the
    last with ``tiny``), and the OLT scan at each ring capacity of
    ``scan_capacities``. With ``pooled_frames`` F > 0, also the pooled
    engine's banded kernels: T at every side, A at the leaf side (signature
    (side, n, F)), and the scan at the F-scaled capacities. Returns the
    (possibly pre-seeded) cache with the winners added. ``report``, a dict,
    gets each tuned key's candidates (``tune``'s ``report``)."""
    from repro_torch.core.ask import scan_capacities

    cache = cache if cache is not None else TuningCache()
    wl, dev = problem.workload, problem.device
    n, max_dwell = problem.n, problem.max_dwell

    def run(kernel, **sig):
        rows = []
        best = tune(kernel, workload=wl, cache=cache, reps=reps, tiny=tiny,
                    device=dev, report=rows, **sig)
        if report is not None:
            report[cache_key(kernel, workload=wl, device=dev, **sig)] = dict(
                candidates=rows, winner=best.param_dict(), us=best.us)

    run("dwell", n=n, max_dwell=max_dwell)
    side = n // problem.g
    sides = []
    while side >= problem.B:
        sides.append(side)
        if side == problem.B:
            break
        side //= problem.r
    if tiny:
        sides = sides[:1] + sides[-1:] if len(sides) > 1 else sides
    for side in sides:
        for kernel in ("perimeter_query", "region_dwell"):
            run(kernel, side=side, n=n, max_dwell=max_dwell)
    caps = scan_capacities(n, problem.g, problem.r, problem.B)
    cap_sizes = sorted({int(c) for c in caps})
    if tiny:
        cap_sizes = cap_sizes[-1:]
    for cap in cap_sizes:
        run("olt_compact", n=cap)
    F = int(pooled_frames)
    if F > 0:
        for side in sides:
            run("region_fill_pooled", side=side, n=n, F=F)
        leaf = sides[-1] if sides else problem.B
        run("region_dwell_pooled", side=leaf, n=n, F=F, max_dwell=max_dwell)
        for cap in cap_sizes:
            run("olt_compact", n=F * cap)
    return cache


# ---------------------------------------------------------------------------
# CLI


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Sweep kernel schedules and write a JSON tuning cache")
    ap.add_argument("--out", required=True, help="tuning cache JSON path")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--max-dwell", type=int, default=128)
    ap.add_argument("--g", type=int, default=4)
    ap.add_argument("--r", type=int, default=2)
    ap.add_argument("--B", type=int, default=16)
    ap.add_argument("--workloads", default="mandelbrot",
                    help="comma-separated registry names")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tiny", action="store_true",
                    help="reduced candidate sweep (CI smoke)")
    ap.add_argument("--pooled-frames", type=int, default=0,
                    help="also sweep the banded pooled kernels for this "
                         "many frames (0 = skip the pooled tier)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card's schedules) or cpu (the plain "
                         "versions)")
    args = ap.parse_args(argv)

    from repro_torch.workloads import FrameProblem

    cache = TuningCache()
    for name in args.workloads.split(","):
        name = name.strip()
        problem = FrameProblem(n=args.n, g=args.g, r=args.r, B=args.B,
                               max_dwell=args.max_dwell, workload=name,
                               device=args.device)
        tune_problem(problem, cache=cache, reps=args.reps, tiny=args.tiny,
                     pooled_frames=args.pooled_frames)
        print(f"tuned {name}: {len(cache.entries)} entries total")
    out = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out, exist_ok=True)
    cache.save(args.out)
    print(f"wrote {args.out} ({len(cache.entries)} entries, "
          f"platform={platform(args.device)})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
