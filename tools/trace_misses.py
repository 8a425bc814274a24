#!/usr/bin/env python3
"""How often a CUDA graph's replay goes missing from a torch.profiler
trace, for two ways of taking the trace.

    python3 tools/trace_misses.py [--traces N]

Needs one card and nvcc; builds the kernel libraries first. On chip_smoke's
phase-(e) problems (n=16384, g=4, r=2, B=32, max_dwell=512), the
one-dispatch engines of each workload (``ask_fused``, then ``ask_scan``
at ``safety_factor=1e9``, the four workloads in turn, as phase (e) traces
them) are traced N times in all each way, the ways in turns. Before
each trace the graphs are released, so the first call captures the graph
anew:

* ``warmup``: the capture runs in the warm-up step of a scheduled profiler
  session (``schedule(wait=0, warmup=1, active=1)``) and the replay in its
  active step;
* ``session``: the capture runs in a recording session of its own and the
  replay in a second one (``chip_smoke.replay_trace``).

Between the capture and the traced replay the graph's static outputs are
poisoned (filled with -1), so the traced call's canvas equals the
capturing call's only if its replay ran. A trace *misses* when one of the
replay's kernels (Q, T, A, the scan) does not show by name. Prints one
JSON line a way: traces, misses, and for each miss its device activities
and whether the replay ran; then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402


def poison() -> None:
    from repro_torch.core import graphs
    for entry in graphs._GRAPHS.values():
        for t in entry.outputs:
            t.fill_(-1)
    torch.cuda.synchronize()


def trace(fn, way: str) -> dict:
    """One trace of ``fn``'s replay, its graph captured ``way``."""
    from repro_torch.core import graphs
    from torch.profiler import ProfilerActivity, profile, schedule
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    graphs.release()
    if way == "session":
        with profile(activities=activities):
            first = cs.fingerprints(fn())
            torch.cuda.synchronize()
        poison()
        with profile(activities=activities) as prof:
            got = cs.fingerprints(fn())
            torch.cuda.synchronize()
    else:
        with profile(activities=activities, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1)) as prof:
            first = cs.fingerprints(fn())  # the warm-up step: the capture
            torch.cuda.synchronize()
            poison()
            prof.step()
            got = cs.fingerprints(fn())  # the active step: a replay
            torch.cuda.synchronize()
            prof.step()
    names, _, count = cs.device_activities(prof)
    missing = sorted(k for k, part in cs.REPLAY_KERNELS.items()
                     if not any(part in name for name in names))
    return dict(missing=missing, activities=count, replay_ran=got == first)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--traces", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_misses: needs an NVIDIA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.workloads import FrameProblem, solve
    _build.build()
    dev = torch.device("cuda", 0)
    calls = [(wl, m, kw) for wl in cs.WORKLOADS for m, kw in cs.ENGINES]
    problems = {wl: FrameProblem(**cs.FULL, workload=wl, device=dev)
                for wl in cs.WORKLOADS}

    rows = {way: dict(traces=0, misses=[]) for way in ("warmup", "session")}
    for i in range(args.traces):
        wl, method, kw = calls[i % len(calls)]

        def fn(p=problems[wl], method=method, kw=kw):
            return solve(p, method, **kw)

        for way in (("warmup", "session") if i % 2 == 0
                    else ("session", "warmup")):
            t = trace(fn, way)
            t.update(workload=wl, engine=method)
            rows[way]["traces"] += 1
            if t["missing"]:
                rows[way]["misses"].append(dict(trace=i, **t))
            elif not t["replay_ran"]:
                raise RuntimeError(f"trace {i} ({way}): the replay's "
                                   "outputs differ from the capture's")
    for way, row in rows.items():
        print(json.dumps(dict(way=way, traces=row["traces"],
                              miss_count=len(row["misses"]),
                              misses=row["misses"])))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
