"""Run one cell of the benchmark once and print its result's line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for (``BENCHMARK.json``). The last line of standard output is the result
(JSON); the numbers the check compared, each beside its limit, are the
last lines of standard error. Exits non-zero, printing no result, without
the cards, when a forbidden module is loaded, or when anything fails.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def process_start() -> float:
    """The process's start on the wall clock (``time.time()``)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1]
                    .split()[19])
        boot = next(float(line.split()[1]) for line in
                    Path("/proc/stat").read_text().splitlines()
                    if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


START = process_start()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench.yardstick import harness, imports
    cell = harness.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            " visible")
        return 2
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         device="cuda", process_start=START, log=log)
    found = imports.forbidden_loaded()
    if found:
        log(f"forbidden modules loaded in the run's process: {found}")
        return 3
    if args.trace:
        # the rooflines are shares of the published peaks at 700 W
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        log(f"card: {card}")
        result["card"] = card
    checks = result.pop("checks")
    for name, c in checks.items():
        bound = "at least" if name in harness.AT_LEAST else "at most"
        log(f"check {name}: {c['value']} ({bound} {c['limit']})")
    result["checks"] = checks  # last key of the line
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
