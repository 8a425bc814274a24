"""The check's control at a cell's own size: the plain reference computed
below the configuration's precision, put in the program's place, through
the harness's own run and comparison.

    python3 bench/control.py --workload <cell> --seeds 1 2 3

For each seed and each control (``bench.reference.escape.VARIANTS``
below f32), one run of the cell whose entry renders every request's frame
by the control: set-up skips the warm frames (the control has nothing to
warm), the window is one request at the traffic's first timed frame, and
the harness's check then compares as a run does. Each run's line is
printed: a sound check gives ``correct`` false. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_entry(variant: str):
    """An entry factory whose requests are the reference's frames under
    ``variant``, spelled as the cell's own entry spells them."""
    from bench.reference import mariani_silver as ms
    from bench.yardstick import entries, traffic

    class Control:
        kernels: dict = {}

        def __init__(self, config, mix, device, chips):
            self.config, self.device = config, device
            self.spelling = entries.load(mix["entry"]).spelling
            self.warm = traffic.warm_frames(mix)

        def start(self, frames):
            self.frames = frames

        def request(self):
            if self.warm:  # the warm frames, taken and not rendered
                frames = [next(self.frames) for _ in range(self.warm)]
                self.warm = 0
                return entries.Done(frames, [], 0, None)
            frame = next(self.frames)
            c = self.config
            canvas = ms.render(c["n"], c["g"], c["r"], c["B"],
                               c["max_dwell"], c["workload"], frame.bounds,
                               self.spelling, params=c, device=self.device,
                               variant=variant)
            return entries.Done([frame], [canvas], 0, None)

        def close(self):
            pass

    return Control


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench.reference import escape
    from bench.yardstick import harness
    cell = harness.load_cell(args.workload, ROOT)
    for seed in args.seeds:
        for variant in escape.VARIANTS[1:]:
            t0 = time.perf_counter()
            res = harness.run(cell, seed, 1e-3, False, device=args.device,
                              process_start=time.time(),
                              log=lambda m: print(m, file=sys.stderr),
                              entry_factory=control_entry(variant))
            print(json.dumps(dict(workload=cell.name, seed=seed,
                                  control=variant, correct=res["correct"],
                                  failed=res["failed"],
                                  checks=res["checks"],
                                  seconds=time.perf_counter() - t0)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
