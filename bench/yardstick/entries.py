"""How requests reach the program: one entry per way a user calls it,
each in a file of its own, ``bench/entries/<entry>.py``, found by the name
that a traffic mix gives (``"entry"``).

An entry file holds a class ``Entry(config, mix, device, chips)``, which
sends one request at a time (a closed loop), waits until its canvases are
complete on the device, and returns a ``Done``:

* ``start(frames)``: the frame stream of the run;
* ``request()``: the next request's ``Done``;
* ``rerender(frames)``: each frame's canvas again, by the path the window
  timed, for the work behind the rooflines (after the window);
* ``close()``: the requests in flight dropped, the device idle.

Its ``spelling`` is how the program receives the windows
(``bench.reference.escape.plane``), which the reference follows; its
``kernels`` names, by role, the device functions of the layers that the
entry drives: a traced window that shows none of a role fails.
"""

from __future__ import annotations

from typing import List, NamedTuple

import torch

from bench.yardstick import named
from bench.yardstick.traffic import Frame


class Done(NamedTuple):
    frames: List[Frame]
    canvases: list  # one [n, n] tensor a frame, on the device
    dropped: int  # regions the program dropped (overflow)
    chunk: object  # the service's ChunkStats, or None


def load(name: str):
    """The ``Entry`` class of ``bench/entries/<name>.py``."""
    return named.load("entries", name).Entry


def problem(config: dict, device, bounds=None):
    """The program's ``FrameProblem`` of a configuration."""
    from repro_torch.workloads import FrameProblem
    return FrameProblem(n=config["n"], g=config["g"], r=config["r"],
                        B=config["B"], max_dwell=config["max_dwell"],
                        workload=config["workload"], bounds=bounds,
                        device=device)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
