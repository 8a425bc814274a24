"""One frame a request: ``solve(FrameProblem(..., bounds=w), **engine)``
with the configuration's ``engine`` options (``ask_scan``: one CUDA graph
for every window)."""

from __future__ import annotations

from typing import Iterator

import torch

from bench.yardstick.entries import Done, problem, sync
from bench.yardstick.traffic import Frame


class Entry:
    spelling = "static"
    kernels = dict(query=("perimeter_query_kernel",),
                   fill=("fill_kernel",),
                   leaf=("region_dwell_kernel", "region_dwell_items_kernel"),
                   scan=("scan_kernel",))

    def __init__(self, config: dict, mix: dict, device, chips: int):
        self.config, self.device = config, device
        self.engine = dict(config["engine"])
        self.frames: Iterator[Frame] = iter(())

    def start(self, frames: Iterator[Frame]) -> None:
        self.frames = frames

    def render(self, frame: Frame):
        from repro_torch.workloads import solve
        return solve(problem(self.config, self.device, frame.bounds),
                     **self.engine)

    def request(self) -> Done:
        frame = next(self.frames)
        canvas, st = self.render(frame)
        sync(self.device)
        return Done([frame], [canvas], st.overflow_dropped, None)

    def rerender(self, frames) -> Iterator[torch.Tensor]:
        for frame in frames:
            yield self.render(frame)[0]

    def close(self) -> None:
        sync(self.device)
        if torch.device(self.device).type == "cuda":
            from repro_torch.core import graphs
            graphs.release()
