"""One chunk a request: ``RenderService(problem, **mix["service"])
.stream_chunks(frames)`` over a frames mesh of the cell's cards; a request
runs from the consumer's ``next()`` to its canvases ready on the
device."""

from __future__ import annotations

import collections
from typing import Iterator

import torch

from bench.yardstick.entries import Done, problem, sync
from bench.yardstick.traffic import Frame


class Entry:
    spelling = "traced"
    kernels = dict(query=("perimeter_query_pooled_kernel",),
                   fill=("fill_kernel",),
                   leaf=("region_dwell_pooled_kernel",),
                   scan=("scan_kernel",))

    def __init__(self, config: dict, mix: dict, device, chips: int):
        from repro_torch.launch.mesh import make_frames_mesh
        from repro_torch.launch.render_service import RenderService
        self.device = device
        kind = torch.device(device).type
        mesh = make_frames_mesh(chips if kind == "cuda" else 1, device=kind)
        self.service = RenderService(problem(config, device), mesh=mesh,
                                     **mix["service"])
        self.fed: collections.deque = collections.deque()
        self.chunks = iter(())

    def _feed(self, frames: Iterator[Frame]):
        for f in frames:
            self.fed.append(f)
            yield f.bounds

    def _next(self):
        res = next(self.chunks)
        if res.ready is not None:
            res.ready.synchronize()
        else:
            sync(self.device)
        return res

    def start(self, frames: Iterator[Frame]) -> None:
        self.chunks = self.service.stream_chunks(self._feed(frames))

    def request(self) -> Done:
        res = self._next()
        f = res.chunk.frames
        frames = [self.fed.popleft() for _ in range(f)]
        return Done(frames, [res.canvases[j] for j in range(f)],
                    res.stats.overflow_dropped, res.chunk)

    def rerender(self, frames) -> Iterator[torch.Tensor]:
        """The window's frames streamed again through the same service
        (its estimator as the window left it), once the chunks still in
        flight are dropped."""
        self.close()
        self.start(iter(frames))
        while True:
            try:
                res = self._next()
            except StopIteration:
                break
            for j in range(res.chunk.frames):
                yield res.canvases[j]
        self.fed.clear()

    def close(self) -> None:
        self.chunks.close()  # the chunks in flight are dropped
        sync(self.device)
