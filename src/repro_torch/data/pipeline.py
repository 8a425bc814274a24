"""Data pipeline: a deterministic synthetic LM stream with prefetch.

Counterpart of ``repro/data/pipeline.py``, in numpy (the JAX package's is
numpy too): byte for byte the same batches. The stream is a pure function
of (seed, step), so a restart replays it exactly from the checkpoint's
step; ``host_slice`` gives one host's rows of the global batch; a
one-slot background thread synthesises the next batch while the device
computes. The trainer moves each batch to the device.

Synthetic text: Zipf-distributed unigrams with shifted repeats, so the
loss is non-trivial and learnable (the repeat structure) without a corpus.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeCase

__all__ = ["SyntheticLMData", "make_pipeline"]


@dataclasses.dataclass
class SyntheticLMData:
    cfg: ArchConfig
    case: ShapeCase
    seed: int = 0

    def batch_at(self, step: int) -> dict:
        """Pure function of step -> the full global batch."""
        return self._slice(step, 0, self.case.global_batch)

    def host_slice(self, step: int, host_index: int, num_hosts: int) -> dict:
        per = self.case.global_batch // num_hosts
        return self._slice(step, host_index * per, per)

    def _slice(self, step: int, start: int, count: int) -> dict:
        """{"tokens", "labels"} int32 [count, S] (+ "media" f32: vision
        [count, num_media_tokens, D], audio frames [count, S, D])."""
        V = self.cfg.vocab_size
        S = self.case.seq_len
        rows = []
        labels = []
        for b in range(start, start + count):
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, b]))
            # Zipf-ish unigrams with an embedded repeat for learnable signal
            base = (rng.zipf(1.3, size=S + 1) - 1) % V
            rep = int(rng.integers(2, max(3, min(64, S))))
            base[rep:] = np.where(rng.random(S + 1 - rep) < 0.5,
                                  base[:-rep], base[rep:])
            rows.append(base[:-1])
            labels.append(base[1:])
        out = {"tokens": np.asarray(rows, np.int32),
               "labels": np.asarray(labels, np.int32)}
        if self.cfg.frontend == "vision":
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, 7]))
            out["media"] = rng.standard_normal(
                (count, self.cfg.num_media_tokens, self.cfg.d_model),
                dtype=np.float32) * 0.02
        elif self.cfg.frontend == "audio":
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, step, 7]))
            out["media"] = rng.standard_normal(
                (count, S, self.cfg.d_model), dtype=np.float32) * 0.02
        return out


def make_pipeline(data: SyntheticLMData, start_step: int,
                  *, prefetch: int = 1,
                  stop_step: Optional[int] = None) -> Iterator[tuple]:
    """Background-threaded prefetch iterator of (step, batch) from
    ``start_step`` (to ``stop_step``, exclusive). A failure in the
    producer is raised in the consumer; closing the iterator stops the
    producer."""
    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()

    def producer():
        step = start_step
        try:
            while not stop.is_set() and (stop_step is None or
                                         step < stop_step):
                q.put((step, data.batch_at(step)))
                step += 1
            q.put(None)
        except BaseException as e:  # surface, never deadlock the consumer
            q.put(("__error__", e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if item[0] == "__error__":
                raise RuntimeError("data producer failed") from item[1]
            yield item
    finally:
        stop.set()
