"""Fault-tolerant checkpointing: atomic, manifest-verified, with retention.

Counterpart of ``repro/checkpoint/checkpointer.py``, with its semantics: a
checkpoint is written into a temporary directory and becomes visible by
an atomic rename; its ``manifest.json`` holds every leaf's file, shape,
dtype and sha1, and ``steps``/``latest_step`` report only checkpoints
whose manifest verifies, so a restore lands on the newest consistent
state. ``keep`` newest checkpoints are retained, older ones removed.

A tree is nested dicts whose leaves are tensors, or an ``nn.Module``
(its parameters, by name): the trainer's state is {"params": the model,
"opt": {"master", "m", "v": dicts by parameter name, "step"}[, "residual"]}.
A leaf's key is its path joined by "/" (a parameter's dots become "/").
Each leaf is stored whole as one ``.npy``; a bfloat16 leaf (numpy has
no bfloat16) as its raw 16 bits, with "bfloat16" in the manifest, and
viewed back on restore, bit for bit.

Elastic restarts: leaves are stored unsharded, so a checkpoint written
on one mesh restores onto another. ``save`` of a sharded state (DTensor
leaves, the sharded train step's) gathers each leaf on every rank, and
only rank 0 writes; then every rank meets at a barrier, so none reads a
half-written step. ``restore(..., shardings=)`` places each leaf onto the
*current* mesh (``launch.sharding.distribute``), as JAX's
``jax.device_put`` against the new mesh does.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor

__all__ = ["Checkpointer"]

_BF16 = "bfloat16"


def _key(prefix: str, name) -> str:
    """The key of ``name`` under ``prefix``: the path joined by "/"."""
    name = str(name).replace(".", "/")
    return f"{prefix}/{name}" if prefix else name


def _flatten(tree, prefix: str = "") -> dict:
    """{key: leaf} in the tree's order; a module contributes its
    parameters."""
    if isinstance(tree, nn.Module):
        items = tree.named_parameters()
    elif isinstance(tree, dict):
        items = tree.items()
    else:
        return {prefix: tree}
    flat = {}
    for k, v in items:
        flat.update(_flatten(v, _key(prefix, k)))
    return flat


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _to_numpy(t: torch.Tensor) -> tuple:
    """(array, manifest dtype) of a tensor, moved to the host."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), _BF16
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class Checkpointer:
    def __init__(self, directory, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- write ---------------------------------------------------------------

    def save(self, step: int, tree: Any, extra: Optional[dict] = None) -> Path:
        """Write ``tree`` as step ``step``. With a process group up, every
        rank calls this (a DTensor leaf is gathered by all), only rank 0
        writes, and all return after a barrier."""
        final = self.dir / f"step_{step:010d}"
        writer = not _distributed() or dist.get_rank() == 0
        tmp = self.dir / f".tmp-{step}-{os.getpid()}-{time.time_ns()}"
        if writer:
            tmp.mkdir(parents=True)
        manifest = {"step": int(step), "extra": extra or {}, "leaves": {}}
        for key, leaf in _flatten(tree).items():
            if isinstance(leaf, DTensor):
                leaf = leaf.full_tensor()
            if not writer:
                continue
            arr, dtype = _to_numpy(leaf)
            fname = hashlib.sha1(key.encode()).hexdigest()[:16] + ".npy"
            np.save(tmp / fname, arr)
            manifest["leaves"][key] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": dtype,
                "sha1": _file_sha1(tmp / fname),
            }
        if writer:
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)  # atomic visibility
            self._gc()
        if _distributed():
            dist.barrier()
        return final

    # -- read ----------------------------------------------------------------

    def _verify(self, path: Path) -> Optional[dict]:
        mf = path / "manifest.json"
        if not mf.exists():
            return None
        try:
            manifest = json.loads(mf.read_text())
            for key, meta in manifest["leaves"].items():
                f = path / meta["file"]
                if not f.exists() or _file_sha1(f) != meta["sha1"]:
                    return None
            return manifest
        except (json.JSONDecodeError, KeyError, OSError):
            return None

    def steps(self) -> list:
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if self._verify(p) is not None:
                out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: int, like: Any, device=None,
                shardings: Any = None) -> Any:
        """The checkpoint in the structure of ``like``. A tensor leaf of
        ``like`` gives the shape and dtype (one on the ``meta`` device
        only those, as JAX's ShapeDtypeStruct) and becomes a new tensor
        on ``device`` (default: the leaf's own device, the CPU for
        ``meta``); a module's parameters are filled in place (a module on
        ``meta`` is first allocated on ``device``). With ``shardings``
        (``launch.sharding.NamedSharding``s in ``like``'s layout, on the
        current mesh) each tensor leaf that has one becomes a DTensor: the
        elastic path, the writer's mesh may differ. Raises if the
        checkpoint does not verify, lacks a leaf or a shape differs."""
        path = self.dir / f"step_{step:010d}"
        manifest = self._verify(path)
        if manifest is None:
            raise FileNotFoundError(f"no verifiable checkpoint at {path}")

        def load(key: str, spec: torch.Tensor) -> torch.Tensor:
            meta = manifest["leaves"].get(key)
            if meta is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = np.load(path / meta["file"])
            if tuple(arr.shape) != tuple(spec.shape):
                raise ValueError(
                    f"{key}: checkpoint shape {arr.shape} != {tuple(spec.shape)}")
            return _from_numpy(arr, meta["dtype"]).to(spec.dtype)

        def place(spec: torch.Tensor):
            if device is not None:
                return torch.device(device)
            return torch.device("cpu") if spec.is_meta else spec.device

        def build(tree, prefix: str, sh=None):
            if isinstance(tree, nn.Module):
                first = next(tree.parameters(), None)
                if first is not None and first.is_meta:
                    tree.to_empty(device=place(first))
                with torch.no_grad():
                    for n, p in tree.named_parameters():
                        p.copy_(load(_key(prefix, n), p))
                return tree
            if isinstance(tree, dict):
                return {k: build(v, _key(prefix, k),
                                 None if sh is None else sh.get(k))
                        for k, v in tree.items()}
            t = load(prefix, tree).to(place(tree))
            if sh is None or t.ndim == 0:  # a scalar stays whole on every rank
                return t
            from repro_torch.launch.sharding import distribute
            return distribute(t, sh)

        return build(like, "", shardings)

    def manifest_extra(self, step: int) -> dict:
        path = self.dir / f"step_{step:010d}"
        manifest = self._verify(path)
        if manifest is None:
            raise FileNotFoundError(path)
        return manifest.get("extra", {})

    # -- retention -----------------------------------------------------------

    def _gc(self):
        steps = self.steps()
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)


def _file_sha1(path: Path) -> str:
    h = hashlib.sha1()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()
