"""The frames mesh: the devices a sharded frame batch is spread over.

Counterpart of ``make_frames_mesh`` in ``repro/launch/mesh.py``. The
production meshes (``make_production_mesh``, ``make_mesh``, ``data_axes``,
``model_axes``) come with ROADMAP queue 1 slice 14.8.

JAX's frames mesh is a ``jax.sharding.Mesh`` over which one GSPMD program
is partitioned. The port's is the tuple of devices that a batch's shards
run on, one shard a device, frame-major (``core.ask.
dispatch_ask_scan_sharded``, ``core.pooled.dispatch_ask_pooled_sharded``).
Building one touches no device state beyond counting the cards.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = ["FRAMES_AXIS", "FramesMesh", "make_frames_mesh"]

FRAMES_AXIS = "frames"


@dataclasses.dataclass(frozen=True)
class FramesMesh:
    """The devices of a frames mesh, in shard order, and its axis names
    (one, for a frames mesh; the sharded engines refuse any other)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (FRAMES_AXIS,)

    @property
    def size(self) -> int:
        """The number of shards: JAX's ``mesh.devices.size``."""
        return len(self.devices)


def make_frames_mesh(num_devices: Optional[int] = None, *,
                     axis_name: str = FRAMES_AXIS,
                     device="cuda") -> FramesMesh:
    """1-D mesh for sharded frame rendering (``solve_batch(..., mesh=)``).

    On the card (``device="cuda"``, the default) the mesh is the first
    ``num_devices`` visible CUDA devices, every one of them by default; it
    raises when there is no card, and when more devices are asked for than
    are visible. ``device="cpu"`` builds ``num_devices`` (default 1) CPU
    shards, which run one after another: the port's counterpart of JAX's
    forced host device count, for the tests.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_frames_mesh: torch.cuda.is_available() is False; pass "
                "device='cpu' for a mesh of CPU shards")
        visible = torch.cuda.device_count()
        n = visible if num_devices is None else int(num_devices)
        if not 1 <= n <= visible:
            raise ValueError(
                f"make_frames_mesh: {n} devices asked, {visible} visible")
        devices = tuple(torch.device("cuda", i) for i in range(n))
    elif dev.type == "cpu":
        n = 1 if num_devices is None else int(num_devices)
        if n < 1:
            raise ValueError(f"make_frames_mesh: {n} devices asked")
        devices = (torch.device("cpu"),) * n
    else:
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return FramesMesh(devices, (axis_name,))
