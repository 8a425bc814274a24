"""Meshes: the frames mesh, and the production and test meshes of the
language models.

Counterpart of ``repro/launch/mesh.py``.

JAX's frames mesh is a ``jax.sharding.Mesh`` over which one GSPMD program
is partitioned. The port's is the tuple of devices that a batch's shards
run on, one shard a device, frame-major (``core.ask.
dispatch_ask_scan_sharded``, ``core.pooled.dispatch_ask_pooled_sharded``).
Building one touches no device state beyond counting the cards.

The models' meshes are ``torch.distributed`` ``DeviceMesh``es, one
process a rank: ``make_mesh`` and ``make_production_mesh`` need a process
group that is already up (NCCL on the card, gloo on the CPU; the CLIs
bring one up from ``torchrun``'s environment with ``init_distributed``)
and raise without one. Single pod: (data=16, model=16); multi-pod:
(pod=2, data=16, model=16), the ``pod`` axis carrying only data-parallel
reductions; ``model_split=s`` factors the model axis into (model_a=s,
model_b=16//s). ``AbstractMesh`` holds a mesh's axis names and sizes
and nothing else (JAX's ``AbstractMesh``): the sharding rules
(``launch/sharding.py``) are functions of those, so a 256- or 512-rank
mesh's specs are computed in one process. ``mesh_shape``, ``data_axes``
and ``model_axes`` read either kind.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Dict, Optional, Tuple

import torch

__all__ = ["FRAMES_AXIS", "FramesMesh", "make_frames_mesh", "MODEL_AXIS",
           "DATA_AXES", "AbstractMesh", "production_mesh_shape",
           "make_production_mesh", "make_mesh", "mesh_shape", "data_axes",
           "model_axes", "init_distributed"]

FRAMES_AXIS = "frames"
MODEL_AXIS = "model"
DATA_AXES = ("pod", "data")  # superset; data_axes(mesh) filters per mesh


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


# -- the models' meshes ------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis sizes and names, with no devices and no process
    group (JAX's ``AbstractMesh``): what the sharding rules read."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"{self.axis_sizes} sizes for axes {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, in mesh order: JAX's ``mesh.shape``."""
        return dict(zip(self.axis_names, self.axis_sizes))


def production_mesh_shape(*, multi_pod: bool = False,
                          model_split: Optional[int] = None):
    """(shape, axis names) of ``make_production_mesh``'s mesh."""
    if model_split:
        ms = (model_split, 16 // model_split)
        shape = (2, 16, *ms) if multi_pod else (16, *ms)
        axes = (("pod", "data", "model_a", "model_b") if multi_pod
                else ("data", "model_a", "model_b"))
        return shape, axes
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False,
                         model_split: Optional[int] = None, device="cuda"):
    """Default: (data, model) = (16, 16) per pod. ``model_split=s``
    factors the model axis into (model_a=s, model_b=16//s): 2-D tensor
    parallelism for archs whose head count doesn't divide 16 (whisper's
    20 heads shard 4-way on model_a). Needs a process group of 256 (512
    with ``multi_pod``) ranks; ``AbstractMesh(*production_mesh_shape(...))``
    is the same mesh's shape without one."""
    return make_mesh(*production_mesh_shape(multi_pod=multi_pod,
                                            model_split=model_split),
                     device=device)


def make_mesh(shape, axes, *, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` with axis names ``axes`` over the
    ranks of the process group that is up (rank r at the r-th position
    in row-major order). Raises when no process group is up, when its
    world size is not the mesh's size, and on ``device="cuda"`` when there
    is no card."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} with axes {axes}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: torch.cuda.is_available() is False; "
                           "pass device='cpu' for a mesh of CPU ranks (gloo)")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            f"make_mesh{shape}: no process group is up (init_distributed, "
            "or torch.distributed.init_process_group, comes first)")
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"mesh {shape} has {math.prod(shape)} ranks, the "
                         f"process group {dist.get_world_size()}")
    return init_device_mesh(dev.type, shape, mesh_dim_names=axes)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or an ``AbstractMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_axes(mesh) -> tuple:
    """The batch-parallel axes of a mesh: every non-model axis."""
    return tuple(a for a in mesh_shape(mesh) if not a.startswith("model"))


def model_axes(mesh) -> tuple:
    """The tensor-parallel axes: ('model',) or ('model_a', 'model_b')."""
    return tuple(a for a in mesh_shape(mesh) if a.startswith("model"))


def init_distributed(device) -> bool:
    """Bring up the default process group from ``torchrun``'s environment
    (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``): NCCL on
    the card (this process's card is ``LOCAL_RANK``'s), gloo on the CPU.
    Returns True if it brought the group up (the caller destroys it), False
    if one was already up."""
    import torch.distributed as dist
    if dist.is_initialized():
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://")
    return True
