"""WorkloadSpec: one self-similar-density workload, as the port serves it.

Counterpart of ``repro/workloads/spec.py``. ``kind`` selects the per-point
machinery:

* ``"escape"`` -- the escape-time workloads. The per-point function is
  named once: ``kernel_id`` (one of ``kernels.ref.KINDS``) and
  ``kernel_params`` = (c_re, c_im, m), its run-time parameters (julia's
  constant as f32 values, multibrot's power). The pair picks both the
  plain step (``ref.step_of``, run by the shared ``ref.escape_time`` loop)
  and the ``escape_time<Kind>`` instance of ``kernels/csrc/escape_time.cuh``
  that the CUDA kernels run.
* ``"grid"`` -- ``values`` calls ``grid_fn(cr, ci)``: a lookup into a
  generated field (``registry.ssd_synth``, the paper's Sec. 7). It is a
  gather with no escape-time kernel, so ``kernels.ops`` routes its point
  computations to the plain path on every device.

A spec also carries the default window and the zoom-depth prior band of
the planner. Canvases are int32. Specs are frozen and hashable.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.kernels import ref

__all__ = ["WorkloadSpec"]

Bounds = Tuple[float, float, float, float]


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """One self-similar density workload, engine-stack ready."""

    name: str
    kernel_id: Optional[int] = None  # kind "escape": one of ref.KINDS
    kernel_params: Tuple[float, float, int] = (0.0, 0.0, 0)
    kind: str = "escape"  # "escape" | "grid"
    grid_fn: Optional[Callable] = None  # (cr, ci) -> values (kind "grid")
    default_bounds: Bounds = ref.DEFAULT_BOUNDS
    # zoom-depth prior band (the planner slice reads it)
    p_deep: float = 0.97
    slope: float = 0.18
    p_min: float = 0.3

    def __post_init__(self):
        if not self.name:
            raise ValueError("WorkloadSpec needs a non-empty name")
        if self.kind not in ("escape", "grid"):
            raise ValueError(f"kind must be 'escape' or 'grid', got {self.kind!r}")
        if self.kind == "grid" and self.grid_fn is None:
            raise ValueError(f"grid workload {self.name!r} needs grid_fn")
        if self.kind == "escape" and self.kernel_id not in ref.KINDS.values():
            raise ValueError(f"{self.name!r}: unknown kernel_id {self.kernel_id}")
        if not 0.0 < self.p_min <= self.p_deep <= 1.0:
            raise ValueError(
                f"{self.name!r}: need 0 < p_min <= p_deep <= 1, got "
                f"{self.p_min}/{self.p_deep}")
        if self.slope < 0:
            raise ValueError(f"{self.name!r}: slope must be >= 0, got {self.slope}")
        if len(self.default_bounds) != 4:
            raise ValueError(f"{self.name!r}: default_bounds must be length 4")

    def values(self, cr: torch.Tensor, ci: torch.Tensor, max_dwell: int,
               *, unroll: int = 1) -> torch.Tensor:
        """Point values at mapped plane coordinates (the plain version):
        the escape-time dwell, or the grid's lookup (which ignores
        ``max_dwell`` and ``unroll``)."""
        if self.kind == "grid":
            return self.grid_fn(cr, ci)
        return ref.escape_time(
            cr, ci, max_dwell,
            step=ref.step_of(self.kernel_id, self.kernel_params),
            unroll=unroll)

    @property
    def prior_band(self) -> Tuple[float, float, float]:
        """(p_deep, slope, p_min): the zoom-depth prior of this workload."""
        return (self.p_deep, self.slope, self.p_min)
