"""Workload-parametric problem layer of the port.

Counterpart of ``repro/workloads``: ``WorkloadSpec`` (spec.py), the
registry of the four escape-time workloads (registry.py) and
``FrameProblem`` (frame_problem.py), the ``ASKProblem`` adapter that every
engine of the port (ex, ask, ask_fused, ask_scan, ask_pooled, dp) serves,
with ``solve``, ``solve_batch`` and ``dispatch_batch``, and
``EngineOptions``, ``FrontDoorOptions`` and ``TileOptions`` (options.py).
"""

from repro_torch.workloads.frame_problem import (FrameProblem,
                                                 MandelbrotProblem,
                                                 dispatch_batch, exhaustive,
                                                 solve, solve_batch)
from repro_torch.workloads.options import (EngineOptions, FrontDoorOptions,
                                           TileOptions)
from repro_torch.workloads.registry import (available, get_workload, julia,
                                            multibrot, register, ssd_synth)
from repro_torch.workloads.spec import WorkloadSpec

__all__ = ["WorkloadSpec", "register", "get_workload", "available", "julia",
           "multibrot", "ssd_synth", "FrameProblem", "MandelbrotProblem",
           "exhaustive", "solve", "solve_batch", "dispatch_batch",
           "EngineOptions", "FrontDoorOptions", "TileOptions"]
