"""Workload-parametric problem layer of the port.

Counterpart of ``repro/workloads``: ``WorkloadSpec`` (spec.py), the
registry of mandelbrot, julia, burning_ship, multibrot and the generated
``ssd_synth`` field (registry.py) and ``FrameProblem`` (frame_problem.py),
the ``ASKProblem`` adapter that every engine of the port (ex, ask,
ask_fused, ask_scan, ask_tuned, ask_pooled, dp) serves, with ``solve``,
``solve_batch`` and ``dispatch_batch``. Serving configuration lives in two
frozen objects re-exported here: ``KernelPolicy`` (kernels/policy.py)
routes each kernel (torch / cuda / tuned), and ``EngineOptions``
(options.py) holds every ``solve_batch`` knob, beside
``FrontDoorOptions`` and ``TileOptions``.
"""

from repro_torch.kernels.policy import KernelPolicy
from repro_torch.workloads.frame_problem import (FrameProblem,
                                                 MandelbrotProblem,
                                                 dispatch_batch, exhaustive,
                                                 solve, solve_batch)
from repro_torch.workloads.options import (EngineOptions, FrontDoorOptions,
                                           TileOptions)
from repro_torch.workloads.registry import (available, escape_time_workloads,
                                            get_workload, julia, multibrot,
                                            register, ssd_synth)
from repro_torch.workloads.spec import WorkloadSpec

__all__ = [
    "EngineOptions",
    "FrontDoorOptions",
    "TileOptions",
    "KernelPolicy",
    "WorkloadSpec",
    "register",
    "get_workload",
    "available",
    "escape_time_workloads",
    "julia",
    "multibrot",
    "ssd_synth",
    "FrameProblem",
    "MandelbrotProblem",
    "exhaustive",
    "solve",
    "solve_batch",
    "dispatch_batch",
]
