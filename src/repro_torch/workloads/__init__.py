"""Workload-parametric problem layer of the port.

Counterpart of ``repro/workloads``: ``WorkloadSpec`` (spec.py), the
registry of the four escape-time workloads (registry.py) and
``FrameProblem`` (frame_problem.py), the ``ASKProblem`` adapter that every
engine of the port (ex, ask, dp, ask_pooled) serves, with ``solve`` and
``solve_batch``, and ``EngineOptions`` (options.py).
"""

from repro_torch.workloads.frame_problem import (FrameProblem,
                                                 MandelbrotProblem,
                                                 exhaustive, solve,
                                                 solve_batch)
from repro_torch.workloads.options import EngineOptions
from repro_torch.workloads.registry import (available, get_workload, julia,
                                            multibrot, register, ssd_synth)
from repro_torch.workloads.spec import WorkloadSpec

__all__ = ["WorkloadSpec", "register", "get_workload", "available", "julia",
           "multibrot", "ssd_synth", "FrameProblem", "MandelbrotProblem",
           "exhaustive", "solve", "solve_batch", "EngineOptions"]
