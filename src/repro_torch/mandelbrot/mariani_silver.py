"""Back-compat shim, as ``repro.mandelbrot.mariani_silver``: the
Mariani-Silver problem layer lives in
``repro_torch.workloads.frame_problem`` (``MandelbrotProblem`` is
``FrameProblem`` with the default workload)."""

from repro_torch.workloads.frame_problem import (FrameProblem,
                                                 MandelbrotProblem,
                                                 dispatch_batch, solve,
                                                 solve_batch)

__all__ = ["FrameProblem", "MandelbrotProblem", "solve", "solve_batch",
           "dispatch_batch"]
