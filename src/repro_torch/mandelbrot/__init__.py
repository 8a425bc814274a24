"""The paper's case study: Mandelbrot via Mariani-Silver subdivision.

A facade over ``repro_torch.workloads``, as ``repro.mandelbrot`` is over
``repro.workloads``: ``MandelbrotProblem`` is ``FrameProblem`` with the
registry's default ``mandelbrot`` workload.
"""

from repro_torch.workloads.frame_problem import (FrameProblem,
                                                 MandelbrotProblem,
                                                 exhaustive, solve,
                                                 solve_batch)

__all__ = ["exhaustive", "FrameProblem", "MandelbrotProblem", "solve",
           "solve_batch"]
