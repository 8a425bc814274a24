"""Back-compat shim, as ``repro.mandelbrot.exhaustive``: the Ex baseline
lives in ``repro_torch.workloads.frame_problem.exhaustive``."""

from repro_torch.workloads.frame_problem import exhaustive

__all__ = ["exhaustive"]
