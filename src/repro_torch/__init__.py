"""PyTorch + CUDA port of the JAX package ``repro`` for NVIDIA Hopper.

The layout mirrors ``repro/``: ``kernels`` (hand-written CUDA kernels and
their plain versions), ``workloads`` (the escape-time workloads and
``FrameProblem``), ``core`` (cost model, OLTs, ASK and the DP baseline),
``mandelbrot`` (the case-study facade), ``configs``, ``models`` and
``launch`` (the language-model substrate: attention + MLP/MoE serving,
``launch.serve.generate``) and ``convert`` (a problem from plain values,
a model's parameters from the JAX package's). It imports torch and numpy,
never JAX or ``repro``.

Entry points run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, which runs the plain PyTorch versions.
"""

from repro_torch.core import (ASKStats, run_ask, run_ask_pooled,
                              run_ask_pooled_batch, run_dp)
from repro_torch.workloads import (EngineOptions, FrameProblem,
                                   MandelbrotProblem, exhaustive, get_workload,
                                   solve, solve_batch)

__all__ = ["ASKStats", "run_ask", "run_dp", "run_ask_pooled",
           "run_ask_pooled_batch", "FrameProblem", "MandelbrotProblem",
           "EngineOptions", "exhaustive", "get_workload", "solve",
           "solve_batch"]
