"""Carry a problem across from the JAX package.

This system has no weights: what moves from the JAX package to the port
is the problem and its workload. ``problem_from_fields`` takes them as
plain values, so one dict builds both packages' problems.
"""

from __future__ import annotations

from typing import Any, Mapping

from repro_torch.workloads import registry
from repro_torch.workloads.frame_problem import FrameProblem

__all__ = ["problem_from_fields", "FIELDS"]

# FrameProblem fields shared with the JAX package
FIELDS = ("n", "g", "r", "B", "max_dwell", "bounds", "scheme", "tile")


def problem_from_fields(d: Mapping[str, Any]) -> FrameProblem:
    """The port's ``FrameProblem`` from plain values.

    ``d`` holds the shared fields (``FIELDS``), ``workload`` (a registered
    name), the workload's parameters (``c`` for julia, ``m`` for
    multibrot) and optionally ``device``. Unknown keys raise.
    """
    unknown = set(d) - set(FIELDS) - {"workload", "c", "m", "device"}
    if unknown:
        raise ValueError(f"unknown fields {sorted(unknown)}")
    name = d.get("workload", "mandelbrot")
    if name == "julia" and "c" in d:
        spec = registry.julia(tuple(d["c"]))
    elif name == "multibrot" and "m" in d:
        spec = registry.multibrot(d["m"])
    elif "c" in d or "m" in d:
        raise ValueError(f"workload {name!r} takes no parameters c/m")
    else:
        spec = registry.get_workload(name)
    kw = {k: d[k] for k in FIELDS if k in d}
    if kw.get("bounds") is not None:
        kw["bounds"] = tuple(float(b) for b in kw["bounds"])
    return FrameProblem(workload=spec, device=d.get("device", "cuda"), **kw)
