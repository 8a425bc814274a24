"""The workload registry: canonical ``WorkloadSpec`` instances by name.

Counterpart of ``repro/workloads/registry.py`` for the four escape-time
workloads, with the same default windows and prior bands:

  mandelbrot    z -> z^2 + c, z0 = c (the paper's Sec. 6 case study)
  julia         z -> z^2 + c0 over the dynamic plane (``julia(c=...)``)
  burning_ship  z -> (|Re z| + i|Im z|)^2 + c
  multibrot     z -> z^m + c (default m=3; ``multibrot(m=...)``)

Each workload's step is ``ref.step_of`` of its kind, under the rounding
contract of ``kernels/ref.py``. The parametric factories memoise per parameter, so two calls return the same
object. ``ssd_synth`` (a grid workload) waits for the k-D slice.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import numpy as np

from repro_torch.kernels import ref
from repro_torch.kernels.ref import KINDS
from repro_torch.workloads.spec import WorkloadSpec

__all__ = ["register", "get_workload", "available", "julia", "multibrot",
           "ssd_synth", "DEFAULT_JULIA_C"]

# name -> WorkloadSpec | zero-arg factory (resolved on first use)
_REGISTRY: Dict[str, Union[WorkloadSpec, Callable[[], WorkloadSpec]]] = {}


def register(name: str, spec_or_factory) -> None:
    """Register a spec (or a zero-arg factory building one) under ``name``."""
    if name in _REGISTRY:
        raise ValueError(f"workload {name!r} already registered")
    _REGISTRY[name] = spec_or_factory


def get_workload(workload: Union[str, WorkloadSpec]) -> WorkloadSpec:
    """Resolve a name (or pass a spec through) to the canonical instance."""
    if isinstance(workload, WorkloadSpec):
        return workload
    entry = _REGISTRY.get(workload)
    if entry is None and workload == "ssd_synth":
        ssd_synth()
    if entry is None:
        raise KeyError(
            f"unknown workload {workload!r}; registered: {available()}")
    if not isinstance(entry, WorkloadSpec):
        entry = entry()
        if entry.name != workload:
            raise ValueError(
                f"factory for {workload!r} built a spec named {entry.name!r}")
        _REGISTRY[workload] = entry
    return entry


def available() -> Tuple[str, ...]:
    """Registered workload names, registration order."""
    return tuple(_REGISTRY)


MANDELBROT = WorkloadSpec(
    name="mandelbrot", kernel_id=KINDS["mandelbrot"],
    default_bounds=ref.DEFAULT_BOUNDS, p_deep=0.97, slope=0.18, p_min=0.3)

DEFAULT_JULIA_C = (-0.7269, 0.1889)

_JULIA_CACHE: Dict[Tuple[float, float], WorkloadSpec] = {}


def julia(c: Tuple[float, float] = DEFAULT_JULIA_C) -> WorkloadSpec:
    """Julia set of z -> z^2 + c0: the pixel maps to z0 and ``c`` is a
    workload parameter, rounded to f32 as JAX rounds a Python float."""
    key = (float(c[0]), float(c[1]))
    spec = _JULIA_CACHE.get(key)
    if spec is None:
        c_re, c_im = float(np.float32(key[0])), float(np.float32(key[1]))
        name = ("julia" if key == DEFAULT_JULIA_C
                else f"julia(c={key[0]:+g}{key[1]:+g}j)")
        spec = WorkloadSpec(
            name=name, kernel_id=KINDS["julia"],
            kernel_params=(c_re, c_im, 0),
            default_bounds=(-1.6, -1.6, 1.6, 1.6),
            p_deep=0.97, slope=0.22, p_min=0.25)
        _JULIA_CACHE[key] = spec
    return spec


BURNING_SHIP = WorkloadSpec(
    name="burning_ship", kernel_id=KINDS["burning_ship"],
    default_bounds=(-2.5, -2.0, 1.5, 2.0),
    p_deep=0.95, slope=0.25, p_min=0.3)

_MULTIBROT_CACHE: Dict[int, WorkloadSpec] = {}


def multibrot(m: int = 3) -> WorkloadSpec:
    """Multibrot set of z -> z^m + c (z0 = c). Memoised per ``m``; ``m == 2``
    is not aliased to ``mandelbrot`` (its rounding differs)."""
    m = int(m)
    if m < 2:
        raise ValueError(f"multibrot needs m >= 2, got {m}")
    spec = _MULTIBROT_CACHE.get(m)
    if spec is None:
        name = "multibrot" if m == 3 else f"multibrot(m={m})"
        spec = WorkloadSpec(
            name=name, kernel_id=KINDS["multibrot"],
            kernel_params=(0.0, 0.0, m),
            default_bounds=(-1.5, -1.5, 1.5, 1.5),
            p_deep=0.96, slope=0.2, p_min=0.3)
        _MULTIBROT_CACHE[m] = spec
    return spec


def ssd_synth(*args, **kwargs) -> WorkloadSpec:
    """The generated 2-D SSD field is a grid workload, ported with the
    k-D slice."""
    raise NotImplementedError(
        "ssd_synth is a grid workload; it is ported with ROADMAP queue 1 "
        "slice 13 (k-D SSD)")


register("mandelbrot", MANDELBROT)
register("julia", julia)
register("burning_ship", BURNING_SHIP)
register("multibrot", multibrot)
