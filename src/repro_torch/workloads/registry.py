"""The workload registry: canonical ``WorkloadSpec`` instances by name.

Counterpart of ``repro/workloads/registry.py``, with the same default
windows and prior bands:

  mandelbrot    z -> z^2 + c, z0 = c (the paper's Sec. 6 case study)
  julia         z -> z^2 + c0 over the dynamic plane (``julia(c=...)``)
  burning_ship  z -> (|Re z| + i|Im z|)^2 + c
  multibrot     z -> z^m + c (default m=3; ``multibrot(m=...)``)
  ssd_synth     a generated 2-D SSD field (paper Sec. 7) served as a grid
                workload (``ssd_synth(...)``): the one setting where the
                prior band is exact, because the generator's P is known

Each escape-time workload's step is ``ref.step_of`` of its kind, under the
rounding contract of ``kernels/ref.py``. The parametric factories memoise
per parameter, so two calls return the same object. ``register`` takes a
spec or a zero-arg factory, which is built on first use; its ``kind`` is
recorded at registration, so a kind query (``escape_time_workloads``)
never builds a grid factory's field.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple, Union

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.ref import KINDS
from repro_torch.workloads.spec import WorkloadSpec

__all__ = ["register", "get_workload", "available", "escape_time_workloads",
           "julia", "multibrot", "ssd_synth", "DEFAULT_JULIA_C"]

# name -> WorkloadSpec | zero-arg factory (resolved on first use)
_REGISTRY: Dict[str, Union[WorkloadSpec, Callable[[], WorkloadSpec]]] = {}
# name -> kind, recorded at registration so that kind queries never build a
# factory
_KINDS: Dict[str, str] = {}


def register(name: str, spec_or_factory, *, kind: Union[str, None] = None,
             overwrite: bool = False) -> None:
    """Register a spec (or a zero-arg factory building one) under ``name``.
    ``kind`` declares a factory's kind without building it (default
    "escape"; a spec carries its own and ignores it). A taken name raises
    unless ``overwrite``."""
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"workload {name!r} already registered")
    _REGISTRY[name] = spec_or_factory
    if isinstance(spec_or_factory, WorkloadSpec):
        _KINDS[name] = spec_or_factory.kind
    else:
        _KINDS[name] = "escape" if kind is None else kind


def get_workload(workload: Union[str, WorkloadSpec]) -> WorkloadSpec:
    """Resolve a name (or pass a spec through) to the canonical instance."""
    if isinstance(workload, WorkloadSpec):
        return workload
    entry = _REGISTRY.get(workload)
    if entry is None:
        raise KeyError(
            f"unknown workload {workload!r}; registered: {available()}")
    if not isinstance(entry, WorkloadSpec):
        entry = entry()
        if entry.name != workload:
            raise ValueError(
                f"factory for {workload!r} built a spec named {entry.name!r}")
        if entry.kind != _KINDS[workload]:
            raise ValueError(
                f"factory for {workload!r} was registered as kind "
                f"{_KINDS[workload]!r} but built a {entry.kind!r} spec")
        _REGISTRY[workload] = entry  # resolve the factory once
    return entry


def available() -> Tuple[str, ...]:
    """Registered workload names, registration order."""
    return tuple(_REGISTRY)


def escape_time_workloads() -> Tuple[str, ...]:
    """Names of the registered escape-time workloads, from the kinds
    recorded at registration (no factory is built)."""
    return tuple(name for name in _REGISTRY if _KINDS[name] == "escape")


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


_SSD_CACHE: Dict[Tuple[int, int, int, int, int, float], WorkloadSpec] = {}


def ssd_synth(seed: int = 0, *, n_field: int = 256, g: int = 4, r: int = 2,
              B: int = 16, P: float = 0.7) -> WorkloadSpec:
    """A generated 2-D SSD field (``core.ssd_synth.generate_field``, k=2)
    served as a grid workload: a point's value is a lookup into the field,
    ``field[clamp(int32(ci)), clamp(int32(cr))]`` (f32 to int32 truncates,
    as in JAX), the default window covers the field exactly, and the prior
    band is the generator's own P (slope 0). With frame n == ``n_field``
    on the default window the subdivision grid aligns with the
    generator's regions, so every engine reproduces the field exactly.
    The field is copied to a device at its first lookup there."""
    key = (int(seed), int(n_field), int(g), int(r), int(B), float(P))
    spec = _SSD_CACHE.get(key)
    if spec is None:
        from repro_torch.core.ssd_synth import generate_field

        fld = generate_field(key[0], n=key[1], g=key[2], r=key[3], B=key[4],
                             P=key[5], k=2)
        host = torch.from_numpy(fld.field)
        on_device: Dict[torch.device, torch.Tensor] = {}
        nf = key[1]

        def grid_fn(cr, ci):
            field = on_device.get(cr.device)
            if field is None:
                field = on_device[cr.device] = host.to(cr.device)
            fy = ci.to(torch.int32).clamp(0, nf - 1).long()
            fx = cr.to(torch.int32).clamp(0, nf - 1).long()
            return field[fy, fx]

        name = ("ssd_synth" if key == (0, 256, 4, 2, 16, 0.7)
                else f"ssd_synth(seed={key[0]},n={key[1]},P={key[5]:g})")
        spec = WorkloadSpec(
            name=name, kind="grid", grid_fn=grid_fn,
            default_bounds=(0.0, 0.0, float(nf), float(nf)),
            p_deep=key[5], slope=0.0, p_min=key[5])
        _SSD_CACHE[key] = spec
    return spec


register("mandelbrot", MANDELBROT)
register("julia", julia)
register("burning_ship", BURNING_SHIP)
register("multibrot", multibrot)
register("ssd_synth", ssd_synth, kind="grid")
