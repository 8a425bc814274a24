"""Carry a problem, or a language model's parameters, across from the
JAX package.

The renderer has no weights: what moves from the JAX package to the port
is the problem and its workload. ``problem_from_fields`` takes them as
plain values, so one dict builds both packages' problems.

The language-model substrate has weights. ``params_from_jax`` takes the
nested dict of numpy arrays that ``repro.models.transformer.init_params``
gives (``jax.tree_util.tree_map(np.asarray, params)``) and unstacks its
``[num_groups, ...]`` and ``[encoder_layers, ...]`` leaves into the port's
``Transformer``;
``module_from_jax`` fills one layer's module from its JAX dict.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.workloads import registry
from repro_torch.workloads.frame_problem import FrameProblem

__all__ = ["problem_from_fields", "FIELDS", "params_from_jax", "module_from_jax"]

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


# -- language-model parameters --------------------------------------------------

def _leaves(tree: Mapping, prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            yield from _leaves(v, name)
        else:
            yield name, v


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: no numpy bf16 in torch
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))  # a writable copy


def _fill(model, items):
    """Copy each (JAX leaf name, port parameter name, tensor) of ``items``
    into ``model``'s parameter of that name; raises if a leaf has no
    parameter, a parameter no leaf, or a shape or dtype differs."""
    params = dict(model.named_parameters())
    filled = set()
    for name, pname, value in items:
        p = params.get(pname)
        if p is None:
            raise ValueError(f"JAX leaf {name!r} has no port parameter {pname!r}")
        if p.shape != value.shape or p.dtype != value.dtype:
            raise ValueError(f"{pname}: port {p.dtype} {tuple(p.shape)}, "
                             f"JAX {value.dtype} {tuple(value.shape)}")
        if pname in filled:
            raise ValueError(f"{pname} filled twice")
        with torch.no_grad():
            p.copy_(value)
        filled.add(pname)
    missing = set(params) - filled
    if missing:
        raise ValueError(f"port parameters with no JAX leaf: {sorted(missing)}")
    return model


def module_from_jax(module, tree: Mapping):
    """``module`` (one mixer or block, its parameters already on their
    device) holding the leaves of the JAX parameter dict ``tree`` of the
    same layer, e.g. ``repro.models.mla.mla_init``'s; checked as
    ``params_from_jax`` checks."""
    return _fill(module, ((n, n, _to_torch(leaf)) for n, leaf in _leaves(tree)))


def params_from_jax(cfg, tree: Mapping, *, device="cuda"):
    """The port's ``Transformer`` holding the JAX package's parameters.

    Every leaf of ``tree`` lands in exactly one port parameter: a
    ``groups`` leaf [num_groups, ...] gives one parameter per group
    (``groups.<j>.<path>`` -> ``groups.<g>.<j>.<path>``), an
    ``encoder.groups`` leaf [encoder_layers, ...] one per encoder layer
    (``encoder.groups.0.<path>`` -> ``encoder.groups.<i>.0.<path>``).
    Raises if a leaf has no parameter, a parameter no leaf, or a shape or
    dtype differs."""
    from repro_torch.models.common import resolve_device
    from repro_torch.models.transformer import init_params, stacks
    dev = resolve_device(device)
    model = init_params(cfg, device="meta").to_empty(device=dev)

    def items():
        for name, leaf in _leaves(tree):
            t = _to_torch(leaf)
            stack = next((st for st in stacks(cfg) if name.startswith(st)), None)
            if stack is None:
                yield name, name, t
                continue
            rest = name[len(stack):]
            for g in range(t.shape[0]):
                yield name, f"{stack}{g}.{rest}", t[g]

    return _fill(model, items())
