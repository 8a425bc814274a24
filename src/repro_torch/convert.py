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
``state_from_jax`` carries a whole JAX train state across (the model, the
optimizer's master, m, v and step, and the residual), and
``named_from_jax`` any params-shaped tree (JAX's gradients, say) as a
dict keyed by the port's parameter names.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.workloads import registry
from repro_torch.workloads.frame_problem import FrameProblem

__all__ = ["problem_from_fields", "FIELDS", "params_from_jax", "module_from_jax",
           "named_from_jax", "state_from_jax"]

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


def _port_items(cfg, tree: Mapping):
    """(JAX leaf name, port parameter name, tensor) of each port parameter
    in ``tree``, the stacked leaves unstacked."""
    from repro_torch.models.transformer import stacks
    for name, leaf in _leaves(tree):
        t = _to_torch(leaf)
        stack = next((st for st in stacks(cfg) if name.startswith(st)), None)
        if stack is None:
            yield name, name, t
            continue
        rest = name[len(stack):]
        for g in range(t.shape[0]):
            yield name, f"{stack}{g}.{rest}", t[g]


def params_from_jax(cfg, tree: Mapping, *, device="cuda", requires_grad=False):
    """The port's ``Transformer`` holding the JAX package's parameters.

    Every leaf of ``tree`` lands in exactly one port parameter: a
    ``groups`` leaf [num_groups, ...] gives one parameter per group
    (``groups.<j>.<path>`` -> ``groups.<g>.<j>.<path>``), an
    ``encoder.groups`` leaf [encoder_layers, ...] one per encoder layer
    (``encoder.groups.0.<path>`` -> ``encoder.groups.<i>.0.<path>``).
    Raises if a leaf has no parameter, a parameter no leaf, or a shape or
    dtype differs. ``requires_grad=True`` gives a model to train."""
    from repro_torch.models.common import resolve_device
    from repro_torch.models.transformer import init_params
    dev = resolve_device(device)
    model = init_params(cfg, device="meta", requires_grad=requires_grad)
    return _fill(model.to_empty(device=dev), _port_items(cfg, tree))


def named_from_jax(cfg, tree: Mapping, *, device="cuda") -> dict:
    """A params-shaped JAX tree (numpy leaves: the master weights, m, v,
    a residual, gradients) as {port parameter name: tensor on ``device``},
    in the model's parameter order, the stacked leaves unstacked; raises
    as ``params_from_jax`` does, on names and shapes (any dtype)."""
    from repro_torch.models.common import resolve_device
    from repro_torch.models.transformer import init_params
    dev = resolve_device(device)
    shapes = {n: p.shape for n, p in
              init_params(cfg, device="meta").named_parameters()}
    got = {}
    for name, pname, t in _port_items(cfg, tree):
        if pname not in shapes:
            raise ValueError(f"JAX leaf {name!r} has no port parameter {pname!r}")
        if t.shape != shapes[pname]:
            raise ValueError(f"{pname}: port {tuple(shapes[pname])}, "
                             f"JAX {tuple(t.shape)}")
        got[pname] = t
    missing = set(shapes) - set(got)
    if missing:
        raise ValueError(f"port parameters with no JAX leaf: {sorted(missing)}")
    return {n: got[n].to(dev) for n in shapes}


def state_from_jax(cfg, state: Mapping, *, device="cuda") -> dict:
    """The port's train state from a JAX one (numpy leaves): {"params":
    the model, its parameters requiring grad, "opt": {"master", "m", "v"
    by parameter name, "step" 0-dim int32}[, "residual"]}, as
    ``launch.train.build``'s ``init_state`` makes it."""
    from repro_torch.models.common import resolve_device
    dev = resolve_device(device)
    opt = state["opt"]
    out = {"params": params_from_jax(cfg, state["params"], device=dev,
                                     requires_grad=True),
           "opt": {k: named_from_jax(cfg, opt[k], device=dev)
                   for k in ("master", "m", "v")}}
    out["opt"]["step"] = _to_torch(opt["step"]).to(dev, torch.int32)
    if "residual" in state:
        out["residual"] = named_from_jax(cfg, state["residual"], device=dev)
    return out
