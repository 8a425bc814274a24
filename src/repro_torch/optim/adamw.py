"""AdamW with f32 master weights.

Counterpart of ``repro/optim/adamw.py``. State = {"master": f32 copy of
the parameters, "m": f32, "v": f32, "step": 0-dim int32}, each of the
three a dict keyed by the port's parameter names (``model.
named_parameters()``).

Sharded (ZeRO): in the sharded train step (``launch/steps.py``) every
leaf of the gradients, master, m, v and the parameters is a DTensor,
master, m and v laid out as their parameter. Each rank updates its own
blocks only; the one collective is the global norm's: each leaf's sum of
squares over the rank's block (counted by one rank of each set that
holds the same block), all-reduced over the whole mesh as one vector,
then summed over the leaves in order as on one device.

The arithmetic is JAX's, not ``torch.optim.AdamW``'s (which adds eps after
dividing by sqrt(bc2) and decays the weights in a separate multiply):
gradients are upcast to f32 and clipped by the global norm, then
``master -= lr * (mhat / (sqrt(vhat) + eps) + wd * master)``, and each
parameter is re-cast from its master into its own dtype. The bias
corrections ``1 - b ** step`` take the f32 power rounded from f64: XLA's
f32 power is correctly rounded, torch's is not. Every tensor of the state
and every parameter is updated in place (the state of a 3e9-parameter
model is 35 GB), ``step`` too (JAX's train step donates the whole state).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.models.common import f32

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm", "named",
           "local"]

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def named(params: Params) -> Dict[str, torch.Tensor]:
    """{name: tensor} of a module's parameters, or of a mapping."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def adamw_init(params: Params) -> dict:
    p = named(params)
    zeros = lambda: {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                     for n, t in p.items()}
    device = next(iter(p.values())).device
    return {"master": {n: t.detach().to(torch.float32, copy=True)
                       for n, t in p.items()},
            "m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's block on this rank (a view: writing it writes the
    DTensor), or the tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _holds_first_copy(t: DTensor) -> bool:
    """Whether this rank's block is the first copy of it: coordinate 0 on
    every mesh dimension the DTensor is replicated over."""
    coord = t.device_mesh.get_coordinate()
    return all(c == 0 for c, pl in zip(coord, t.placements)
               if isinstance(pl, Replicate))


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum over leaves (in order) of each leaf's f32 sum of
    squares, as JAX's Python ``sum`` over the leaves. DTensor leaves: each
    leaf's sum over its blocks (one all-reduce of the vector of them over
    the default process group), then the same sum over the leaves."""
    leaves = list(tree.values())
    sums = (torch.sum(torch.square(local(x).to(torch.float32))) for x in leaves)
    if leaves and isinstance(leaves[0], DTensor):
        vec = torch.stack([s if _holds_first_copy(x) else torch.zeros_like(s)
                           for x, s in zip(leaves, sums)])
        dist.all_reduce(vec)
        sums = vec.unbind()
    total = 0
    for s in sums:
        total = total + s
    return torch.sqrt(total)


def _bias_correction(b: float, step: torch.Tensor) -> torch.Tensor:
    """1 - b ** step in f32, the power of f32(b) rounded from f64."""
    base = torch.tensor(b, dtype=torch.float32, device=step.device).double()
    return 1.0 - torch.pow(base, step.double()).to(torch.float32)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Mapping[str, torch.Tensor], state: dict,
                 params: Params, lr_scale: Union[torch.Tensor, float] = 1.0
                 ) -> Tuple[Params, dict, dict]:
    """Returns (params, state, metrics {"grad_norm", "lr"}); ``params``
    and ``state`` are the objects passed in, updated in place (DTensors:
    this rank's blocks)."""
    step = state["step"].add_(1)
    gnorm = global_norm(grads)
    clip = torch.clamp(f32(cfg.grad_clip, gnorm.device) / (gnorm + 1e-9), max=1.0)
    bc1 = _bias_correction(cfg.b1, step)
    bc2 = _bias_correction(cfg.b2, step)
    lr = cfg.lr * lr_scale
    b1, b2 = cfg.b1, cfg.b2
    pdict = named(params)
    for n, g in grads.items():
        m, v, w = (local(state[k][n]) for k in ("m", "v", "master"))
        g = local(g).to(torch.float32) * clip
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * g * g)
        upd = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        w.sub_(lr * (upd + cfg.weight_decay * w))
        local(pdict[n]).copy_(w)
    return params, state, {"grad_norm": gnorm, "lr": lr}
