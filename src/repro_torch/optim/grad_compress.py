"""Error-feedback int8 gradient compression.

Counterpart of ``repro/optim/grad_compress.py``: symmetric per-tensor int8
quantisation of (gradient + residual); the dequantised gradient goes to the
update and the quantisation error stays as the next step's residual (Seide
et al., Karimireddy et al.). As in the JAX package's global-view step,
the quantisation is applied to the gradients the step computed (in the
sharded step, after their reduction, to each rank's blocks; the scale is
then the global max |value| of the leaf, all-reduced, never a block's).
``torch.round`` rounds half to even, as ``jnp.round`` does. Trees are
dicts keyed by parameter name.

"Per tensor" means per JAX leaf: JAX stacks a parameter of every layer
into one [layers, ...] leaf, the port keeps one tensor a layer. So
``compress_with_feedback(..., stacks=)`` takes the prefixes under which a
name carries a layer index (``transformer.stacks(cfg)``), and the
layers' tensors of one path share one scale, the largest over all of them.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.common import f32
from repro_torch.optim.adamw import Params, local, named

__all__ = ["quantize_int8", "dequantize_int8", "compress_with_feedback",
           "init_residual"]


_INV_127 = 1.0 / 127.0


def _scale(amax: torch.Tensor) -> torch.Tensor:
    """max(amax, 1e-12) / 127 as XLA compiles JAX's quotient by a
    constant: a multiply by f32(1/127), which may differ from the true
    quotient by an ulp (and the residual by one ulp of the rounded value)."""
    return torch.clamp(amax, min=1e-12) * f32(_INV_127, amax.device)


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantisation. Returns (q, scale)."""
    xf = x.to(torch.float32)
    scale = _scale(torch.amax(torch.abs(xf)))
    return _quantize(xf, scale), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _leaf_of(name: str, stacks: Iterable[str]) -> str:
    """The JAX leaf a parameter belongs to: ``<prefix><index>.<path>`` ->
    ``<prefix><path>`` for a prefix of ``stacks``, else the name."""
    for st in stacks:
        if name.startswith(st):
            index, _, path = name[len(st):].partition(".")
            if index.isdigit():
                return st + path
    return name


def compress_with_feedback(grads: Mapping[str, torch.Tensor],
                           residual: Mapping[str, torch.Tensor], *,
                           stacks: Iterable[str] = ()
                           ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Quantise (grads + residual); return (the dequantised gradients for
    the update, the new residual), both f32 dicts keyed as ``grads``. The
    tensors of one stacked leaf (``stacks``) share one scale. DTensors
    (the sharded step): each rank quantises its blocks, every leaf's scale
    the max over all ranks (one all-reduce of the vector of leaf maxima);
    both outputs are DTensors laid out as ``grads``."""
    from repro_torch.launch.collectives import pmax_world
    sharded = isinstance(next(iter(grads.values())), DTensor)
    targets = {n: local(g).to(torch.float32) + local(residual[n])
               for n, g in grads.items()}
    amax: Dict[str, torch.Tensor] = {}
    for n, t in targets.items():
        leaf, m = _leaf_of(n, stacks), torch.amax(torch.abs(t))
        amax[leaf] = m if leaf not in amax else torch.maximum(amax[leaf], m)
    if sharded:
        amax = dict(zip(amax, pmax_world(torch.stack(list(amax.values()))).unbind()))
    deq, new_r = {}, {}
    for n, t in targets.items():
        s = _scale(amax[_leaf_of(n, stacks)])
        q = _quantize(t, s)
        deq[n] = dequantize_int8(q, s)
        # target - q * scale rounded once, as XLA contracts it into an FMA
        # (in f64 the product of an int8 and an f32 is exact)
        new_r[n] = (t.double() - q.double() * s.double()).to(torch.float32)
    if sharded:
        for n, g in grads.items():
            deq[n], new_r[n] = (
                DTensor.from_local(x, g.device_mesh, g.placements,
                                   shape=g.shape, stride=g.stride())
                for x in (deq[n], new_r[n]))
    return deq, new_r


def init_residual(params: Params) -> Dict[str, torch.Tensor]:
    return {n: torch.zeros(t.shape, dtype=torch.float32, device=t.device)
            for n, t in named(params).items()}
