"""Sharding rules: parameter, optimizer, cache and batch PartitionSpecs,
and their DTensor placements.

Counterpart of ``repro/launch/sharding.py``: the same rules in the same
order, quirks included (every leaf named ``down`` outside ``experts``
takes the xLSTM rule, the MLP's too; ``wo``'s bias is replicated).
  * TP ("model" axis): attention heads, FFN hidden, vocab, MoE experts.
  * DP (all non-model axes, incl. "pod"): batch; with ``fsdp=True`` also
    the contraction dim of every large weight (ZeRO-3); optimizer state
    inherits the spec, so the whole Adam state is sharded.
  * EP: MoE expert dim -> "model".
  * SP (decode): KV caches shard the *sequence* dim on "model" whenever
    the head dim cannot.
Every rule is divisibility-guarded (``_guard``): an axis is applied to a
dim only if the dim divides evenly; otherwise that axis is dropped.

The rules read a mesh's axis names and sizes only (``launch.mesh.
mesh_shape``), so they run on an ``AbstractMesh`` as on a ``DeviceMesh``.
A spec is the port's ``PartitionSpec``: one entry a tensor dim, each
None, an axis name or a tuple of names (the dim split over them, major
to minor), a tuple of one name stored as the name, as JAX stores it.

Names: the port holds one tensor a layer where JAX stacks ``[G, ...]``
under ``groups`` (and ``encoder.groups``), and a parameter's name is its
JAX path with the layer index after the prefix. So ``param_spec`` of a
port tensor is JAX's spec of its stacked leaf with the leading ``None``
taken off. The cache keeps JAX's stacked layout and JAX's specs.

Placements (``placements``, ``distribute``): a spec on a ``DeviceMesh``
is one DTensor placement a mesh dimension, ``Shard(d)`` where the axis
names tensor dim d, else ``Replicate()``. Two axes on one dim must be in
mesh order, as JAX's entries here are: DTensor then splits the dim over
them major to minor, so each rank holds JAX's block at the same mesh
coordinates.

What the model axis does in the port: it shards storage (every leaf as
its spec says), the experts' compute (EP, ``models/moe.py``) and, as
JAX's GSPMD does, the products its specs split: the sharded steps
(``launch/steps.py``) bind each such leaf as its model-axis block and
the modules compute their part (``launch/tensor_parallel.py`` derives
which leaves from ``param_spec``). xLSTM's leaves and the leftover axes
of a 2-D split are gathered whole at use.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import MODEL_AXIS, data_axes, mesh_shape, model_axes

__all__ = ["FSDP_THRESHOLD", "PartitionSpec", "P", "NamedSharding",
           "ShardingPolicy", "param_spec", "params_shardings",
           "opt_state_shardings", "cache_spec", "cache_shardings",
           "batch_shardings", "placements", "shard_shape", "distribute"]

FSDP_THRESHOLD = 2_000_000_000  # params; >= 2B get ZeRO-3 sharding


def _entry(e):
    if e is None or isinstance(e, str):
        return e
    e = tuple(e)
    return e[0] if len(e) == 1 else e


class PartitionSpec(tuple):
    """JAX's ``PartitionSpec``: a tuple of entries, one a tensor dim."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(_entry(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """JAX's ``NamedSharding``: a spec on a mesh."""

    mesh: Any
    spec: PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool
    data: Tuple[str, ...]  # batch axes of the mesh
    # single "model" axis, or a tuple ("model_a", "model_b") for the 2-D
    # TP split mesh (make_production_mesh(model_split=...))
    model: object = MODEL_AXIS

    @classmethod
    def for_arch(cls, cfg: ArchConfig, mesh,
                 fsdp: Optional[bool] = None) -> "ShardingPolicy":
        if fsdp is None:
            fsdp = cfg.param_count() >= FSDP_THRESHOLD
        m = model_axes(mesh)
        model = m if len(m) > 1 else (m[0] if m else MODEL_AXIS)
        return cls(fsdp=fsdp, data=data_axes(mesh), model=model)

    def heads_split(self, mesh, heads: int):
        """(head_axes, rest_axes): the model sub-axes usable on a head dim
        of size ``heads`` and the leftover axes (2-D TP: the leftovers
        shard the weight's contraction dim). None when nothing fits."""
        msize = _axis_size(mesh, self.model)
        if heads % msize == 0:
            return self.model, None
        if isinstance(self.model, tuple):
            for cut in range(len(self.model) - 1, 0, -1):
                sub = self.model[:cut]
                if heads % _axis_size(mesh, sub) == 0:
                    return sub, self.model[cut:]
        return None, (self.model if isinstance(self.model, tuple)
                      else (self.model,))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(axis, tuple):
        return math.prod(shape[a] for a in axis)
    return shape[axis]


def _guard(mesh, shape, spec_entries) -> PartitionSpec:
    """Drop axes that don't divide their dim."""
    out = []
    for dim, ax in zip(shape, spec_entries):
        if ax is None:
            out.append(None)
        elif dim % _axis_size(mesh, ax) == 0:
            out.append(ax)
        else:
            out.append(None)
    return P(*out)


def param_spec(cfg: ArchConfig, mesh, pol: ShardingPolicy, name: str,
               leaf) -> PartitionSpec:
    """PartitionSpec of the port's parameter ``name`` (dotted, e.g.
    ``groups.3.0.mixer.wq.w``), shaped as ``leaf``."""
    keys = tuple(name.split("."))
    shape = tuple(leaf.shape)
    model, dsp = pol.model, (tuple(pol.data) if pol.fsdp else None)

    def spec(*entries):
        return _guard(mesh, shape, entries)

    name = keys[-2] if keys[-1] in ("w", "b") else keys[-1]
    is_bias = keys[-1] == "b"

    # --- embeddings / head --------------------------------------------------
    if "embed" in keys:
        return _guard(mesh, shape, (model, dsp))
    if "lm_head" in keys:
        return _guard(mesh, shape, (dsp, model))

    # --- norms / small vectors ----------------------------------------------
    if "norm" in name or name in ("final_norm", "kv_norm", "q_norm", "k_norm",
                                  "norm1", "norm2", "norm_cross"):
        return spec(*([None] * len(shape)))

    # --- MoE ----------------------------------------------------------------
    if "experts" in keys:
        # [E, D, F] / [E, F, D]: experts on model (EP); FSDP on D
        if name == "down":
            return spec(model, None, dsp)
        return spec(model, dsp, None)
    if "router" in keys:
        return spec(None, None)

    # --- attention projections ----------------------------------------------
    if name in ("wq", "wk", "wv", "wo", "wo_gate"):
        heads = cfg.num_kv_heads if name in ("wk", "wv") else cfg.num_heads
        m, rest = pol.heads_split(mesh, heads)
        if is_bias:
            return spec(m) if name != "wo" else spec(None)
        other = dsp if rest is None else rest  # 2-D TP: leftovers on D
        if name == "wo":
            return spec(m, other)
        return spec(other, m)

    # --- MLA ----------------------------------------------------------------
    if name == "wdkv":
        return spec(dsp, None)
    if name in ("wuk", "wuv"):
        return spec(None, model)
    if name == "wkr":
        return spec(dsp, None)

    # --- Mamba --------------------------------------------------------------
    if name == "in_proj":
        return spec(dsp, model)
    if name in ("conv_w",):
        return spec(None, model)
    if name in ("conv_b", "D"):
        return spec(model)
    if name == "x_proj":
        return spec(model, None)
    if name == "dt_proj":
        return spec(None, model) if not is_bias else spec(model)
    if name == "A_log":
        return spec(model, None)
    if name == "out_proj":
        return spec(model, dsp)

    # --- xLSTM --------------------------------------------------------------
    if name in ("up",):
        if is_bias:
            return spec(model)
        return spec(dsp, model)
    if name == "down":
        return spec(model, dsp) if not is_bias else spec(None)
    if name in ("wz", "wi", "wf"):  # small gate projections: replicate
        return spec(*([None] * len(shape)))

    # --- MLP ----------------------------------------------------------------
    if name in ("gate",):
        return spec(dsp, model) if not is_bias else spec(model)

    # default: replicate
    return spec(*([None] * len(shape)))


def _named(params) -> dict:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def params_shardings(cfg: ArchConfig, mesh, pol: ShardingPolicy,
                     params) -> dict:
    """{name: NamedSharding} of a model's parameters (or of a dict of
    tensors keyed by parameter name)."""
    return {n: NamedSharding(mesh, param_spec(cfg, mesh, pol, n, t))
            for n, t in _named(params).items()}


def opt_state_shardings(cfg: ArchConfig, mesh, pol: ShardingPolicy,
                        opt: Mapping) -> dict:
    """Optimizer state inherits each param's spec (ZeRO); ``step`` is
    replicated."""
    out = {}
    for k, v in opt.items():
        if k == "step":
            out[k] = NamedSharding(mesh, P())
        else:
            out[k] = params_shardings(cfg, mesh, pol, v)
    return out


def cache_spec(cfg: ArchConfig, mesh, pol: ShardingPolicy, path: Tuple[str, ...],
               leaf) -> PartitionSpec:
    """Decode-cache rules: batch on data; heads on model when divisible,
    else sequence-sharded KV (SP / flash-decoding split). ``path``: the
    cache's keys down to the leaf (``("0", "k")``); leaves are stacked
    [G, B, ...], as in JAX."""
    shape = tuple(leaf.shape)  # leading G (stacked groups), then batch
    d = tuple(pol.data)
    msize = _axis_size(mesh, pol.model)
    name = path[-1]
    if name in ("k", "v", "k_q", "v_q"):  # [G, B, S, Hkv, hd]
        if cfg.num_kv_heads % msize == 0:
            return _guard(mesh, shape, (None, d, None, pol.model, None))
        return _guard(mesh, shape, (None, d, pol.model, None, None))
    if name in ("k_s", "v_s"):  # int8 scales [G, B, S, Hkv]
        if cfg.num_kv_heads % msize == 0:
            return _guard(mesh, shape, (None, d, None, pol.model))
        return _guard(mesh, shape, (None, d, pol.model, None))
    if name in ("c_kv", "k_rope"):  # [G, B, S, lora/dr] -> SP on S
        return _guard(mesh, shape, (None, d, pol.model, None))
    if name == "conv":  # [G, B, dc-1, di]
        return _guard(mesh, shape, (None, d, None, pol.model))
    if name == "ssm":  # [G, B, di, ds]
        return _guard(mesh, shape, (None, d, pol.model, None))
    if name == "C":  # [G, B, H, dh, dh]
        return _guard(mesh, shape, (None, d, None, pol.model, None))
    if name in ("n",):  # [G, B, H, dh]
        return _guard(mesh, shape, (None, d, None, pol.model))
    if name == "m":  # [G, B, H]
        return _guard(mesh, shape, (None, d, None))
    if name in ("c",):  # slstm [G, B, D]
        return _guard(mesh, shape, (None, d, pol.model))
    return _guard(mesh, shape, (None, d) + (None,) * (len(shape) - 2))


def cache_shardings(cfg: ArchConfig, mesh, pol: ShardingPolicy, cache: Mapping,
                    path: Tuple[str, ...] = ()) -> dict:
    """NamedShardings in the nested dict layout of ``cache``."""
    return {k: (cache_shardings(cfg, mesh, pol, v, path + (k,))
                if isinstance(v, Mapping) else
                NamedSharding(mesh, cache_spec(cfg, mesh, pol, path + (k,), v)))
            for k, v in cache.items()}


def batch_shardings(cfg: ArchConfig, mesh, pol: ShardingPolicy,
                    batch: Mapping) -> dict:
    """Data operands: batch dim on the data axes, rest replicated."""
    d = tuple(pol.data)

    def one(leaf):
        if leaf.ndim == 0:
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, _guard(
            mesh, leaf.shape, (d,) + (None,) * (leaf.ndim - 1)))

    return {k: one(v) for k, v in batch.items()}


# -- specs on a DeviceMesh ---------------------------------------------------------

def placements(mesh, spec: PartitionSpec) -> tuple:
    """DTensor placements of ``spec`` on the DeviceMesh ``mesh``: one a
    mesh dimension. Raises on an axis the mesh lacks, an axis named
    twice, and two axes on one dim out of mesh order."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    seen = set()
    for dim, entry in enumerate(spec):
        axes = () if entry is None else ((entry,) if isinstance(entry, str)
                                         else tuple(entry))
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: mesh {names} has no axis {a!r}")
            if a in seen:
                raise ValueError(f"{spec}: axis {a!r} named twice")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} are not in mesh order "
                             f"{names}; a rank would hold another's block")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def shard_shape(mesh, spec: PartitionSpec, shape) -> tuple:
    """The block of ``shape`` that one rank holds under ``spec``."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        if entry is not None:
            k = _axis_size(mesh, entry)
            if out[dim] % k:
                raise ValueError(f"{spec}: dim {dim} of {tuple(shape)} does "
                                 f"not divide by {k}")
            out[dim] //= k
    return tuple(out)


def distribute(t: torch.Tensor, sharding: NamedSharding):
    """A DTensor of ``t`` (the whole tensor, the same on every rank) laid
    out as ``sharding`` says: each rank keeps its block; nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    out = distribute_tensor(t.detach(), sharding.mesh,
                            placements(sharding.mesh, sharding.spec),
                            src_data_rank=None)
    want = shard_shape(sharding.mesh, sharding.spec, t.shape)
    if tuple(out.to_local().shape) != want:
        raise RuntimeError(f"local block {tuple(out.to_local().shape)}, "
                             f"spec {sharding.spec} gives {want}")
    return out
