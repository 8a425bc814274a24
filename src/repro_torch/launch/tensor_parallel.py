"""Tensor-parallel compute over the model axes: which parameters the sharded
steps (``launch/steps.py``) bind as their model-axis block, and the column
exchange of Mamba's packed ``in_proj``.

Under GSPMD, JAX's model axis splits the products that its specs split:
the attention heads, MLA's up-projections, Mamba's inner channels, the
MLP's hidden dim and the vocabulary. The port splits them as Megatron
does: a rank binds the block of each such weight that ``sharding.
param_spec`` gives it on the model axes and computes its part; the
modules (``models/*``, given a ``collectives.Split``) enter a part
through ``copy_to`` and sum the parts with ``reduce_from``.

The one table, ``_SPLIT``: for each kind of module, its ways to split,
tried in order. A way names the leaves
its compute splits and the dim of each (the output dim of a
column-parallel weight and of its bias, the input dim of a row-parallel
one), and the whole leaves whose gradient is then a partial sum over the
model axes (they feed only the rank's part). The axes come from
``param_spec``: a leaf's split axes are the model axes of more than one
rank that its spec puts on that dim. Axes the spec puts on another dim
(the leftovers of a 2-D split, on the contraction dim) are bound whole.
A module is split the first way whose core leaves are all split over the
same axes, else it runs whole; attention's ``wk``/``wv`` are split over
the leading q-head axes that their spec splits them over (all of them,
some on a split mesh, or none: bound whole when the KV heads do not
divide, GQA and MQA), and each rank reads the KV heads of its q heads;
their gradient is a partial sum over the q-head axes they are not split
over. xLSTM's modules have two ways, as JAX's attention rule splits
mLSTM's ``wq``/``wk``/``wv``/``wo_gate`` and sLSTM's ``wo``: their
column blocks when the heads divide the axes, their row blocks when they
do not; ``up`` is column-parallel (mLSTM's packed x|z as Mamba's
``in_proj``, ``to_xz``), ``down`` row-parallel, and the gates that JAX
binds whole feed the rank's part (mLSTM's ``wi``/``wf`` biases are added
after the rows' sum, whole). A module whose projections' specs put the
axes elsewhere (a split mesh whose axes the heads divide only in part,
where JAX splits a projection two ways) runs whole: every leaf gathered.
The embedding and the head are split over the vocabulary when both are
(one of them when tied).

``cache_blocks``: the cache leaves a split mixer reads and writes as the
rank's block, in place (KV heads, Mamba's channels, xLSTM's state dims),
and the attention and MLA slots whose sequence dim the rank reads as its
block where JAX's ``cache_spec`` splits it (flash-decoding's split-KV).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, FrozenSet, Tuple

import torch

__all__ = ["Plan", "plan", "cache_blocks", "to_xz", "from_xz", "bind_xz"]

_MLSTM_PROJ = ("wq.w", "wk.w", "wv.w", "wo_gate.w")
_SLSTM_WHOLE = ("wz.w", "wz.b", "wi.w", "wi.b", "wf.w", "wf.b", "wo.b")
# module kind -> its ways to split: (core leaves {suffix: dim}, KV leaves
# {suffix: dim}, whole leaves whose gradient is a partial sum when the
# module is split)
_SPLIT = {
    "Attention": [({"wq.w": 1, "wq.b": 0, "wo.w": 0},
                   {"wk.w": 1, "wk.b": 0, "wv.w": 1, "wv.b": 0},
                   ("q_norm.w", "k_norm.w"))],
    "MLA": [({"wq.w": 1, "wuk.w": 1, "wuv.w": 1, "wo.w": 0}, {},
             ("wdkv.w", "kv_norm.w", "wkr.w"))],
    "Mamba": [({"in_proj.w": 1, "conv_w": 1, "conv_b": 0, "x_proj.w": 0,
                "dt_proj.w": 1, "dt_proj.b": 0, "A_log": 0, "D": 0,
                "out_proj.w": 0}, {}, ())],
    "MLP": [({"up.w": 1, "up.b": 0, "gate.w": 1, "gate.b": 0, "down.w": 0}, {},
             ())],
    "MLSTM": [({"up.w": 1, "down.w": 0, **{s: 1 for s in _MLSTM_PROJ}}, {},
               ("wi.w", "wi.b", "wf.w", "wf.b")),  # the rank's heads
              ({"up.w": 1, "down.w": 0, **{s: 0 for s in _MLSTM_PROJ}}, {},
               ("wi.w", "wf.w"))],  # the rank's inner channels
    "SLSTM": [({"up.w": 1, "down.w": 0, "wo.w": d}, {}, _SLSTM_WHOLE)
              for d in (1, 0)],  # the rank's units
}
_VOCAB = {"embed.w": 0, "lm_head.w": 1}
# leaves packed [D, 2 d_inner], x and z side by side, by module kind
_PACKED = {"Mamba": "in_proj.w", "MLSTM": "up.w"}
_KV = ("k", "v", "k_q", "v_q", "k_s", "v_s")  # attention's cache leaves


@dataclasses.dataclass(frozen=True)
class Plan:
    """``split``: {parameter: (dim, model axes)} of the leaves bound as
    their block; ``partial``: {parameter: model axes} of the whole leaves
    whose gradient is a partial sum over them; ``packed``: Mamba's
    ``in_proj`` and mLSTM's ``up`` leaves among ``split`` (bound as the
    rank's x and z blocks); ``axes``:
    the mesh's model axes of more than one rank."""

    split: Dict[str, Tuple[int, Tuple[str, ...]]]
    partial: Dict[str, Tuple[str, ...]]
    packed: FrozenSet[str]
    axes: Tuple[str, ...]


def plan(cfg, mesh, model) -> Plan:
    """The plan of ``model`` (the port's module tree, on ``meta`` or not)
    for ``cfg`` on ``mesh`` (a DeviceMesh or ``AbstractMesh``)."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import mesh_shape, model_axes
    shape = mesh_shape(mesh)
    pol = sh.ShardingPolicy.for_arch(cfg, mesh)
    axes = tuple(a for a in model_axes(mesh) if shape[a] > 1)
    params = dict(model.named_parameters())

    def split_axes(name: str, dim: int) -> Tuple[str, ...]:
        entry = sh.param_spec(cfg, mesh, pol, name, params[name])[dim]
        named = () if entry is None else ((entry,) if isinstance(entry, str)
                                          else tuple(entry))
        return tuple(a for a in named if a in axes)

    split, partial = {}, {}
    if not axes:
        return Plan(split, partial, frozenset(), axes)
    for prefix, mod in model.named_modules():
        for core, kv, whole in _SPLIT.get(type(mod).__name__, ()):
            leaf = {s: f"{prefix}.{s}" for s in (*core, *kv, *whole)}
            got = {s: split_axes(leaf[s], d) for s, d in core.items()
                   if leaf[s] in params}
            mod_axes = set(got.values())
            if len(mod_axes) != 1 or () in mod_axes:
                continue  # not this way
            (ax,) = mod_axes
            for s in got:
                split[leaf[s]] = (core[s], ax)
            kv_axes = {split_axes(leaf[s], d) for s, d in kv.items()
                       if leaf[s] in params}
            kv_ax = kv_axes.pop() if len(kv_axes) == 1 else ()
            if ax[:len(kv_ax)] != kv_ax:
                kv_ax = ()
            rest = tuple(a for a in ax if a not in kv_ax)
            for s, d in kv.items():
                if leaf[s] in params:
                    if kv_ax:
                        split[leaf[s]] = (d, kv_ax)
                    if rest:
                        partial[leaf[s]] = rest
            for s in whole:
                if leaf[s] in params:
                    partial[leaf[s]] = ax
            break
    vocab = {n: d for n, d in _VOCAB.items() if n in params}
    got = {n: split_axes(n, d) for n, d in vocab.items()}
    if len(set(got.values())) == 1 and () not in got.values():
        split.update({n: (vocab[n], ax) for n, ax in got.items()})
    packed = set()
    for n in split:
        prefix, _, suffix = n.partition(".mixer.")
        if suffix and _PACKED.get(type(model.get_submodule(
                prefix + ".mixer")).__name__) == suffix:
            packed.add(n)
    return Plan(split, partial, frozenset(packed), axes)


def cache_blocks(cfg, p: Plan):
    """(kept, seq). ``kept``: {slot: {leaf: {group dim: axes}}}, the cache
    leaves that a split mixer reads and writes as the rank's block (its KV
    heads, Mamba's channels, mLSTM's ``C`` and ``n`` over the head dim,
    sLSTM's ``c`` over the units), so a step hands them out in place.
    ``seq``: {slot: axes} of the attention and MLA slots, which read
    their cache's sequence dim (group dim 1) as the rank's block where
    the cache splits it over ``axes`` (all the model axes: JAX's
    ``cache_spec`` when the KV heads do not divide them; MLA's latent
    always)."""
    kept, seq = {}, {}
    for j, spec in enumerate(cfg.pattern):
        mixer = f"groups.0.{j}.mixer."
        if spec.mixer in ("attn", "attn_cross", "mla") and p.axes:
            seq[str(j)] = p.axes
        if spec.mixer in ("attn", "attn_cross") and mixer + "wk.w" in p.split:
            ax = p.split[mixer + "wk.w"][1]
            kept[str(j)] = {k: {2: ax} for k in _KV}
        elif spec.mixer == "mamba" and mixer + "conv_b" in p.split:
            ax = p.split[mixer + "conv_b"][1]
            kept[str(j)] = {"conv": {2: ax}, "ssm": {1: ax}}
        elif spec.mixer == "mlstm" and mixer + "up.w" in p.split:
            ax = p.split[mixer + "up.w"][1]
            kept[str(j)] = {"C": {2: ax}, "n": {2: ax}}
        elif spec.mixer == "slstm" and mixer + "up.w" in p.split:
            kept[str(j)] = {"c": {1: p.split[mixer + "up.w"][1]}}
    return kept, seq


def _group(mesh, axes):
    """One process group over ``axes`` (flattened when there are more),
    its ranks in ``collectives.axis_index`` order."""
    if len(axes) == 1:
        return mesh.get_group(tuple(mesh.mesh_dim_names).index(axes[0]))
    return mesh[tuple(axes)]._flatten().get_group()


def _exchange(block: torch.Tensor, mesh, axes, sends, recvs) -> torch.Tensor:
    """Move the two column halves of ``block`` [D, 2w]: half s goes to
    rank d for each (d, s) in ``sends``; the result's half s comes from
    rank r for each (r, s) in ``recvs``. One all-to-all over ``axes``."""
    import torch.distributed as dist

    from repro_torch.launch import collectives as cc
    M = cc.axis_size(mesh, axes)
    w = block.shape[1] // 2
    rows = block.T
    sends, recvs = sorted(sends), sorted(recvs)
    inp = torch.cat([rows[s * w:(s + 1) * w] for _, s in sends]).contiguous()
    in_splits, out_splits = [0] * M, [0] * M
    for d, _ in sends:
        in_splits[d] = w
    for r, _ in recvs:
        out_splits[r] = w
    out = torch.empty_like(inp)
    dist.all_to_all_single(out, inp, out_splits, in_splits, group=_group(mesh, axes))
    halves = [None, None]
    for i, (_, s) in enumerate(recvs):
        halves[s] = out[i * w:(i + 1) * w]
    return torch.cat(halves).T.contiguous()


def to_xz(block: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``in_proj``'s block on ``axes`` as JAX lays it ([D, 2 d_inner] cut
    in M contiguous blocks: column chunk k of 2M, each d_inner / M wide,
    on rank k // 2) -> the rank's x and z chunks side by side (chunks r
    and M + r on rank r), which ``mamba`` splits in two. Only those
    columns move (for M = 2 rank 0 holds all of x)."""
    from repro_torch.launch import collectives as cc
    M, r = cc.axis_size(mesh, axes), cc.axis_index(mesh, axes)
    sends = [(k % M, k - 2 * r) for k in (2 * r, 2 * r + 1)]
    recvs = [(k // 2, k // M) for k in (r, M + r)]
    return _exchange(block, mesh, axes, sends, recvs)


def from_xz(block: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``to_xz``'s inverse (the gradient of the bound ``in_proj`` back to
    JAX's block)."""
    from repro_torch.launch import collectives as cc
    M, r = cc.axis_size(mesh, axes), cc.axis_index(mesh, axes)
    sends = [(k // 2, k // M) for k in (r, M + r)]
    recvs = [(k % M, k - 2 * r) for k in (2 * r, 2 * r + 1)]
    return _exchange(block, mesh, axes, sends, recvs)


class _XZ(torch.autograd.Function):
    """``to_xz`` with ``from_xz`` as its gradient."""

    @staticmethod
    def forward(ctx, block, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return to_xz(block, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return from_xz(grad.contiguous(), ctx.mesh, ctx.axes), None, None


def bind_xz(block: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``to_xz`` of a bound ``in_proj`` (or mLSTM ``up``) block, its
    gradient laid back out as JAX's block (``from_xz``)."""
    return _XZ.apply(block, mesh, axes)
