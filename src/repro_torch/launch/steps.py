"""Step functions: the units the trainer and the server run.

Counterpart of ``repro/launch/steps.py``: ``make_train_step`` (forward,
backward and the AdamW update, with optional gradient accumulation over
microbatches and int8 error-feedback gradient compression),
``make_prefill_step`` (prompt pass returning the last logits and the
cache) and ``make_serve_step`` (one greedy decode token against the
cache). JAX returns functions for ``jax.jit``; PyTorch runs them eagerly.

Sharded training (``make_train_step(cfg, opts, mesh=)``, with
``train_state_specs`` and ``shard_train_state``): one process a rank of
a ``DeviceMesh``, every leaf of the state a DTensor laid out by
``launch/sharding.py``'s rules (ZeRO: AdamW's state inherits each
parameter's spec), the batch's rows on the data axes. JAX expresses the
same step as one GSPMD program constrained by ``grad_shardings``; the
results are the same.

Sharded serving (``make_sharded_prefill_step``, ``make_sharded_serve_step``):
JAX's prefill and serve steps under ``jax.jit`` with the dry-run's
in/out shardings (``launch/dryrun.py``), the cache as DTensors in JAX's
stacked layout, updated in place by decode (JAX donates it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeCase
from repro_torch.models import transformer as T
from repro_torch.models.common import f32
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.grad_compress import compress_with_feedback
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["StepOptions", "TRANSIENT_F32_FACTOR", "auto_microbatch",
           "make_train_step", "train_state_specs", "shard_train_state",
           "make_prefill_step", "make_serve_step", "greedy",
           "make_sharded_prefill_step", "make_sharded_serve_step"]


@dataclasses.dataclass(frozen=True)
class StepOptions:
    microbatch: int = 1  # grad-accumulation chunks over the batch dim
    compress_grads: bool = False  # int8 error-feedback (adds residual state)
    opt: AdamWConfig = AdamWConfig()


TRANSIENT_F32_FACTOR = 12  # live f32 [B', S, D]-sized buffers during a
# block's backward window (JAX's figure, from its buffer dumps)


def auto_microbatch(cfg: ArchConfig, case: ShapeCase, mesh=None,
                    *, target_bytes: int = 4 << 30) -> int:
    """The gradient-accumulation factor that keeps per-rank activation
    memory under ``target_bytes``: the remat carries (one [B', S, D] bf16
    per group, + encoder) plus the transient f32 working set of one
    block's backward, B' the rows of one data shard (the batch over the
    product of ``mesh``'s data axes; the whole batch without a mesh). M is
    a power of two, capped so each microbatch still shards over the data
    axes."""
    if case.kind != "train":
        return 1
    from repro_torch.launch.mesh import data_axes, mesh_shape
    dsize = 1
    if mesh is not None:
        for a in data_axes(mesh):
            dsize *= mesh_shape(mesh)[a]
    B = case.global_batch
    per_shard_tokens = max(B // dsize, 1) * case.seq_len
    groups = cfg.num_groups + (cfg.encoder_layers or 0)
    carry = per_shard_tokens * cfg.d_model * 2 * groups
    transient = per_shard_tokens * cfg.d_model * 4 * TRANSIENT_F32_FACTOR
    M, cap = 1, max(B // dsize, 1)
    while (carry + transient) / M > target_bytes and M * 2 <= cap:
        M *= 2
    return M


def make_train_step(cfg: ArchConfig, opts: StepOptions = StepOptions(),
                    mesh=None):
    """state = {"params": the model (its parameters require grad), "opt":
    ``adamw_init``'s dict[, "residual": ``init_residual``'s]}; batch =
    tokens/labels(/media) tensors on the model's device. Returns
    step_fn(state, batch) -> (state, metrics), the state updated in place.

    With ``microbatch=M`` the batch's rows are split into M chunks in
    order, the gradients summed in f32 and scaled by 1/M, the loss the
    mean of the chunks', ``parts`` the last chunk's. With
    ``compress_grads`` the gradients pass through ``compress_with_feedback``
    and the residual is carried. The learning rate's scale is
    ``cosine_schedule`` of the step count *before* the update (0 at step
    0, as in JAX). metrics: "loss", the 0-dim parts, "grad_norm", "lr" (0-dim
    tensors; reading one waits for the step).

    With a ``mesh`` (a DeviceMesh), the sharded step of
    ``_sharded_train_step``: the state is ``shard_train_state``'s, every
    rank passes the whole global batch and computes on its rows, and the
    metrics are the global ones."""
    if mesh is not None:
        return _sharded_train_step(cfg, opts, mesh)

    def grads_of(model, batch):
        params = dict(model.named_parameters())
        loss, parts = T.loss_fn(cfg, model, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g  # JAX: zeros
                 for (n, p), g in zip(params.items(), grads)}
        return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads

    def step(state, batch):
        model = state["params"]
        M = opts.microbatch
        if M > 1:
            B = batch["tokens"].shape[0]
            if B % M:
                raise ValueError(f"batch {B} not divisible by microbatch {M}")
            b = B // M
            loss_sum, grads = 0.0, {}
            for i in range(M):
                mb = {k: v[i * b:(i + 1) * b] for k, v in batch.items()}
                loss, parts, g = grads_of(model, mb)
                loss_sum = loss_sum + loss
                for n, x in g.items():  # the f32 sum, as JAX's scan carries it
                    if n in grads:
                        grads[n].add_(x.to(torch.float32))
                    else:
                        grads[n] = x.to(torch.float32)
                del g
            loss = loss_sum / f32(M, loss_sum.device)
            for x in grads.values():
                x.mul_(1.0 / M)
        else:
            loss, parts, grads = grads_of(model, batch)

        if opts.compress_grads:
            grads, state["residual"] = compress_with_feedback(
                grads, state["residual"], stacks=T.stacks(cfg))

        lr_scale = cosine_schedule(state["opt"]["step"])
        _, state["opt"], om = adamw_update(opts.opt, grads, state["opt"], model,
                                           lr_scale)
        metrics = {"loss": loss, **{k: v for k, v in parts.items()
                                    if v.ndim == 0}, **om}
        return state, metrics

    return step


def train_state_specs(cfg: ArchConfig, mesh, pol, *, compress: bool = False):
    """(state, shardings) of the full train state: ``state`` {"params",
    "opt": {"master", "m", "v", "step"}[, "residual"]} with tensors on the
    ``meta`` device keyed by parameter name (params in their dtype, the
    rest f32, step 0-dim int32), ``shardings`` the NamedShardings in the
    same layout: master, m, v and the residual take their parameter's
    spec, ``step`` is replicated."""
    from repro_torch.launch import sharding as sh
    from repro_torch.models.transformer import init_params
    params = {n: p.detach() for n, p in
              init_params(cfg, device="meta").named_parameters()}

    def f32():
        return {n: torch.empty(t.shape, dtype=torch.float32, device="meta")
                for n, t in params.items()}

    psh = sh.params_shardings(cfg, mesh, pol, params)
    state = {"params": params,
             "opt": {"master": f32(), "m": f32(), "v": f32(),
                     "step": torch.empty((), dtype=torch.int32, device="meta")}}
    shardings = {"params": psh,
                 "opt": {"master": psh, "m": psh, "v": psh,
                         "step": sh.NamedSharding(mesh, sh.P())}}
    if compress:
        state["residual"] = f32()
        shardings["residual"] = psh
    return state, shardings


def shard_train_state(state: dict, shardings: dict) -> dict:
    """The sharded train state of an unsharded one (``launch.train.
    build``'s ``init_state``, made alike on every rank from the seed):
    every leaf of params, master, m, v and the residual a DTensor laid
    out by ``shardings`` (``train_state_specs``'), the rank keeping its
    block; ``step`` stays a 0-dim tensor (replicated). ``state``'s
    dicts are emptied as their leaves are sharded, so a whole leaf is
    freed once its block is kept."""
    from repro_torch.launch.sharding import distribute
    from repro_torch.optim.adamw import named

    def shard(tree: dict, sh: dict) -> dict:
        out = {}
        for n in list(tree):
            out[n] = distribute(tree.pop(n), sh[n])
        return out

    params = named(state.pop("params"))
    out = {"params": shard(params, shardings["params"])}
    opt = state.pop("opt")
    out["opt"] = {k: shard(opt[k], shardings["opt"][k])
                  for k in ("master", "m", "v")}
    out["opt"]["step"] = opt["step"]
    if "residual" in state:
        out["residual"] = shard(state.pop("residual"), shardings["residual"])
    return out


class _Gathered:
    """The weights of a sharded step, gathered for it: a compute model with
    no storage of its own (built on ``meta``) whose parameters ``bind``
    sets, for the step, to each parameter gathered whole (``taken``'s
    placements: ``Replicate`` on every axis) and, under EP, to each MoE
    expert weight as this rank's experts only: ``Shard(0)`` on each axis
    of ``cfg.ep_axis`` (one name or a tuple), in mesh order, major to
    minor, as ``collectives.axis_index`` counts the experts. ``unbind``
    puts the ``meta`` parameters back, so the gathered weights are freed
    once the step drops them. The train, prefill and decode steps share
    it."""

    def __init__(self, cfg: ArchConfig, mesh, *, requires_grad: bool):
        from repro_torch.launch import collectives as cc
        from repro_torch.models.transformer import init_params
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.ep_axes = cc.as_axes(cfg.ep_axis)
        self.requires_grad = requires_grad
        self.model = init_params(cfg, device="meta", requires_grad=requires_grad)
        self.slots = {}
        for n, p in self.model.named_parameters():
            prefix, _, leaf = n.rpartition(".")
            self.slots[n] = (self.model.get_submodule(prefix), leaf, p)

    def _ep(self, n: str, a: str) -> bool:
        return a in self.ep_axes and "experts" in n.split(".")

    def taken(self, n: str) -> tuple:
        """The placements the compute model is given parameter ``n`` in."""
        from torch.distributed.tensor import Replicate, Shard
        return tuple(Shard(0) if self._ep(n, a) else Replicate()
                     for a in self.names)

    def partial(self, n: str, rows: tuple) -> tuple:
        """The placements of a rank's gradient of ``n``: a partial sum over
        the row axes, the rank's experts on the EP axes."""
        from torch.distributed.tensor import Partial, Replicate, Shard
        return tuple(Partial() if a in rows else
                     Shard(0) if self._ep(n, a) else Replicate()
                     for a in self.names)

    def bind(self, params: dict) -> list:
        """Give the compute model ``params`` ({name: DTensor}) as
        ``taken`` says; returns the bound leaves in ``params``' order."""
        from torch import nn
        leaves = []
        for n, dt in params.items():
            mod, leaf, _ = self.slots[n]
            t = nn.Parameter(dt.redistribute(self.mesh, self.taken(n)).to_local(),
                             requires_grad=self.requires_grad)
            mod._parameters[leaf] = t
            leaves.append(t)
        return leaves

    def unbind(self) -> None:
        for mod, leaf, meta in self.slots.values():
            mod._parameters[leaf] = meta


def _step_rows(cfg: ArchConfig, mesh, b: int):
    """(config, row axes, rows a rank, this rank's first row) for ``b``
    rows: the data axes of ``cfg.act_sharding`` when ``b`` divides over
    them, else every rank computes every row (``act_sharding=None``, as
    JAX's activation constraint then does nothing)."""
    from repro_torch.launch import collectives as cc
    rows = cc.as_axes(cfg.act_sharding)
    if rows and b % cc.axis_size(mesh, rows):
        cfg, rows = dataclasses.replace(cfg, act_sharding=None), ()
    r = b // cc.axis_size(mesh, rows) if rows else b
    lo = cc.axis_index(mesh, rows) * r if rows else 0
    return cfg, rows, r, lo


def _sharded_train_step(cfg: ArchConfig, opts: StepOptions, mesh):
    """The train step over ``mesh``:
    - batch: every rank gets the global batch and keeps its rows, on the
      data axes of ``cfg.act_sharding`` in JAX's order: microbatch m is
      global rows [m B/M, (m+1) B/M), and data rank i takes its
      contiguous part of each. When a microbatch's rows do not divide
      over those axes the step runs with ``act_sharding=None`` (every
      rank computes every row, as JAX's activation constraint then does
      nothing);
    - compute: ``_Gathered``'s model, given each parameter gathered whole
      and, under EP, this rank's experts only; they are freed after the
      backward pass. The loss is ``loss_fn``'s with the mesh: each data
      rank's objective is its part of the global loss;
    - gradients: a rank's gradient is a partial sum over the row axes
      (DTensor ``Partial``), replicated over the other axes (sharded on
      the EP axes for the experts); redistributing it to the parameter's
      placements reduces and scatters it, once a microbatch, summed in
      f32 over microbatches as JAX's sharded carry is;
    - update: compression (a global scale a JAX leaf) and AdamW (a global
      norm) on each rank's blocks only, in place."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import collectives as cc
    weights = _Gathered(cfg, mesh, requires_grad=True)
    compute = weights.model

    def step(state, batch):
        params = state["params"]
        M = opts.microbatch
        B = batch["tokens"].shape[0]
        if B % M:
            raise ValueError(f"batch {B} not divisible by microbatch {M}")
        b = B // M
        step_cfg, rows, r, lo = _step_rows(cfg, mesh, b)
        loss_sum, grads = 0.0, {}
        leaves = weights.bind(params)
        try:
            for i in range(M):
                mb = {k: v[i * b + lo:i * b + lo + r] for k, v in batch.items()}
                total, parts = T.loss_fn(step_cfg, compute, mb, mesh=mesh)
                g = torch.autograd.grad(total, leaves, allow_unused=True)
                loss = cc.psum(total.detach(), mesh, rows)
                parts = {k: v.detach() for k, v in parts.items()}
                del total
                for (n, dt), x, leaf in zip(params.items(), g, leaves):
                    if x is None:  # JAX: zeros
                        x = torch.zeros_like(leaf)
                    red = DTensor.from_local(
                        x, mesh, weights.partial(n, rows), shape=dt.shape,
                        stride=dt.stride()).redistribute(mesh, dt.placements)
                    if M == 1:
                        grads[n] = red
                    elif n in grads:  # the f32 sum, as JAX's scan carries it
                        grads[n].add_(red.to_local().to(torch.float32))
                    else:
                        grads[n] = red.to_local().to(torch.float32)
                del g
                loss_sum = loss_sum + loss
        finally:
            weights.unbind()
            del leaves
        if M > 1:
            loss = loss_sum / f32(M, loss_sum.device)
            for n, x in grads.items():
                x.mul_(1.0 / M)
                dt = params[n]
                grads[n] = DTensor.from_local(x, mesh, dt.placements,
                                              shape=dt.shape, stride=dt.stride())

        if opts.compress_grads:
            grads, state["residual"] = compress_with_feedback(
                grads, state["residual"], stacks=T.stacks(cfg))

        lr_scale = cosine_schedule(state["opt"]["step"])
        _, state["opt"], om = adamw_update(opts.opt, grads, state["opt"], params,
                                           lr_scale)
        metrics = {"loss": loss, **{k: v for k, v in parts.items()
                                    if v.ndim == 0}, **om}
        return state, metrics

    return step


def greedy(cfg: ArchConfig, logits: torch.Tensor) -> torch.Tensor:
    """Vocab padding masked, then argmax (the first maximum, as
    ``jnp.argmax``): logits [B, V] -> next token [B, 1] int32."""
    logits = logits.clone()
    logits[..., cfg.vocab_size:] = float("-inf")
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


def make_prefill_step(cfg: ArchConfig, cache_len: Optional[int] = None, *,
                      mesh=None):
    """(model, batch{tokens[, media]}) -> (logits [B, V], cache sized
    ``cache_len``, the prompt length by default). ``media``: vision's
    patch embeddings, or audio's frames (encoded by the step). ``mesh``:
    the DeviceMesh of ``cfg.ep_axis``."""

    @torch.no_grad()
    def step(model, batch):
        return T.prefill(cfg, model, batch["tokens"], batch.get("media"),
                         cache_len=cache_len, mesh=mesh)

    return step


def make_serve_step(cfg: ArchConfig, *, mesh=None):
    """Greedy decode: (model, cache, batch{tokens, pos[, media|memory]}) ->
    (next_token [B, 1], cache), the cache updated in place. A config with
    a cross slot passes ``memory`` (``transformer.make_memory``'s output);
    vision may pass ``media`` in its place, as in JAX. ``mesh``: the
    DeviceMesh of ``cfg.ep_axis``."""

    @torch.no_grad()
    def step(model, cache, batch):
        logits, cache = T.decode_step(
            cfg, model, cache, batch["tokens"], batch["pos"],
            media=batch.get("media"), memory=batch.get("memory"), mesh=mesh)
        return greedy(cfg, logits), cache

    return step


# -- the sharded serving steps ---------------------------------------------------

def _split_dims(dt) -> dict:
    """{tensor dim: the mesh axes it is split over, in mesh order} of a
    DTensor; axes of size 1 split nothing and are left out."""
    from torch.distributed.tensor import Shard
    mesh = dt.device_mesh
    out: dict = {}
    for i, (name, pl) in enumerate(zip(mesh.mesh_dim_names, dt.placements)):
        if isinstance(pl, Shard) and mesh.size(i) > 1:
            out[pl.dim] = out.get(pl.dim, ()) + (name,)
    return out


def _gather_dim(x: torch.Tensor, mesh, axes: tuple, dim: int) -> torch.Tensor:
    """The blocks of ``x`` along ``axes`` concatenated on ``dim``, major to
    minor in mesh order (DTensor's and JAX's layout of a split dim)."""
    import torch.distributed as dist

    from repro_torch.launch import collectives as cc
    out = x.movedim(dim, 0).contiguous()
    for g in reversed(cc.axis_groups(mesh, axes)):  # minor axis first
        full = out.new_empty((dist.get_world_size(g) * out.shape[0],
                              *out.shape[1:]))
        dist.all_gather_into_tensor(full, out, group=g)
        out = full
    return out.movedim(0, dim).contiguous() if dim else out


class _BlockCache(T.GroupCache):
    """A cache held as DTensors in JAX's stacked layout (``launch.sharding.
    cache_spec``), each rank keeping its block, handed to the stack one
    group at a time: ``open(g)`` builds group g's leaves whole over every
    axis that splits them, except the batch dim when it is split over the
    step's row axes (the rank computes those rows only); ``close`` copies
    the rank's block back into the DTensor's storage, in place. With
    ``fresh`` (prefill) a group opens zeroed and nothing is gathered.
    A leaf split over no axis of more than one rank opens as a view of
    its block, as the unsharded step's cache does."""

    def __init__(self, mesh, cache: dict, rows: tuple, *, fresh: bool):
        self.mesh, self.fresh = mesh, fresh
        names = tuple(mesh.mesh_dim_names)
        rows = tuple(a for a in rows if mesh.size(names.index(a)) > 1)
        self.leaves = {}  # slot -> leaf -> (DTensor, {group dim: axes})
        for j, slot in cache.items():
            self.leaves[j] = {}
            for k, dt in slot.items():
                dims = {d - 1: a for d, a in _split_dims(dt).items()}
                if rows and dims.get(0) == rows:  # the batch: the rank's rows
                    del dims[0]
                elif 0 in dims and rows:
                    raise ValueError(f"cache {j}.{k}: rows on {dims[0]}, the "
                                     f"step's on {rows}")
                if -1 in dims:
                    raise ValueError(f"cache {j}.{k}: the group dim is split")
                self.leaves[j][k] = (dt, dims)

    def open(self, g: int) -> dict:
        from repro_torch.launch import collectives as cc
        out = {}
        for j, slot in self.leaves.items():
            out[j] = {}
            for k, (dt, dims) in slot.items():
                x = dt.to_local()[g]
                if dims and self.fresh:
                    shape = list(x.shape)
                    for d, axes in dims.items():
                        shape[d] *= cc.axis_size(self.mesh, axes)
                    x = torch.zeros(shape, dtype=x.dtype, device=x.device)
                else:
                    for d, axes in dims.items():
                        x = _gather_dim(x, self.mesh, axes, d)
                out[j][k] = x
        return out

    def close(self, g: int, c: dict) -> None:
        from repro_torch.launch import collectives as cc
        for j, slot in self.leaves.items():
            for k, (dt, dims) in slot.items():
                if not dims:
                    continue  # written in place
                block, y = dt.to_local()[g], c[j][k]
                for d, axes in dims.items():
                    n = block.shape[d]
                    y = y.narrow(d, cc.axis_index(self.mesh, axes) * n, n)
                block.copy_(y)


def _take_rows(x, mesh, rows: tuple):
    """This rank's rows of a batch leaf (a DTensor, laid out by
    ``batch_shardings`` or otherwise): its block on the ``rows`` axes,
    every row without them; None stays None."""
    from torch.distributed.tensor import Replicate, Shard
    if x is None:
        return None
    want = tuple(Shard(0) if a in rows else Replicate()
                 for a in mesh.mesh_dim_names)
    return x.redistribute(mesh, want).to_local()


def _rows_out(y: torch.Tensor, mesh, pol, B: int, rows: tuple):
    """The computed rows ``y`` (rows ``rows``' block, or all B) as a
    DTensor laid out ``P(b_ax, None, ...)``, ``b_ax`` the data axes when
    B divides over them (JAX's dry-run's out_shardings), else replicated."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import collectives as cc
    from repro_torch.launch.sharding import P, placements
    data = tuple(pol.data)
    b_ax = data if data and B % cc.axis_size(mesh, data) == 0 else None
    have = tuple(Shard(0) if a in rows else Replicate()
                 for a in mesh.mesh_dim_names)
    shape = (B, *y.shape[1:])
    out = DTensor.from_local(y, mesh, have, shape=shape,
                             stride=torch.empty(shape, device="meta").stride())
    return out.redistribute(mesh, placements(mesh, P(b_ax, *[None] * (y.ndim - 1))))


def make_sharded_prefill_step(cfg: ArchConfig, mesh, *,
                              cache_len: Optional[int] = None):
    """JAX's prefill step under ``jax.jit`` with the dry-run's shardings
    (``launch/dryrun.py``): (params, batch) -> (logits [B, V], cache), on
    every rank of ``mesh``.

    - params: {name: DTensor} laid out by ``sharding.params_shardings``;
      batch: {"tokens" [B, S][, "media"]}, DTensors by ``batch_shardings``;
    - compute: ``_Gathered``'s model (every weight gathered whole at the
      step's start and freed at its end, this rank's experts under EP; a
      layer's weights are not gathered on their own) on this rank's rows
      (``cfg.act_sharding``'s axes when B divides over them, else every
      row);
    - logits: a DTensor ``P(b_ax, None)``, ``b_ax`` the data axes when B
      divides over them; the cache: DTensors in JAX's stacked layout by
      ``sharding.cache_shardings`` (sized ``cache_len``, default S), each
      rank keeping its block. The stack writes one group's cache at a
      time, whole over the model axes for the rank's rows, and keeps the
      rank's block of it.

    The results are the unsharded step's: on one rank, bit for bit."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import sharding as sh
    weights = _Gathered(cfg, mesh, requires_grad=False)
    pol = sh.ShardingPolicy.for_arch(cfg, mesh)

    @torch.no_grad()
    def step(params, batch):
        B, S = batch["tokens"].shape
        step_cfg, rows, _, _ = _step_rows(cfg, mesh, B)
        tokens = _take_rows(batch["tokens"], mesh, rows)
        media = _take_rows(batch.get("media"), mesh, rows)
        specs = T.init_cache(cfg, B, cache_len or S, device="meta")
        cache = {}
        for j, slot in sh.cache_shardings(cfg, mesh, pol, specs).items():
            cache[j] = {}
            for k, s in slot.items():
                spec = specs[j][k]
                block = torch.zeros(sh.shard_shape(mesh, s.spec, spec.shape),
                                    dtype=spec.dtype, device=tokens.device)
                cache[j][k] = DTensor.from_local(
                    block, mesh, sh.placements(mesh, s.spec), shape=spec.shape,
                    stride=spec.stride())
        weights.bind(params)
        try:
            logits, _ = T.prefill(step_cfg, weights.model, tokens, media,
                                  cache_len=cache_len or S, mesh=mesh,
                                  cache=_BlockCache(mesh, cache, rows, fresh=True))
        finally:
            weights.unbind()
        return _rows_out(logits, mesh, pol, B, rows), cache

    return step


def make_sharded_serve_step(cfg: ArchConfig, mesh):
    """JAX's serve step under ``jax.jit`` with the dry-run's shardings and
    the cache donated: (params, cache, batch) -> (next token [B, 1], cache),
    on every rank of ``mesh``.

    - params as ``make_sharded_prefill_step``'s; cache: DTensors in
      ``cache_shardings``' layout (the prefill step's output); batch:
      {"tokens" [B, 1], "pos" (a Python int)[, "media" | "memory"]}, the
      tensors as the prefill step's;
    - compute: as the prefill step's, the encoder's weights (whisper) not
      gathered: decode reads the memory. For each group in turn, each cache
      leaf is gathered whole over the axes that split it (the rank's rows
      only), the group runs, and the rank's block is copied back: the
      cache's DTensors are updated in place (JAX's donation) and returned;
    - tokens: a DTensor ``P(b_ax, None)``, greedy over the logits.

    The results are the unsharded step's: on one rank, bit for bit."""
    from repro_torch.launch import sharding as sh
    weights = _Gathered(cfg, mesh, requires_grad=False)
    pol = sh.ShardingPolicy.for_arch(cfg, mesh)

    @torch.no_grad()
    def step(params, cache, batch):
        B = batch["tokens"].shape[0]
        step_cfg, rows, _, _ = _step_rows(cfg, mesh, B)
        rows_of = {k: _take_rows(batch.get(k), mesh, rows)
                   for k in ("tokens", "media", "memory")}
        weights.bind({n: p for n, p in params.items()  # decode never encodes
                      if not n.startswith("encoder.")})
        try:
            logits, _ = T.decode_step(
                step_cfg, weights.model, _BlockCache(mesh, cache, rows, fresh=False),
                rows_of["tokens"], batch["pos"], media=rows_of["media"],
                memory=rows_of["memory"], mesh=mesh)
        finally:
            weights.unbind()
        return _rows_out(greedy(cfg, logits), mesh, pol, B, rows), cache

    return step
