"""Step functions: the units the trainer and the server run.

Counterpart of ``repro/launch/steps.py``: ``make_train_step`` (forward,
backward and the AdamW update, with optional gradient accumulation over
microbatches and int8 error-feedback gradient compression),
``make_prefill_step`` (prompt pass returning the last logits and the
cache) and ``make_serve_step`` (one greedy decode token against the
cache). JAX returns functions for ``jax.jit``; PyTorch runs them eagerly.

Sharded training (``make_train_step(cfg, opts, mesh=)``, with
``train_state_specs`` and ``init_train_state`` or ``shard_train_state``):
one process a rank of a ``DeviceMesh``, every leaf of the state a DTensor
laid out by ``launch/sharding.py``'s rules (ZeRO: AdamW's state inherits
each parameter's spec), the batch's rows on the data axes, the products
that the specs split over the model axes split there (tensor-parallel,
``launch/tensor_parallel.py``), each block's weights gathered over the
data axes when the block runs (``_Gathered``). JAX expresses the same
step as one GSPMD program constrained by ``grad_shardings``; the results
are the same.

Per-shard init (``init_train_state``, ``init_sharded_params``): each rank
makes its blocks of the state leaf by leaf, drawing each parameter whole
from its own generator (``models.common.make_leaf``: the values of
``init_params(cfg, seed)``) and keeping its block, so no rank ever holds
more than its blocks and one whole leaf.

Sharded serving (``make_sharded_prefill_step``, ``make_sharded_serve_step``):
JAX's prefill and serve steps under ``jax.jit`` with the dry-run's
in/out shardings (``launch/dryrun.py``), the cache as DTensors in JAX's
stacked layout, updated in place by decode (JAX donates it).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeCase
from repro_torch.models import transformer as T
from repro_torch.models.common import CacheSlot, f32
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.grad_compress import compress_with_feedback
from repro_torch.optim.schedule import cosine_schedule

__all__ = ["StepOptions", "TRANSIENT_F32_FACTOR", "auto_microbatch",
           "make_train_step", "train_state_specs", "shard_train_state",
           "init_train_state", "init_sharded_params", "init_bound_bytes",
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
    """The sharded train state of an unsharded one (weights carried
    across whole, ``convert.state_from_jax``, made alike on every rank):
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


def _like(dt, local: torch.Tensor):
    """A DTensor of ``local`` laid out as ``dt`` (a block of its shape)."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, dt.device_mesh, dt.placements, shape=dt.shape,
                              stride=dt.stride())


def init_sharded_params(cfg: ArchConfig, shardings: dict, seed: int = 0,
                        device="cuda") -> dict:
    """{name: DTensor} of ``init_params(cfg, seed, device)``'s parameters
    laid out by ``shardings`` (``sharding.params_shardings``), made leaf by
    leaf: each drawn whole (``common.make_leaf``), the rank's block kept,
    the whole leaf freed before the next is drawn. What the sharded
    prefill and decode steps take."""
    from repro_torch.launch.sharding import distribute
    from repro_torch.models.common import make_leaf, resolve_device
    device = resolve_device(device)
    return {n: distribute(make_leaf(leaf, seed, device), shardings[n])
            for n, leaf in T.leaves(cfg).items()}


def init_train_state(cfg: ArchConfig, shardings: dict, seed: int = 0,
                     device="cuda", *, compress: bool = False) -> dict:
    """The sharded train state, ``shard_train_state``'s of ``init_params
    (cfg, seed, device)`` + ``adamw_init`` (+ ``init_residual``), made
    block by block: the leaves in ``train_state_specs``' order, each
    parameter drawn whole, the rank's block kept (``shardings``, as
    ``train_state_specs`` gives them), the whole leaf freed, then the
    block's f32 master and zeroed m and v (and residual). A rank's peak
    is its blocks of the state plus ``init_bound_bytes``' transient."""
    from repro_torch.launch.sharding import distribute
    from repro_torch.models.common import make_leaf, resolve_device
    device = resolve_device(device)
    psh = shardings["params"]
    params, master, m, v, residual = {}, {}, {}, {}, {}
    for n, leaf in T.leaves(cfg).items():
        params[n] = p = distribute(make_leaf(leaf, seed, device), psh[n])
        block = p.to_local()
        master[n] = _like(p, block.to(torch.float32, copy=True))
        for tree in (m, v, residual) if compress else (m, v):
            tree[n] = _like(p, torch.zeros(block.shape, dtype=torch.float32,
                                           device=device))
    state = {"params": params,
             "opt": {"master": master, "m": m, "v": v,
                     "step": torch.zeros((), dtype=torch.int32, device=device)}}
    if compress:
        state["residual"] = residual
    return state


def init_bound_bytes(cfg: ArchConfig) -> int:
    """The most ``init_train_state`` holds above the blocks it has made:
    twice the largest whole leaf in f32 (a dense leaf is drawn in f32 and
    cast, the whole leaf and its cast live together, then the rank's
    block is cut from the cast)."""
    return 2 * 4 * max(leaf.numel for leaf in T.leaves(cfg).values())


class _Gathered:
    """The weights of a sharded step, gathered for it block by block: a
    compute model with no storage of its own (built on ``meta``) whose
    ``binder`` it is. ``start(params)`` holds a step's parameters
    ({name: DTensor}); the model code binds each block's weights when the
    block runs and unbinds them after it (``transformer._bound``; the
    embedding, final norm and head where they are used, whisper's encoder
    a layer at a time), so a gathered weight is freed once its block has
    run (under remat, gathered again by the recomputation); ``stop``
    unbinds everything. A parameter is bound as ``taken`` places it:
    - tensor-parallel (``launch.tensor_parallel.plan``, from JAX's specs):
      a leaf whose compute the model axes split is this rank's block,
      ``Shard(d)`` on those axes (Mamba's ``in_proj`` then exchanged into
      the rank's x and z blocks, ``tensor_parallel.bind_xz``); the model
      code computes its part (``tp``, a ``collectives.Split``);
    - under EP, each MoE expert weight as this rank's experts only:
      ``Shard(0)`` on each axis of ``cfg.ep_axis`` (one name or a tuple),
      in mesh order, major to minor, as ``collectives.axis_index`` counts
      the experts;
    - every other axis ``Replicate``: gathered whole (the data axes, the
      leftover model axes of a 2-D split, the leaves of a module the plan
      does not split).
    A leaf already stored as it is bound (every leaf on one rank, a leaf
    with no data-axis shard) is bound as its block, with no
    redistribution. With ``requires_grad`` (training), ``start`` returns
    each parameter's block as a leaf that requires grad: the bound weight
    is computed from it, so its gradient arrives as the rank's block, a
    block's gradients reduced (``partial``: a reduce-scatter over the
    data axes that shard the leaf, an all-reduce over those that do not)
    in the backward of that block. ``gathered_peak``: the most bytes of
    gathered weights alive at once in the last step (at a bind). The
    train, prefill and decode steps share it; each step function carries
    its own as ``step.weights``."""

    def __init__(self, cfg: ArchConfig, mesh, *, requires_grad: bool):
        from repro_torch.launch import collectives as cc
        from repro_torch.launch import tensor_parallel as tpar
        from repro_torch.models.transformer import init_params, unit_of
        self.mesh = mesh
        self.names = tuple(mesh.mesh_dim_names)
        self.ep_axes = cc.as_axes(cfg.ep_axis)
        self.requires_grad = requires_grad
        self.model = init_params(cfg, device="meta", requires_grad=requires_grad)
        self.model.binder = self
        self.plan = tpar.plan(cfg, mesh, self.model)
        self.tp = cc.Split(mesh, self.plan.axes) if self.plan.axes else None
        self.vocab_axes = self.plan.split.get("embed.w", (0, None))[1]
        self.kept, self.seq = tpar.cache_blocks(cfg, self.plan)
        self.slots, self.units = {}, {}
        for n, p in self.model.named_parameters():
            prefix, _, leaf = n.rpartition(".")
            self.slots[n] = (self.model.get_submodule(prefix), leaf, p)
            self.units.setdefault(unit_of(n), []).append(n)
        self.params, self.blocks, self.rows = None, {}, ()
        self.gathered, self.gathered_peak = [], 0  # (weakref, bytes); bytes

    def _ep(self, n: str, a: str) -> bool:
        return a in self.ep_axes and "experts" in n.split(".")

    def _placement(self, n: str, a: str):
        """Parameter ``n``'s placement on axis ``a`` as bound: the experts
        under EP, a split leaf's block, else whole."""
        from torch.distributed.tensor import Replicate, Shard
        if self._ep(n, a):
            return Shard(0)
        dim, axes = self.plan.split.get(n, (0, ()))
        return Shard(dim) if a in axes else Replicate()

    def taken(self, n: str) -> tuple:
        """The placements the compute model is given parameter ``n`` in."""
        return tuple(self._placement(n, a) for a in self.names)

    def partial(self, n: str, rows: tuple) -> tuple:
        """The placements of a rank's gradient of ``n``: a partial sum over
        the row axes and, for a whole leaf that feeds a split module's part
        only, over that module's model axes; else as bound."""
        from torch.distributed.tensor import Partial
        part = self.plan.partial.get(n, ())
        return tuple(Partial() if a in rows or a in part else self._placement(n, a)
                     for a in self.names)

    def _same(self, a: tuple, b: tuple) -> bool:
        """Whether two placements give every rank the same block (an axis
        of one rank places nothing)."""
        return all(x == y or self.mesh.size(i) == 1
                   for i, (x, y) in enumerate(zip(a, b)))

    def start(self, params: dict, rows: tuple = ()) -> dict:
        """Hold ``params`` ({name: DTensor}) for a step whose batch rows lie
        on ``rows``; returns (with ``requires_grad``) {name: the rank's
        block as a leaf that requires grad}, else {}."""
        self.params, self.rows = params, rows
        self.blocks, self.gathered, self.gathered_peak = {}, [], 0
        if self.requires_grad:
            self.blocks = {n: dt.to_local().detach().requires_grad_()
                           for n, dt in params.items()}
        return self.blocks

    def leaf(self, n: str) -> torch.Tensor:
        """Parameter ``n`` as ``taken`` places it (gathered unless stored so)."""
        from torch.distributed.tensor import DTensor

        from repro_torch.launch import tensor_parallel as tpar
        dt, taken = self.params[n], self.taken(n)
        if self.requires_grad:
            block = self.blocks[n]
            grad = self.partial(n, self.rows)
            if self._same(dt.placements, taken) and self._same(dt.placements, grad):
                t = block
            else:
                t = DTensor.from_local(
                    block, self.mesh, dt.placements, shape=dt.shape,
                    stride=dt.stride()).redistribute(self.mesh, taken).to_local(
                        grad_placements=grad)
        elif self._same(dt.placements, taken):
            t = dt.to_local()
        else:
            t = dt.redistribute(self.mesh, taken).to_local()
        if n in self.plan.packed:
            t = tpar.bind_xz(t, self.mesh, self.plan.split[n][1])
        st = t.untyped_storage()
        if st._cdata != dt.to_local().untyped_storage()._cdata:
            self.gathered.append((weakref.ref(st), st.nbytes()))
        return t

    def bind(self, unit: str) -> None:
        """Bind the weights of ``unit`` (``transformer.unit_of``)."""
        for n in self.units.get(unit, ()):
            mod, leaf, _ = self.slots[n]
            mod._parameters[leaf] = self.leaf(n)
        self.gathered = [(r, b) for r, b in self.gathered if r() is not None]
        self.gathered_peak = max(self.gathered_peak,
                                 sum(b for _, b in self.gathered))

    def unbind(self, unit: str) -> None:
        """Put ``unit``'s ``meta`` parameters back (the gathered weights
        are freed once nothing else holds them)."""
        for n in self.units.get(unit, ()):
            mod, leaf, meta = self.slots[n]
            mod._parameters[leaf] = meta

    def stop(self) -> None:
        for unit in self.units:
            self.unbind(unit)
        self.params, self.blocks = None, {}


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
    - compute: ``_Gathered``'s model, given each parameter whole over the
      data axes, its block over the model axes that split its compute
      (tensor-parallel) and, under EP, this rank's experts only, a
      block's weights gathered when it runs and freed after it (under
      remat, gathered again by the recomputation). The loss is
      ``loss_fn``'s with the mesh: each data rank's objective is its part
      of the global loss;
    - gradients: taken of each parameter's block (``_Gathered.start``);
      a bound weight's gradient is a partial sum over the row axes
      (DTensor ``Partial``; also over the model axes for a whole leaf
      that feeds a split module's part only), laid out as bound over the
      other axes, and the backward of its gathering reduces and scatters
      it to the rank's block as that block's backward ends, once a
      microbatch, summed in f32 over microbatches as JAX's sharded carry
      is;
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
        blocks = weights.start(params, rows)
        try:
            for i in range(M):
                mb = {k: v[i * b + lo:i * b + lo + r] for k, v in batch.items()}
                total, parts = T.loss_fn(step_cfg, compute, mb, mesh=mesh,
                                         tp=weights.tp)
                g = torch.autograd.grad(total, list(blocks.values()),
                                        allow_unused=True)
                loss = cc.psum(total.detach(), mesh, rows)
                parts = {k: v.detach() for k, v in parts.items()}
                del total
                for (n, block), x in zip(blocks.items(), g):
                    if x is None:  # JAX: zeros
                        x = torch.zeros_like(block)
                    if M == 1:
                        grads[n] = x
                    elif n in grads:  # the f32 sum, as JAX's scan carries it
                        grads[n].add_(x.to(torch.float32))
                    else:
                        grads[n] = x.to(torch.float32)
                del g
                loss_sum = loss_sum + loss
        finally:
            weights.stop()
            del blocks
        if M > 1:
            loss = loss_sum / f32(M, loss_sum.device)
            for x in grads.values():
                x.mul_(1.0 / M)
        for n, x in grads.items():
            dt = params[n]
            grads[n] = DTensor.from_local(x, mesh, dt.placements, shape=dt.shape,
                                          stride=dt.stride())

        if opts.compress_grads:
            grads, state["residual"] = compress_with_feedback(
                grads, state["residual"], stacks=T.stacks(cfg))

        lr_scale = cosine_schedule(state["opt"]["step"])
        _, state["opt"], om = adamw_update(opts.opt, grads, state["opt"], params,
                                           lr_scale)
        metrics = {"loss": loss, **{k: v for k, v in parts.items()
                                    if v.ndim == 0}, **om}
        return state, metrics

    step.weights = weights
    return step


def greedy(cfg: ArchConfig, logits: torch.Tensor, *, mesh=None,
           axes=None) -> torch.Tensor:
    """Vocab padding masked, then argmax (the first maximum, as
    ``jnp.argmax``): logits [B, V] -> next token [B, 1] int32.

    On vocab blocks (``axes`` of ``mesh``; ``logits`` [B, V/M] this rank's
    block): each rank's maximum and its first index, then over the blocks
    the largest maximum, a tie going to the lowest block (the lowest
    global index, as ``jnp.argmax``'s first maximum)."""
    logits = logits.clone()
    if not axes:
        logits[..., cfg.vocab_size:] = float("-inf")
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    from repro_torch.launch import collectives as cc
    n = logits.shape[-1]
    lo = cc.axis_index(mesh, axes) * n
    logits[..., min(max(cfg.vocab_size - lo, 0), n):] = float("-inf")
    idx = torch.argmax(logits, dim=-1)
    best = torch.stack([logits.gather(-1, idx[:, None])[:, 0].float(),
                        (idx + lo).float()])  # f32 holds an index < 2^24
    every = cc.gather_dim(best[None], mesh, axes, 0)  # [M, 2, B]
    top = every[:, 0].amax(dim=0)
    first = torch.argmax((every[:, 0] == top).to(torch.int8), dim=0)
    tok = every[:, 1].gather(0, first[None])[0]
    return tok.to(torch.int32)[:, None]


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


class _BlockCache(T.GroupCache):
    """A cache held as DTensors in JAX's stacked layout (``launch.sharding.
    cache_spec``), each rank keeping its block, handed to the stack one
    group at a time: ``open(g)`` builds group g's leaves whole over every
    axis that splits them, except the batch dim when it is split over the
    step's row axes (the rank computes those rows only), the dims in
    ``kept`` ({slot: {leaf: {group dim: axes}}}: where a split mixer
    computes the rank's block, its KV heads, Mamba's channels or xLSTM's
    state dims) and the sequence dim of the slots in ``seq`` ({slot:
    axes}: attention and MLA read a sequence-split cache as the rank's
    block of positions; such a slot opens as a ``common.CacheSlot`` whose
    ``seq`` names the axes); ``close`` copies the rank's block back into
    the DTensor's storage, in place. With ``fresh`` (prefill) a group
    opens zeroed and nothing is gathered. A leaf split over no other axis
    of more than one rank opens as a view of its block, as the unsharded
    step's cache does, and is written in place."""

    def __init__(self, mesh, cache: dict, rows: tuple, *, fresh: bool,
                 kept: dict, seq: dict):
        self.mesh, self.fresh = mesh, fresh
        names = tuple(mesh.mesh_dim_names)
        rows = tuple(a for a in rows if mesh.size(names.index(a)) > 1)
        self.leaves = {}  # slot -> leaf -> (DTensor, {group dim: axes})
        self.seq = {}  # slot -> the axes of its leaves' sequence blocks
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
                for d, axes in kept.get(j, {}).get(k, {}).items():
                    if dims.get(d) == axes:  # the rank computes this block
                        del dims[d]
                if j in seq and dims.get(1) == seq[j]:  # its positions
                    del dims[1]
                    self.seq[j] = seq[j]
                self.leaves[j][k] = (dt, dims)

    def open(self, g: int) -> dict:
        from repro_torch.launch import collectives as cc
        out = {}
        for j, slot in self.leaves.items():
            out[j] = CacheSlot()
            out[j].seq = self.seq.get(j, ())
            for k, (dt, dims) in slot.items():
                x = dt.to_local()[g]
                if dims and self.fresh:
                    shape = list(x.shape)
                    for d, axes in dims.items():
                        shape[d] *= cc.axis_size(self.mesh, axes)
                    x = torch.zeros(shape, dtype=x.dtype, device=x.device)
                else:
                    for d, axes in dims.items():
                        x = cc.gather_dim(x, self.mesh, axes, d)
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
                    y = cc.block(y, self.mesh, axes, d)
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
    - compute: ``_Gathered``'s model (each weight whole over the data
      axes and its tensor-parallel block over the model axes, this rank's
      experts under EP; a block's weights gathered when the block runs
      and freed after it) on this rank's rows
      (``cfg.act_sharding``'s axes when B divides over them, else every
      row); each split module computes the rank's part;
    - logits: a DTensor ``P(b_ax, None)``, ``b_ax`` the data axes when B
      divides over them (the vocab blocks gathered); the cache: DTensors
      in JAX's stacked layout by ``sharding.cache_shardings`` (sized
      ``cache_len``, default S), each rank keeping its block. The stack
      writes one group's cache at a time: a leaf whose split is the
      rank's compute split (KV heads, Mamba's channels, xLSTM's state
      dims) or the sequence of an attention or MLA cache (each rank
      computes K/V over the whole prompt and writes the positions of its
      block) in place, the others whole over the model axes for the
      rank's rows, of which the rank keeps its block.

    The results are the unsharded step's: on one rank, bit for bit."""
    from torch.distributed.tensor import DTensor

    from repro_torch.launch import collectives as cc
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
        weights.start(params)
        try:
            logits, _ = T.prefill(step_cfg, weights.model, tokens, media,
                                  cache_len=cache_len or S, mesh=mesh,
                                  cache=_BlockCache(mesh, cache, rows, fresh=True,
                                                    kept=weights.kept,
                                                    seq=weights.seq),
                                  tp=weights.tp)
        finally:
            weights.stop()
        if weights.vocab_axes:
            logits = cc.gather_dim(logits, mesh, weights.vocab_axes, -1)
        return _rows_out(logits, mesh, pol, B, rows), cache

    step.weights = weights
    return step


def make_sharded_serve_step(cfg: ArchConfig, mesh):
    """JAX's serve step under ``jax.jit`` with the dry-run's shardings and
    the cache donated: (params, cache, batch) -> (next token [B, 1], cache),
    on every rank of ``mesh``.

    - params as ``make_sharded_prefill_step``'s; cache: DTensors in
      ``cache_shardings``' layout (the prefill step's output); batch:
      {"tokens" [B, 1], "pos" (a Python int)[, "media" | "memory"]}, the
      tensors as the prefill step's;
    - compute: as the prefill step's, the encoder's weights (whisper)
      never bound: decode reads the memory. For each group in turn, each cache
      leaf is handed out as the rank's block where that is the rank's
      compute split or the sequence of an attention or MLA cache (split-KV
      decode: the blocks' partial softmax sums combined over the model
      axes), else gathered whole over the axes that split it (the rank's
      rows only) and the rank's block copied back after the group runs:
      the cache's DTensors are updated in place (JAX's donation) and
      returned;
    - tokens: a DTensor ``P(b_ax, None)``, greedy over the logits (over
      the vocab blocks when the head is split).

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
        weights.start(params)
        try:
            logits, _ = T.decode_step(
                step_cfg, weights.model,
                _BlockCache(mesh, cache, rows, fresh=False, kept=weights.kept,
                            seq=weights.seq),
                rows_of["tokens"], batch["pos"], media=rows_of["media"],
                memory=rows_of["memory"], mesh=mesh, tp=weights.tp)
        finally:
            weights.stop()
        tokens = greedy(cfg, logits, mesh=mesh, axes=weights.vocab_axes)
        return _rows_out(tokens, mesh, pol, B, rows), cache

    step.weights = weights
    return step
