"""FSDP in the port's sharded steps: weights split over the data axes too,
gathered a block at a time, on gloo ranks against the JAX package's
unsharded steps.

The reduced configs are under ``FSDP_THRESHOLD``, so every case passes
``fsdp=True`` (JAX's switch): each large weight's contraction dim is then
split over the data axes as well as its spec's model axes, and the steps
gather it over the data axes when its block runs (``steps._Gathered``).
R1: JAX's own sharded steps fail on jax 0.9.0, so the sharded steps are
held against JAX's jitted unsharded ones, as ``test_torch_tp_train.py``
and ``test_torch_tp_serve.py`` hold them.

Training, two steps from JAX's parameters on the synthetic batches (4 x
16, labels masked unevenly over the rows), on (2, 2) (``data``,
``model``): qwen3 with remat on, off, and on with the ``dots`` policy and
tied embeddings (the embedding bound twice, at the lookup and at the
head); moonshot at microbatch 2 with remat on (EP; the f32 sum over the
microbatches of reduce-scattered blocks) and with int8 compression;
jamba with remat on (Mamba's ``in_proj`` exchanged under autograd);
whisper with remat on (the encoder); on (2, 2, 2) (``data``, ``model_a``,
``model_b``): qwen3 and moonshot with remat on.

Held for each: every metric of every step within ``METRIC_RTOL`` of
JAX's; without microbatching or compression, each step's gradient (what
AdamW is given, gathered) within ``GRAD_TOL``; the state after two steps
within ``test_torch_sharded_step.py``'s tolerances (a compressed step's
too); every leaf bound in its tensor-parallel block (its data axes
gathered whole) and at least one leaf stored smaller than it is bound.
Under remat, at every bind no weight gathered for another group of the
stack is alive (one group's gathered weights at a time, plus the
embedding, the final norm and the head), and each block gradient arrives
as the rank's block, every gradient of group g before group g - 1's
recomputation binds its weights.

``test_torch_fsdp_serve.py`` holds the prefill and decode steps the same
way.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import steps as jax_steps
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.grad_compress import init_residual as jax_init_residual
from repro_torch.models import transformer as TT
from test_torch_sharded_step import configs
from test_torch_tp_train import (STEPS, _jax_tree, batch_of, bound_shape,
                                 check_train, jax_specs)
from test_torch_train_step import (METRIC_RTOL, RESIDUAL_SCALE, ROUNDED_OTHER_WAY,
                                   STATE_ATOL, STATE_TOL, assert_leaves_close,
                                   one_device_mesh)
from torch_ranks import run_ranks, save_tree

torch.set_num_threads(1)

B, S = 4, 16
AXES = ("data", "model")
SPLIT = ("data", "model_a", "model_b")
MOE = "moonshot-v1-16b-a3b"
QWEN3 = "qwen3-4b"
REMAT = {"remat": True}
TRAIN = {  # id -> (mesh, arch, config change, step options)
    "2x2-qwen3-remat": ((2, 2), QWEN3, REMAT, {}),
    "2x2-qwen3-no-remat": ((2, 2), QWEN3, {}, {}),
    "2x2-qwen3-dots-tied": ((2, 2), QWEN3, {"remat": True, "remat_policy": "dots",
                                            "tie_embeddings": True}, {}),
    "2x2-moonshot-microbatch2": ((2, 2), MOE, REMAT, {"microbatch": 2}),
    "2x2-moonshot-compress": ((2, 2), MOE, {}, {"compress_grads": True}),
    "2x2-jamba-remat": ((2, 2), "jamba-v0.1-52b", REMAT, {}),
    "2x2-whisper-remat": ((2, 2), "whisper-large-v3", REMAT, {}),
}
TRAIN_SPLIT = {
    "2x2x2-qwen3-remat": ((2, 2, 2), QWEN3, REMAT, {}),
    "2x2x2-moonshot-remat": ((2, 2, 2), MOE, REMAT, {}),
}


def train_ranks(cases: dict, root, axes) -> dict:
    """The ranks' outputs of ``cases`` (one mesh size), FSDP on, the bind
    and gradient events recorded."""
    specs = []
    for cid, (mesh, arch, change, opts) in cases.items():
        save_tree(root / f"{cid}.npz", _jax_tree(arch, tuple(sorted(change.items()))))
        specs.append(dict(arch=arch, change=change, opts=opts, params=f"{cid}.npz",
                          mask=True, mesh=list(mesh), axes=list(axes)))
    world = math.prod(next(iter(cases.values()))[0])
    outs = run_ranks("train", root, world, timeout=400,
                     mesh=[1] * (len(axes) - 1) + [world], axes=list(axes),
                     batch=[B, S], steps=STEPS, cases=specs, record=True,
                     live=True, fsdp=True)
    return {cid: [r[i] for r in outs] for i, cid in enumerate(cases)}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    out = train_ranks(TRAIN, tmp_path_factory.mktemp("fsdp_train"), AXES)
    out.update(train_ranks(TRAIN_SPLIT, tmp_path_factory.mktemp("fsdp_split"),
                           SPLIT))
    return out


ALL_TRAIN = {**TRAIN, **TRAIN_SPLIT}


@functools.lru_cache(maxsize=None)
def jax_run(arch, change, opts):
    """JAX's unsharded steps with ``opts``: (final state, metrics a step),
    as numpy."""
    jc, _ = configs(arch, dict(change))
    jparams = jax.tree_util.tree_map(jnp.asarray, _jax_tree(arch, change))
    jstate = {"params": jparams, "opt": jax_adamw_init(jparams)}
    if dict(opts).get("compress_grads"):
        jstate["residual"] = jax_init_residual(jparams)
    jstep = jax.jit(jax_steps.make_train_step(
        jc, jax_steps.StepOptions(opt=JaxAdamW(), **dict(opts))))
    metrics = []
    for s in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in batch_of(jc, s).items()}
        with one_device_mesh():
            jstate, jm = jstep(jstate, batch)
        metrics.append({k: float(v) for k, v in jm.items()})
    return jax.tree_util.tree_map(np.asarray, jstate), metrics


def check_with_opts(outs, cid, case):
    """``check_train``'s metrics and state checks for a step with
    microbatching or compression (against JAX's step with the same
    options; its gradients are not the plain loss's)."""
    _, arch, change, opts = case
    _, tc = configs(arch, change)
    jstate, jmetrics = jax_run(arch, tuple(sorted(change.items())),
                               tuple(sorted(opts.items())))
    for r, out in enumerate(outs):
        assert out["step"] == STEPS
        assert out["metrics"] == outs[0]["metrics"], r
    for s, (m, jm) in enumerate(zip(outs[0]["metrics"], jmetrics)):
        assert set(m) == set(jm)
        for k, v in m.items():
            assert abs(v - jm[k]) <= METRIC_RTOL * abs(jm[k]), (cid, s, k, v, jm[k])
    compressed = bool(opts.get("compress_grads"))
    lr_sum = sum(m["lr"] for m in jmetrics)
    want = {"params": jstate["params"], "master": jstate["opt"]["master"],
            "m": jstate["opt"]["m"], "v": jstate["opt"]["v"]}
    if compressed:
        want["residual"] = jstate["residual"]
    full = outs[0]["full"]
    for part, w in want.items():
        assert_leaves_close(
            tc, full[part], w, STATE_TOL, f"{cid} {part}", atol=STATE_ATOL[part],
            allowed=ROUNDED_OTHER_WAY if compressed else 0.0,
            scale=RESIDUAL_SCALE if compressed and part == "residual" else 1.0,
            zero_grad_atol=lr_sum if part in ("params", "master") else None)


def check_fsdp_binds(binds, stored, case, axes, what):
    """Each bind: every leaf in its tensor-parallel block (``bound_shape``:
    cut by its spec's model axes only, so whole over the data axes); at
    least one leaf stored smaller than it is bound (``stored``: {leaf:
    the rank's block's shape}, given for training) or gathered over more
    axes than the model axes it is bound whole over (serving)."""
    mesh, arch, change = case[:3]
    jc, tc = configs(arch, dict(change))
    jm, jpol, specs = jax_specs(jc, mesh, axes)
    sizes = dict(zip(axes, mesh))
    shapes = {n: tuple(p.shape) for n, p in
              TT.init_params(tc, device="meta").named_parameters()}
    assert binds, what
    for bind in binds:
        over_data = 0
        for n, rec in bind.items():
            want, whole = bound_shape(jc, tc, jm, jpol, specs, n, shapes[n], sizes)
            assert rec["shape"] == want, (what, n, rec)
            if stored is not None:
                over_data += math.prod(stored[n]) < math.prod(want)
            else:
                over_data += rec["gathers"] > whole
        assert over_data, what


def check_live(events, blocks, num_groups, what):
    """Under remat: at each bind, the gathered stack weights still alive
    belong to one group at most (the bound block's own, for a stack
    block); every parameter's gradient arrives once, as the rank's block;
    group g's gradients all before group g - 1's last bind (its
    recomputation)."""
    binds = [(i, e[1], e[2]) for i, e in enumerate(events) if e[0] == "bind"]
    grads = [(i, e[1], e[2]) for i, e in enumerate(events) if e[0] == "grad"]
    for i, unit, alive in binds:
        assert len(alive) <= 1, (what, i, unit, alive)
        if unit.startswith("groups."):
            assert set(alive) <= {int(unit.split(".")[1])}, (what, i, unit, alive)
    got = {}
    for _, n, shape in grads:
        got[n] = got.get(n, 0) + 1
        assert shape == tuple(blocks[n].shape), (what, n, shape)
    assert set(got) == set(blocks), what
    for g in range(1, num_groups):
        last_grad = max(i for i, n, _ in grads if n.startswith(f"groups.{g}."))
        recompute = max(i for i, unit, _ in binds if unit.startswith(f"groups.{g - 1}."))
        assert last_grad < recompute, (what, g, last_grad, recompute)


@pytest.mark.parametrize("cid", list(ALL_TRAIN))
def test_fsdp_train_steps_match_jax(trained, cid):
    mesh, arch, change, opts = ALL_TRAIN[cid]
    if opts:
        check_with_opts(trained[cid], cid, ALL_TRAIN[cid])
    else:
        check_train(trained[cid], cid, (mesh, arch, change))


@pytest.mark.parametrize("cid", list(ALL_TRAIN))
def test_fsdp_train_binds_gather_the_data_axes(trained, cid):
    for r, out in enumerate(trained[cid]):
        stored = {n: tuple(t.shape) for n, t in out["blocks"]["params"].items()}
        check_fsdp_binds(out["binds"], stored, ALL_TRAIN[cid],
                         SPLIT if len(ALL_TRAIN[cid][0]) == 3 else AXES,
                         f"{cid} rank {r}")


@pytest.mark.parametrize("cid", [c for c, v in ALL_TRAIN.items()
                                 if v[2].get("remat")])
def test_fsdp_remat_holds_one_group_at_a_time(trained, cid):
    _, arch, change, _ = ALL_TRAIN[cid]
    _, tc = configs(arch, change)
    for r, out in enumerate(trained[cid]):
        (events,) = out["live"]
        check_live(events, out["blocks"]["params"], tc.num_groups, f"{cid} rank {r}")


def test_fsdp_without_remat_keeps_each_groups_weights(trained):
    """Remat off: autograd keeps the gathered weights its backward needs,
    so the last group binds while the first group's are still alive (what
    ``check_live`` counts is alive weights, not nothing)."""
    for r, out in enumerate(trained["2x2-qwen3-no-remat"]):
        (events,) = out["live"]
        assert max(len(e[2]) for e in events if e[0] == "bind") == 2, r
