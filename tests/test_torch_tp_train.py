"""Tensor-parallel training: the port's sharded train step with its
products split over the model axis, on four CPU ranks (gloo), against the
JAX package's unsharded step.

R1: JAX's own sharded steps fail on jax 0.9.0, so the sharded step is held
against JAX's jitted ``make_train_step`` and ``jax.value_and_grad(loss_fn)``
without a mesh. One spawned group of four ranks runs every case, each on
its own mesh, (1, 4) or (2, 2) (``data``, ``model``), two steps from
JAX's parameters on the synthetic batches (4 x 16, labels masked unevenly
over the rows, ``torch_ranks.mask_labels``), the config as the train CLI
sets it on a mesh. The learning rate is 0 at step 0, so both steps'
gradients are taken at the initial parameters, and step 1 moves them.

Cases here: qwen3 with 2 KV heads on 4 ranks (the KV projections whole,
one q head a rank reading one KV head; qk-norm; a 500-token vocabulary,
so a masked label lies in the rank that holds the padding; remat on),
qwen3 tied and MQA on (2, 2), chatglm3 with 8 heads on 4 ranks (2 q
heads a rank against a group of 4: H/M < rep; biases), moonshot (MHA,
the MoE's experts under EP on the same model axis) and deepseek (MLA,
the shared experts' MLP split); ``test_torch_tp_train_hybrid.py`` holds
jamba, whisper and vision with this file's checks.

Held: every metric of every step within ``METRIC_RTOL`` of JAX's (every
rank reports the same); every leaf of each step's gradient (what AdamW
is given, gathered) within ``GRAD_TOL`` of its largest |JAX gradient|
plus ``GRAD_ATOL``; the state after two steps (params, master, m, v)
within ``test_torch_sharded_step.py``'s tolerances; and on every rank
each leaf that JAX's ``param_spec`` splits over the model axis is bound
as that block (``bound_shape``), with no all-gather to bind it.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.launch import sharding as jsh
from repro.launch import steps as jax_steps
from repro.models import transformer as JT
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.optim.adamw import adamw_init as jax_adamw_init
from test_torch_sharded_step import configs
from test_torch_sharding_specs import jax_leaf, path_name
from test_torch_train_step import (GRAD_ATOL, GRAD_TOL, METRIC_RTOL, STATE_ATOL,
                                   STATE_TOL, assert_leaves_close, jax_batch,
                                   one_device_mesh)
from torch_ranks import mask_labels, run_ranks, save_tree

torch.set_num_threads(1)

B, S, STEPS = 4, 16, 2
AXES = ("data", "model")
MOE = "moonshot-v1-16b-a3b"
XLSTM = ("mlstm", "slstm")
CASES = {  # id -> (mesh, arch, config change)
    "1x4-qwen3-gqa": ((1, 4), "qwen3-4b",
                      {"num_kv_heads": 2, "vocab_size": 500, "remat": True}),
    "2x2-qwen3-tied-mqa": ((2, 2), "qwen3-4b",
                           {"num_kv_heads": 1, "tie_embeddings": True}),
    "1x4-chatglm3-h8": ((1, 4), "chatglm3-6b", {"num_heads": 8}),
    "2x2-moonshot": ((2, 2), MOE, {}),
    "1x4-deepseek": ((1, 4), "deepseek-v2-lite-16b", {}),
}
HYBRID = {  # test_torch_tp_train_hybrid.py's cases
    "1x4-jamba": ((1, 4), "jamba-v0.1-52b", {}),
    "2x2-jamba": ((2, 2), "jamba-v0.1-52b", {}),
    "1x4-whisper-h6": ((1, 4), "whisper-large-v3",
                       {"num_heads": 6, "num_kv_heads": 6}),
    "2x2-vision": ((2, 2), "llama-3.2-vision-90b", {}),
}


def axes_of(entry) -> tuple:
    return () if entry is None else ((entry,) if isinstance(entry, str)
                                     else tuple(entry))


def jax_specs(jc, mesh, axes) -> tuple:
    """(JAX's abstract mesh, its policy, {JAX leaf path: param_spec})."""
    jm = JaxAbstractMesh(tuple(mesh), tuple(axes))
    jpol = jsh.ShardingPolicy.for_arch(jc, jm)
    jtree = jax.eval_shape(functools.partial(JT.init_params, jc), jax.random.PRNGKey(0))
    return jm, jpol, {path_name(p): jsh.param_spec(jc, jm, jpol, p, leaf)
                      for p, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}


def bound_shape(jc, tc, jm, jpol, specs, name, shape, sizes):
    """(the shape a rank binds parameter ``name`` in, the model axes of
    JAX's spec it is bound whole over): its whole shape cut by every model
    axis that JAX's spec puts on a dim, except the leftover axes of an
    attention projection (``heads_split``'s rest, on the contraction
    dim). xLSTM's projections are cut by every such axis: the rows of
    ``wq``/``wk``/``wv``/``wo_gate`` when the heads do not divide, sLSTM's
    ``wo`` on the dim its spec splits."""
    leaf, stacked = jax_leaf(tc, name)
    spec = tuple(specs[leaf])[1:] if stacked else tuple(specs[leaf])
    named = [a for e in spec for a in axes_of(e) if a.startswith("model")]
    keys = name.split(".")
    xlstm = ("groups" in keys and "encoder" not in keys and
             tc.pattern[int(keys[keys.index("groups") + 2])].mixer in XLSTM)
    kind = keys[-2] if keys[-1] in ("w", "b") else keys[-1]
    leftover = ()
    if kind in ("wq", "wk", "wv", "wo") and not xlstm:
        _, rest = jpol.heads_split(jm, jc.num_kv_heads if kind in ("wk", "wv")
                                   else jc.num_heads)
        leftover = axes_of(rest)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in axes_of(entry):
            if a.startswith("model") and a not in leftover:
                out[d] //= sizes[a]
    return tuple(out), sum(a in leftover for a in named)


def check_binds(binds, jc, tc, mesh, axes, full_shapes, what):
    """Each bind of one rank: every leaf in ``bound_shape``'s shape, with
    one all-gather for each model axis it is bound whole over and none
    else (the reduced configs keep every weight whole over the data axes:
    no axis that cuts a leaf is gathered); at least one leaf is cut."""
    jm, jpol, specs = jax_specs(jc, mesh, axes)
    sizes = dict(zip(axes, mesh))
    assert binds, what
    for bind in binds:
        cut = 0
        for n, rec in bind.items():
            want, whole = bound_shape(jc, tc, jm, jpol, specs, n, full_shapes[n],
                                      sizes)
            assert rec["shape"] == want, (what, n, rec)
            assert rec["gathers"] == whole, (what, n, rec)
            cut += want != tuple(full_shapes[n])
        assert cut, what


def jax_tree(case):
    """JAX's parameters of a case's (mesh, arch, change) config (seed 0),
    as numpy."""
    _, arch, change = case
    return _jax_tree(arch, tuple(sorted(change.items())))


@functools.lru_cache(maxsize=None)
def _jax_tree(arch, change):
    jc, _ = configs(arch, dict(change))
    params = jax.jit(functools.partial(JT.init_params, jc))(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


def batch_of(jc, step):
    return mask_labels(jax_batch(jc, step, B=B, S=S), jc.vocab_size)


def train_ranks(cases: dict, root, axes=AXES) -> dict:
    """The ranks' outputs of ``cases`` ({id: (mesh, arch, change)}, the
    meshes of one size): one run of their ranks."""
    specs = []
    for cid, case in cases.items():
        mesh, arch, change = case
        save_tree(root / f"{cid}.npz", jax_tree(case))
        specs.append(dict(arch=arch, change=change, opts={}, params=f"{cid}.npz",
                          mask=True, mesh=list(mesh), axes=list(axes)))
    world = int(np.prod(next(iter(cases.values()))[0]))
    outs = run_ranks("train", root, world, timeout=400,
                     mesh=[1] * (len(axes) - 1) + [world], axes=list(axes),
                     batch=[B, S], steps=STEPS, cases=specs, record=True)
    return {cid: [r[i] for r in outs] for i, cid in enumerate(cases)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return train_ranks(CASES, tmp_path_factory.mktemp("tp_train"))


def jax_run(case):
    """JAX's unsharded steps of a case's config: (final state, metrics a
    step, gradients a step at the initial parameters), as numpy; the
    cases of one config share a run."""
    _, arch, change = case
    return _jax_run(arch, tuple(sorted(change.items())))


@functools.lru_cache(maxsize=None)
def _jax_run(arch, change):
    jc, _ = configs(arch, dict(change))
    jparams = jax.tree_util.tree_map(jnp.asarray, _jax_tree(arch, change))
    jstate = {"params": jparams, "opt": jax_adamw_init(jparams)}
    jstep = jax.jit(jax_steps.make_train_step(jc, jax_steps.StepOptions(opt=JaxAdamW())))
    grad = jax.jit(jax.grad(lambda p, b: JT.loss_fn(jc, p, b)[0]))
    metrics, grads = [], []
    for s in range(STEPS):
        batch = {k: jnp.asarray(v) for k, v in batch_of(jc, s).items()}
        grads.append(jax.tree_util.tree_map(np.asarray, grad(jparams, batch)))
        with one_device_mesh():
            jstate, jm = jstep(jstate, batch)
        metrics.append({k: float(v) for k, v in jm.items()})
    return jax.tree_util.tree_map(np.asarray, jstate), metrics, grads


def check_train(outs, cid, case):
    """Every assertion of the module docstring but the binds, for case
    ``cid`` = (mesh, arch, change)."""
    _, arch, change = case
    _, tc = configs(arch, change)
    jstate, jmetrics, jgrads = jax_run(case)
    for r, out in enumerate(outs):
        assert out["step"] == STEPS
        assert out["metrics"] == outs[0]["metrics"], r
    for s, (m, jm) in enumerate(zip(outs[0]["metrics"], jmetrics)):
        assert set(m) == set(jm)
        for k, v in m.items():
            assert abs(v - jm[k]) <= METRIC_RTOL * abs(jm[k]), (cid, s, k, v, jm[k])
    assert len(outs[0]["grads"]) == STEPS
    for s, (g, jg) in enumerate(zip(outs[0]["grads"], jgrads)):
        assert_leaves_close(tc, g, jg, GRAD_TOL, f"{cid} step {s} gradient",
                            atol=GRAD_ATOL)
    lr_sum = sum(m["lr"] for m in jmetrics)
    full = outs[0]["full"]
    want = {"params": jstate["params"], "master": jstate["opt"]["master"],
            "m": jstate["opt"]["m"], "v": jstate["opt"]["v"]}
    for part, w in want.items():  # test_torch_sharded_step.tolerances'
        assert_leaves_close(tc, full[part], w, STATE_TOL, f"{cid} {part}",
                            atol=STATE_ATOL[part], zero_grad_atol=(
                                lr_sum if part in ("params", "master") else None))


def check_train_binds(outs, cid, case, axes=AXES):
    """``check_binds`` of every rank's first bind of case ``cid``."""
    mesh, arch, change = case
    jc, tc = configs(arch, change)
    shapes = {n: tuple(t.shape) for n, t in outs[0]["full"]["params"].items()}
    for r, out in enumerate(outs):
        check_binds(out["binds"], jc, tc, mesh, axes, shapes, f"{cid} rank {r}")


@pytest.mark.parametrize("cid", list(CASES))
def test_tp_train_steps_match_jax(ranks, cid):
    check_train(ranks[cid], cid, CASES[cid])


@pytest.mark.parametrize("cid", list(CASES))
def test_tp_train_binds_jax_model_blocks(ranks, cid):
    check_train_binds(ranks[cid], cid, CASES[cid])
