"""The port's sharded train step on several CPU ranks (gloo), against the
JAX package's unsharded steps and the port's.

R1: JAX's own sharded steps fail on jax 0.9.0, so the port's sharded
runs are held against JAX's unsharded ones
(a sharded step computes the global step: the results are the same up to
the order of the sums the reduction splits).

Train: reduced qwen3-4b (dense) and moonshot-v1-16b-a3b (MoE, experts on
the model axis), three steps from JAX's parameters on the synthetic
batches (4 x 16), the config as the train CLI sets it on a mesh
(``act_sharding=("data",)``, ``ep_axis="model"``). On a (2, 2) mesh:
plain, microbatch 2, compressed, moonshot with 16-token groups (the
whole-groups path: 4 groups, 2 a data rank; at the default group size
the 64 tokens are one group that spans both data ranks, and the ranks
gather the tokens), and labels masked unevenly over the rows (qwen3;
moonshot at microbatch 2), where a mean of per-rank means would miss
the global mean. On a (4, 1) mesh: plain, and microbatch 2 (2 rows a
microbatch over 4 data ranks: every rank computes every row). After
three steps the gathered state (params, master, m, v, residual) equals
JAX's unsharded state within ``test_torch_train_step.py``'s tolerances,
and the port's unsharded state within the same; every metric of every
step within METRIC_RTOL of JAX's; each rank's block of every leaf has
JAX's shard shape at its mesh coordinates (JAX's spec on an
AbstractMesh) and holds that shard of the gathered leaf.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding

from repro.launch import sharding as jsh
from repro.launch import steps as jax_steps
from repro.models import transformer as JT
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.grad_compress import init_residual as jax_init_residual
from repro_torch import convert
from repro_torch.launch.steps import StepOptions, make_train_step
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.grad_compress import init_residual
from test_torch_sharding_specs import jax_leaf, path_name
from test_torch_train_step import (METRIC_RTOL, ROUNDED_OTHER_WAY, RESIDUAL_SCALE,
                                   STATE_ATOL, STATE_TOL, assert_leaves_close,
                                   jax_batch, one_device_mesh, to_torch)
from torch_ranks import mask_labels, run_ranks, save_tree

torch.set_num_threads(1)

B, S, STEPS = 4, 16, 3
MOE = "moonshot-v1-16b-a3b"
CASES = {  # id -> (mesh, arch, opts, config change)
    "2x2-qwen3-plain": ((2, 2), "qwen3-4b", {}, {}),
    "2x2-qwen3-microbatch2": ((2, 2), "qwen3-4b", dict(microbatch=2), {}),
    "2x2-qwen3-compress": ((2, 2), "qwen3-4b", dict(compress_grads=True), {}),
    "2x2-moe-plain": ((2, 2), MOE, {}, {}),
    "2x2-moe-microbatch2": ((2, 2), MOE, dict(microbatch=2), {}),
    "2x2-moe-compress": ((2, 2), MOE, dict(compress_grads=True), {}),
    "2x2-moe-groups16": ((2, 2), MOE, {}, {"moe": {"group_size": 16}}),
    "2x2-qwen3-masked": ((2, 2), "qwen3-4b", {}, {}),
    "2x2-moe-masked-microbatch2": ((2, 2), MOE, dict(microbatch=2), {}),
    "4x1-qwen3-plain": ((4, 1), "qwen3-4b", {}, {}),
    "4x1-moe-plain": ((4, 1), MOE, {}, {}),
    "4x1-moe-microbatch2": ((4, 1), MOE, dict(microbatch=2), {}),
}


MASKED = {"2x2-qwen3-masked", "2x2-moe-masked-microbatch2"}  # labels masked
# unevenly over the rows (``torch_ranks.mask_labels``): a mean of per-rank
# means would differ from the global mean


def batch_of(cid, cfg, step):
    """Case ``cid``'s batch at ``step`` (numpy), JAX's synthetic bytes."""
    batch = jax_batch(cfg, step, B=B, S=S)
    return mask_labels(batch, cfg.vocab_size) if cid in MASKED else batch


def configs(arch, change):
    """(JAX config, port config), reduced, with ``change`` applied."""
    from repro.configs import get_config as jax_config
    from repro_torch.configs import get_config as torch_config
    out = []
    for cfg in (jax_config(arch).reduced(), torch_config(arch).reduced()):
        c = dict(change)
        if "moe" in c:
            c["moe"] = dataclasses.replace(cfg.moe, **c["moe"])
        out.append(dataclasses.replace(cfg, **c))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def jax_tree(cid):
    """JAX's parameters of case ``cid``'s config (seed 0), as numpy."""
    _, arch, _, change = CASES[cid]
    jc, _ = configs(arch, change)
    params = jax.jit(functools.partial(JT.init_params, jc))(jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """Every case's ranks' outputs: one run of the ranks a mesh, its cases
    one after another."""
    out = {}
    root = tmp_path_factory.mktemp("sharded")
    for mesh in sorted({c[0] for c in CASES.values()}):
        cids = [cid for cid, c in CASES.items() if c[0] == mesh]
        cases = []
        for cid in cids:
            _, arch, opts, change = CASES[cid]
            save_tree(root / f"{cid}.npz", jax_tree(cid))
            cases.append(dict(arch=arch, change=change, opts=opts,
                              params=f"{cid}.npz", mask=cid in MASKED))
        ranks = run_ranks("train", root, mesh[0] * mesh[1], mesh=list(mesh),
                          axes=["data", "model"], batch=[B, S], steps=STEPS,
                          cases=cases)
        for i, cid in enumerate(cids):
            out[cid] = [r[i] for r in ranks]
    return out


def jax_run(cid):
    """JAX's unsharded steps: (final state as numpy, metrics a step); the
    cases that differ only in their mesh share one run."""
    first = next(c for c, v in CASES.items()
                 if v[1:] == CASES[cid][1:] and (c in MASKED) == (cid in MASKED))
    return _jax_run(first)


@functools.lru_cache(maxsize=None)
def _jax_run(cid):
    _, arch, opts, change = CASES[cid]
    jc, _ = configs(arch, change)
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_tree(cid))
    jstate = {"params": jparams, "opt": jax_adamw_init(jparams)}
    if opts.get("compress_grads"):
        jstate["residual"] = jax_init_residual(jparams)
    jstep = jax.jit(jax_steps.make_train_step(
        jc, jax_steps.StepOptions(opt=JaxAdamW(), **opts)))
    metrics = []
    for s in range(STEPS):
        batch = batch_of(cid, jc, s)
        with one_device_mesh():
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        metrics.append({k: float(v) for k, v in jm.items()})
    return jax.tree_util.tree_map(np.asarray, jstate), metrics


@functools.lru_cache(maxsize=None)
def port_run(cid):
    """The port's unsharded steps from the same parameters."""
    _, arch, opts, change = CASES[cid]
    jc, tc = configs(arch, change)
    model = convert.params_from_jax(tc, jax_tree(cid),
                                    device="cpu", requires_grad=True)
    state = {"params": model, "opt": adamw_init(model)}
    if opts.get("compress_grads"):
        state["residual"] = init_residual(model)
    step = make_train_step(tc, StepOptions(**opts))
    for s in range(STEPS):
        state, _ = step(state, to_torch(batch_of(cid, jc, s)))
    return state


def parts(state):
    """{part: {name: tensor}} of a port train state."""
    out = {"params": {n: p.detach() for n, p in state["params"].named_parameters()},
           "master": state["opt"]["master"], "m": state["opt"]["m"],
           "v": state["opt"]["v"]}
    if "residual" in state:
        out["residual"] = state["residual"]
    return out


def tolerances(cid, part, lr_sum):
    compressed = bool(CASES[cid][2].get("compress_grads"))
    return dict(atol=STATE_ATOL[part],
                allowed=ROUNDED_OTHER_WAY if compressed else 0.0,
                scale=RESIDUAL_SCALE if compressed and part == "residual" else 1.0,
                zero_grad_atol=lr_sum if part in ("params", "master") else None)


@pytest.mark.parametrize("cid", list(CASES))
def test_sharded_steps_match_jax_unsharded(sharded, cid):
    outs = sharded[cid]
    _, arch, opts, change = CASES[cid]
    _, tc = configs(arch, change)
    jstate, jmetrics = jax_run(cid)
    for r, out in enumerate(outs):  # every rank reports the same metrics
        assert out["step"] == STEPS
        assert out["metrics"] == outs[0]["metrics"], r
    for s, (m, jm) in enumerate(zip(outs[0]["metrics"], jmetrics)):
        assert set(m) == set(jm)
        for k, v in m.items():
            assert abs(v - jm[k]) <= METRIC_RTOL * abs(jm[k]), (s, k, v, jm[k])
    lr_sum = sum(m["lr"] for m in jmetrics)
    full = outs[0]["full"]
    want = {"params": jstate["params"], "master": jstate["opt"]["master"],
            "m": jstate["opt"]["m"], "v": jstate["opt"]["v"]}
    if "residual" in jstate:
        want["residual"] = jstate["residual"]
    for part, w in want.items():
        assert_leaves_close(tc, full[part], w, STATE_TOL, f"{cid} {part}",
                            **tolerances(cid, part, lr_sum))
    if "residual" not in jstate:
        assert full["residual"] == {}


@pytest.mark.parametrize("cid", list(CASES))
def test_sharded_steps_match_port_unsharded(sharded, cid):
    full = sharded[cid][0]["full"]
    lr_sum = sum(m["lr"] for m in sharded[cid][0]["metrics"])
    for part, want in parts(port_run(cid)).items():
        worst, allowed = 0, tolerances(cid, part, lr_sum)
        outside = total = 0
        for n, w in want.items():
            g, w = full[part][n].to(torch.float32), w.detach().to(torch.float32)
            floor = allowed["atol"]
            if allowed["zero_grad_atol"] is not None and n.endswith(".wk.b"):
                floor = allowed["zero_grad_atol"]
            lim = STATE_TOL * allowed["scale"] * float(w.abs().max()) + floor
            outside += int(((g - w).abs() > lim).sum())
            total += w.numel()
            worst = max(worst, float((g - w).abs().max()))
        assert outside <= allowed["allowed"] * total, (cid, part, outside, worst)


def _block(full: torch.Tensor, spec, coord: dict, sizes: dict) -> torch.Tensor:
    """The block of ``full`` that JAX places at mesh coordinates
    ``coord`` under ``spec``: along a dim of entry (a, b, ...), block
    index c_a * |b| + c_b ..., major to minor in the entry's order."""
    out = full
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx, k = 0, 1
        for a in axes:
            idx, k = idx * sizes[a] + coord[a], k * sizes[a]
        n = out.shape[dim] // k
        out = out.narrow(dim, idx * n, n)
    return out


@pytest.mark.parametrize("cid", list(CASES))
def test_rank_blocks_are_jax_shards(sharded, cid):
    """Each rank's block of every leaf: JAX's shard shape of the leaf's
    spec at the rank's mesh coordinates (JAX's param_spec on an
    AbstractMesh, the stacked dim dropped), and that block's values."""
    mesh, arch, _, change = CASES[cid]
    jc, tc = configs(arch, change)
    axes = ("data", "model")
    sizes = dict(zip(axes, mesh))
    jm = JaxAbstractMesh(mesh, axes)
    jpol = jsh.ShardingPolicy.for_arch(jc, jm)
    jtree = jax.eval_shape(functools.partial(JT.init_params, jc), jax.random.PRNGKey(0))
    jspecs = {path_name(p): (jsh.param_spec(jc, jm, jpol, p, leaf), leaf.shape)
              for p, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    full = sharded[cid][0]["full"]
    for out in sharded[cid]:
        coord = dict(zip(axes, out["coord"]))
        for name, spec in out["specs"].items():
            leaf, stacked = jax_leaf(tc, name)
            jspec, jshape = jspecs[leaf]
            shard = JaxNamedSharding(jm, jspec).shard_shape(jshape)
            want_spec = tuple(jspec)[1:] if stacked else tuple(jspec)
            assert tuple(spec) == want_spec, name
            for part, blocks in out["blocks"].items():
                if not blocks:
                    continue
                got = blocks[name]
                assert tuple(got.shape) == (shard[1:] if stacked else shard), (part, name)
                assert torch.equal(got, _block(full[part][name], want_spec, coord,
                                               sizes)), (part, name, coord)
