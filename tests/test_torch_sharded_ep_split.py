"""EP over the split model axes: the port's sharded train step for
reduced moonshot-v1-16b-a3b on a (2, 2, 2) mesh (``data``, ``model_a``,
``model_b``) over eight CPU ranks (gloo), ``ep_axis=("model_a",
"model_b")`` as the dry-run sets it on the split mesh.

Each rank's compute model is given its E / 4 experts (the experts split
over both model axes, major to minor), and after three steps the
gathered state equals JAX's unsharded state within
``test_torch_train_step.py``'s tolerances (R1: JAX's sharded steps fail),
and each rank's block of every leaf is JAX's shard at its coordinates.
"""

import functools

import jax
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding

from repro.launch import sharding as jsh
from repro.models import transformer as JT
from test_torch_sharded_step import (B, MOE, S, STEPS, _block, configs, jax_run,
                                     jax_tree, tolerances)
from test_torch_sharding_specs import jax_leaf, path_name
from test_torch_train_step import STATE_TOL, assert_leaves_close
from torch_ranks import run_ranks, save_tree

torch.set_num_threads(1)

MESH, AXES = (2, 2, 2), ("data", "model_a", "model_b")
CID = "2x2-moe-plain"  # test_torch_sharded_step's case: the same JAX run


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("ep_split")
    save_tree(root / "params.npz", jax_tree(CID))
    outs = run_ranks("train", root, 8, mesh=list(MESH), axes=list(AXES),
                     batch=[B, S], steps=STEPS,
                     cases=[dict(arch=MOE, change={}, opts={}, params="params.npz")])
    return [r[0] for r in outs]


def test_each_rank_is_given_a_quarter_of_the_experts(ranks):
    _, tc = configs(MOE, {})
    E = tc.moe.num_experts
    for r, out in enumerate(ranks):
        assert out["bound_experts"], r
        for n, shape in out["bound_experts"].items():
            assert shape[0] == E // 4, (r, n, shape)


def test_split_mesh_state_matches_jax_unsharded(ranks):
    _, tc = configs(MOE, {})
    jstate, jmetrics = jax_run(CID)
    lr_sum = sum(m["lr"] for m in jmetrics)
    full = ranks[0]["full"]
    want = {"params": jstate["params"], "master": jstate["opt"]["master"],
            "m": jstate["opt"]["m"], "v": jstate["opt"]["v"]}
    for part, w in want.items():
        assert_leaves_close(tc, full[part], w, STATE_TOL, f"ep-split {part}",
                            **tolerances(CID, part, lr_sum))


def test_split_mesh_blocks_are_jax_shards(ranks):
    jc, tc = configs(MOE, {})
    sizes = dict(zip(AXES, MESH))
    jm = JaxAbstractMesh(MESH, AXES)
    jpol = jsh.ShardingPolicy.for_arch(jc, jm)
    assert jpol.model == ("model_a", "model_b")
    jtree = jax.eval_shape(functools.partial(JT.init_params, jc), jax.random.PRNGKey(0))
    jspecs = {path_name(p): (jsh.param_spec(jc, jm, jpol, p, leaf), leaf.shape)
              for p, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    full = ranks[0]["full"]["params"]
    for out in ranks:
        coord = dict(zip(AXES, out["coord"]))
        for name, spec in out["specs"].items():
            leaf, stacked = jax_leaf(tc, name)
            jspec, jshape = jspecs[leaf]
            shard = JaxNamedSharding(jm, jspec).shard_shape(jshape)
            want_spec = tuple(jspec)[1:] if stacked else tuple(jspec)
            assert tuple(spec) == want_spec, name
            got = out["blocks"]["params"][name]
            assert tuple(got.shape) == (shard[1:] if stacked else shard), name
            assert torch.equal(got, _block(full[name], want_spec, coord, sizes)), (
                name, coord)
