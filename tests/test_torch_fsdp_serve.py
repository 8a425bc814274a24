"""FSDP in the port's sharded prefill and decode steps, on gloo ranks
against the JAX package's unsharded steps (``test_torch_fsdp_steps.py``
holds the train step; its module docstring says why ``fsdp=True`` and why
JAX's unsharded steps).

The prefill (prompt 11, cache 16) and 4 decode steps, from JAX's
parameters laid out as the dry-run lays them out, each weight split over
the data axes too, on (2, 2): moonshot, jamba and whisper; on (2, 2, 2):
qwen3 with 2 KV heads. Held: the greedy tokens equal JAX's and the
port's unsharded ones exactly, the prefill logits within 1e-5 of both,
the cache after the last step within 1e-5 of the port's; each step binds
every leaf in its tensor-parallel block and gathers some over the data
axes.
"""

import math

import jax
import numpy as np
import pytest
import torch

from test_torch_fsdp_steps import AXES, MOE, QWEN3, SPLIT, check_fsdp_binds
from test_torch_tp_serve import case_inputs, freeze
from test_torch_tp_serve import jax_run as jax_serve
from test_torch_tp_serve import port_run as port_serve
from torch_ranks import run_ranks, save_tree

torch.set_num_threads(1)

SERVE = {  # id -> (mesh, arch, config change, batch)
    "2x2-moonshot": ((2, 2), MOE, {}, 4),
    "2x2-jamba": ((2, 2), "jamba-v0.1-52b", {}, 4),
    "2x2-whisper": ((2, 2), "whisper-large-v3", {}, 4),
}
SERVE_SPLIT = {"2x2x2-qwen3-gqa": ((2, 2, 2), QWEN3, {"num_kv_heads": 2}, 4)}
ALL_SERVE = {**SERVE, **SERVE_SPLIT}


def serve_ranks(cases: dict, root, axes) -> dict:
    """The ranks' outputs of ``cases`` (one mesh size), FSDP on
    (``test_torch_tp_serve.ranks_outputs``' inputs)."""
    specs = []
    for cid, case in cases.items():
        mesh, arch, change, b = freeze(case)
        _, _, params, toks, media = case_inputs(arch, change, b)
        save_tree(root / f"{cid}.npz", jax.tree_util.tree_map(np.asarray, params))
        np.save(root / f"{cid}-tokens.npy", toks)
        spec = dict(arch=arch, change=dict(change), params=f"{cid}.npz",
                    tokens=f"{cid}-tokens.npy", gen=5, mesh=list(mesh),
                    axes=list(axes))
        if media is not None:
            np.save(root / f"{cid}-media.npy", media)
            spec["media"] = f"{cid}-media.npy"
        specs.append(spec)
    world = math.prod(next(iter(cases.values()))[0])
    outs = run_ranks("serve_steps", root, world, timeout=400,
                     mesh=[1] * (len(axes) - 1) + [world], axes=list(axes),
                     cases=specs, record=True, fsdp=True)
    return {cid: [r[i] for r in outs] for i, cid in enumerate(cases)}


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    out = serve_ranks(SERVE, tmp_path_factory.mktemp("fsdp_serve"), AXES)
    out.update(serve_ranks(SERVE_SPLIT, tmp_path_factory.mktemp("fsdp_serve_split"),
                           SPLIT))
    return out


@pytest.mark.parametrize("cid", list(ALL_SERVE))
def test_fsdp_serving_steps_match_jax(served, cid):
    mesh, arch, change, b = freeze(ALL_SERVE[cid])
    jlogits, jtokens = jax_serve(arch, change, b)
    plogits, ptokens, pcache = port_serve(arch, change, b)
    for r, out in enumerate(served[cid]):
        what = f"{cid} rank {r}"
        np.testing.assert_array_equal(out["tokens"].numpy(), jtokens, err_msg=what)
        assert torch.equal(out["tokens"], ptokens), what
        for want in (jlogits, plogits.numpy()):
            np.testing.assert_allclose(out["logits"].numpy(), want, rtol=1e-5,
                                       atol=1e-5, err_msg=what)
        assert out["in_place"], what
        for j, slot in out["cache"].items():
            for k, full in slot.items():
                np.testing.assert_allclose(full.numpy(), pcache[j][k].numpy(),
                                           rtol=1e-5, atol=1e-5,
                                           err_msg=f"{what} cache {j}.{k}")
        assert len(out["binds"]) == 2, what  # the prefill's, a decode's
        check_fsdp_binds(out["binds"], None, ALL_SERVE[cid],
                         SPLIT if len(mesh) == 3 else AXES, what)
