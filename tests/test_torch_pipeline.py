"""The port's GPipe pipeline (``launch/pipeline.py``) against JAX's
unpipelined stack: the counterpart of ``tests/test_pipeline.py``.

Reduced qwen3-4b at 4 layers (4 groups) on 4 stages (4 gloo ranks on the
CPU), batch 4 x 16, 2 microbatches: every stage's output equals JAX's
``_run_stack`` on the whole batch within 1e-5 (JAX's own test's
tolerance) and the port's plain stack within the same. In place of JAX's
check that its HLO holds a collective-permute chain, the stages' sends
are counted: (M + P - 1) * (P - 1), one a tick from each stage but the
last, as JAX's ppermute does. Also the two conditions JAX's version
raises on.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config as torch_config
from repro_torch.models import transformer as TT
from torch_ranks import run_ranks, save_tree

torch.set_num_threads(1)

CHANGE = dict(num_layers=4, remat=False)  # 4 groups


def test_pipeline_four_stages_matches_jax_and_the_plain_stack(tmp_path):
    jc = dataclasses.replace(jax_config("qwen3-4b").reduced(), **CHANGE)
    tc = dataclasses.replace(torch_config("qwen3-4b").reduced(), **CHANGE)
    params = JT.init_params(jc, jax.random.PRNGKey(0))
    tokens = jax.random.randint(jax.random.PRNGKey(1), (4, 16), 0, jc.vocab_size)
    h = JT._embed(jc, params, tokens)
    want, _, _ = JT._run_stack(jc, params["groups"], h, mode="train")
    tree = jax.tree_util.tree_map(np.asarray, params)
    save_tree(tmp_path / "params.npz", tree)
    h = np.array(h)  # writable
    np.save(tmp_path / "h.npy", h)
    M, P = 2, 4
    outs = run_ranks("pipeline", tmp_path, P, mesh=[P], axes=["stage"],
                     arch="qwen3-4b", change=CHANGE, params="params.npz",
                     h="h.npy", microbatches=M)
    model = convert.params_from_jax(tc, tree, device="cpu")
    with torch.no_grad():
        plain, _ = TT._run_stack(tc, model.groups, torch.from_numpy(h),
                                 mode="train")
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["out"].numpy(), np.asarray(want, np.float32),
                                   atol=1e-5, rtol=1e-5, err_msg=f"stage {r}")
        np.testing.assert_allclose(out["out"].numpy(), plain.numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=f"stage {r}")
    assert sum(o["transfers"] for o in outs) == (M + P - 1) * (P - 1)


@pytest.mark.parametrize("bad", ["batch", "groups"])
def test_pipeline_raises_as_jax(tmp_path, bad):
    """B must divide by the microbatches and G by the stages (2 stages
    here: a 3-group config, or a batch of 3 rows at 2 microbatches)."""
    change = dict(CHANGE, num_layers=3 if bad == "groups" else 4)
    jc = dataclasses.replace(jax_config("qwen3-4b").reduced(), **change)
    params = JT.init_params(jc, jax.random.PRNGKey(0))
    save_tree(tmp_path / "params.npz", jax.tree_util.tree_map(np.asarray, params))
    h = np.zeros((3 if bad == "batch" else 4, 16, jc.d_model), np.float32)
    np.save(tmp_path / "h.npy", h)
    with pytest.raises(AssertionError, match="must divide microbatches"
                       if bad == "batch" else "do not divide over 2 stages"):
        run_ranks("pipeline", tmp_path, 2, mesh=[2], axes=["stage"],
                  arch="qwen3-4b", change=change, params="params.npz",
                  h="h.npy", microbatches=2)
