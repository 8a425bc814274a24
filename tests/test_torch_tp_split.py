"""Tensor-parallel steps on the split model mesh (``data``, ``model_a``,
``model_b``) = (2, 2, 2), eight CPU ranks (gloo), and ``greedy`` over
vocab blocks, against the JAX package.

Whisper with 6 heads: JAX's ``heads_split`` cuts its heads over
``model_a`` only and leaves ``model_b`` on the projections' contraction
dim; the port binds that leftover axis whole and computes its 3 heads a
``model_a`` rank, its KV heads over the same axis (gathered into the
sequence-split cache before they are written), while the MLP and the
vocabulary split over both axes; decode splits the keys over both axes
(split-KV) and each rank keeps its ``model_a`` heads' output. qwen3
splits its 4 heads over both axes, and with 2 KV heads (JAX: over
``model_a`` only) binds its KV projections whole, its cache split on the
sequence over both. jamba's ``in_proj`` is exchanged over both axes (one
all-to-all over the flattened pair). Train cases are held as
``test_torch_tp_train.py`` holds them (metrics, every gradient leaf, the
state, the bound blocks), serving cases as ``test_torch_tp_serve.py``
does.

``greedy`` on vocab blocks (4 ranks, the vocabulary over ``model_a`` x
``model_b``): crafted rows with ties inside a block, across blocks and
across the padding, each equal to ``jnp.argmax`` of the masked logits
(the first maximum: a tie across blocks goes to the lower one).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tp_serve import check_serving, ranks_outputs
from test_torch_tp_train import check_train, check_train_binds, train_ranks
from torch_ranks import run_ranks

torch.set_num_threads(1)

MESH = (2, 2, 2)
AXES = ("data", "model_a", "model_b")
WHISPER6 = {"num_heads": 6, "num_kv_heads": 6}
TRAIN = {  # id -> (mesh, arch, config change)
    "whisper-h6": (MESH, "whisper-large-v3", WHISPER6),
    "qwen3": (MESH, "qwen3-4b", {}),
}
SERVE = {  # id -> (mesh, arch, config change, batch)
    "whisper-h6": (MESH, "whisper-large-v3", WHISPER6, 4),
    "qwen3-gqa": (MESH, "qwen3-4b", {"num_kv_heads": 2}, 4),
    "jamba": (MESH, "jamba-v0.1-52b", {}, 4),
}
SEQ_SPLIT = ("whisper-h6", "qwen3-gqa")  # self-attention caches split on the
# sequence over (model_a, model_b): split-KV decode


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return train_ranks(TRAIN, tmp_path_factory.mktemp("tp_split_train"), AXES)


@pytest.mark.parametrize("cid", list(TRAIN))
def test_split_mesh_train_matches_jax(trained, cid):
    check_train(trained[cid], cid, TRAIN[cid])
    check_train_binds(trained[cid], cid, TRAIN[cid], AXES)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return ranks_outputs(SERVE, tmp_path_factory.mktemp("tp_split_serve"), 8, AXES)


@pytest.mark.parametrize("cid", list(SERVE))
def test_split_mesh_serving_matches_unsharded(served, cid):
    seq_split, _ = check_serving(served[cid], SERVE[cid], AXES, cid)
    assert bool(seq_split) == (cid in SEQ_SPLIT)


VOCAB, PADDED = 60, 64  # four blocks of 16; 60..63 the padding


def tie_rows() -> np.ndarray:
    """Rows of logits [8, 64] with the maxima the docstring names."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(8, PADDED)).astype(np.float32)
    x[0, [20, 50]] = 9.0  # tie across blocks 1 and 3
    x[1, [15, 16]] = 9.0  # tie across the boundary of blocks 0 and 1
    x[2, [33, 35, 40]] = 9.0  # tie inside block 2 and across none
    x[3, [5, 61]] = [8.0, 9.0]  # the largest value in the padding
    x[4] = 1.0  # every logit equal
    x[5, [47, 48, 63]] = [9.0, 9.0, 10.0]  # tie across blocks 2, 3; padding above
    x[6, :] = -1e30
    x[6, 59] = 0.0  # the last real token
    x[7, [0, 32]] = 9.0  # tie between the first and the third block
    return x


@pytest.fixture(scope="module")
def greedy_tokens(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_greedy")
    np.save(root / "logits.npy", tie_rows())
    outs = run_ranks("greedy", root, 4, timeout=120, mesh=[1, 2, 2], axes=list(AXES),
                     logits="logits.npy", vocab_size=VOCAB,
                     over=["model_a", "model_b"])
    return [o["tokens"] for o in outs]


def test_greedy_over_vocab_blocks_is_jnp_argmax(greedy_tokens):
    x = jnp.asarray(tie_rows())
    want = np.asarray(jnp.argmax(x.at[..., VOCAB:].set(-jnp.inf), axis=-1))
    assert list(want[:3]) == [20, 15, 33]  # the rows do what they say
    for r, got in enumerate(greedy_tokens):
        assert got.dtype == torch.int32 and tuple(got.shape) == (8, 1), r
        np.testing.assert_array_equal(got[:, 0].numpy(), want, err_msg=f"rank {r}")
