"""Tensor-parallel xLSTM: the port's sharded train, prefill and decode steps
with mLSTM and sLSTM split over the model axis, on four CPU ranks (gloo),
against the JAX package's unsharded steps (and the port's, for serving).

Cases, reduced xlstm (d_model 64, mLSTM's inner dim 128): 4 heads on
(1, 4) and on (2, 2), where the heads divide the model axis (mLSTM's
``wq``/``wk``/``wv``/``wo_gate`` column blocks, one head a rank on (1,
4)), and 2 heads on (1, 4), where they do not (their row blocks, the sums
whole: the contraction-dim case of xlstm-350m on the (16, 16) mesh).
Everywhere ``up`` is column-parallel (mLSTM's packed x|z exchanged),
``down`` row-parallel, sLSTM runs its block of units (its ``wo`` a row
block with 4 heads, a column block with 2), and the cache's ``C``/``n``
(split on the head dim) and ``c`` (on the units) are read and written in
place.

Held as ``test_torch_tp_train.py`` holds training (every metric, every
gradient leaf, the state after two steps, each leaf JAX's ``param_spec``
splits over the model axis bound as that block with no all-gather) and as
``test_torch_tp_serve.py`` holds serving (prefill and 4 decode steps:
greedy tokens exact, prefill logits within 1e-5, the gathered cache
within 1e-5, each rank's block JAX's shard and the prefill's storage, no
decode step gathering the split ``C``, ``n`` or ``c``).
"""

import pytest
import torch

from test_torch_tp_serve import check_serving, ranks_outputs
from test_torch_tp_train import AXES, check_train, check_train_binds, train_ranks

torch.set_num_threads(1)

XLSTM = "xlstm-350m"
H2 = {"num_heads": 2, "num_kv_heads": 2}
TRAIN = {  # id -> (mesh, arch, config change)
    "1x4-xlstm": ((1, 4), XLSTM, {}),
    "1x4-xlstm-h2": ((1, 4), XLSTM, H2),
    "2x2-xlstm": ((2, 2), XLSTM, {}),
}
SERVE = {cid: (*case, 4) for cid, case in TRAIN.items()}  # batch 4


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    return train_ranks(TRAIN, tmp_path_factory.mktemp("tp_xlstm_train"))


@pytest.mark.parametrize("cid", list(TRAIN))
def test_tp_xlstm_train_matches_jax(trained, cid):
    check_train(trained[cid], cid, TRAIN[cid])


@pytest.mark.parametrize("cid", list(TRAIN))
def test_tp_xlstm_binds_jax_model_blocks(trained, cid):
    check_train_binds(trained[cid], cid, TRAIN[cid])


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    return ranks_outputs(SERVE, tmp_path_factory.mktemp("tp_xlstm_serve"), 4, AXES)


@pytest.mark.parametrize("cid", list(SERVE))
def test_tp_xlstm_serving_matches_unsharded(served, cid):
    seq_split, cut = check_serving(served[cid], SERVE[cid], AXES, cid)
    assert seq_split == 0 and cut == 3  # mLSTM's C and n, sLSTM's c
