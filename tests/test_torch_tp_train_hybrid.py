"""Tensor-parallel training for the families beside attention + MLP:
jamba at M = 4 and M = 2 (Mamba's packed ``in_proj`` exchanged into the
rank's x and z blocks, the gradient exchanged back; attention and the
MoE beside it), whisper with 6 heads on 4 ranks (its attention runs
whole, the encoder's and decoder's MLPs and the vocabulary split) and
vision (the cross layers). One spawned group of four ranks; what is held,
and against what, is ``test_torch_tp_train.py``'s.
"""

import pytest
import torch

from test_torch_tp_train import HYBRID, check_train, check_train_binds, train_ranks

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return train_ranks(HYBRID, tmp_path_factory.mktemp("tp_train_hybrid"))


@pytest.mark.parametrize("cid", list(HYBRID))
def test_tp_train_steps_match_jax(ranks, cid):
    check_train(ranks[cid], cid, HYBRID[cid])


@pytest.mark.parametrize("cid", list(HYBRID))
def test_tp_train_binds_jax_model_blocks(ranks, cid):
    check_train_binds(ranks[cid], cid, HYBRID[cid])
