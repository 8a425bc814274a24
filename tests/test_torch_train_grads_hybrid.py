"""``loss_fn`` and its gradients against ``jax.value_and_grad(loss_fn)``:
the recurrent families (jamba-v0.1-52b: Mamba's selective scan, attention,
MLP and MoE, a pattern of 8 slots, so remat nests; xlstm-350m: the mLSTM's
parallel form and the sLSTM's loop over time, tied embeddings). Autograd
runs through the port's Python time loops. Method and tolerances as
``test_torch_train_grads_dense.py``.
"""

import pytest

from test_torch_train_step import REMATS, check_grads


@pytest.mark.parametrize("remat,policy", REMATS)
@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-350m"])
def test_loss_and_grads_match_jax(arch, remat, policy):
    check_grads(arch, remat, policy)
