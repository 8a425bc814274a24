"""``loss_fn`` and its gradients against ``jax.value_and_grad(loss_fn)``:
the MoE configs (moonshot-v1-16b-a3b: attention + MoE; deepseek-v2-lite-16b:
MLA + MoE with shared experts), the load-balance and router-z losses in
the total. Method and tolerances as ``test_torch_train_grads_dense.py``.

With remat the MoE's forward runs again in the backward: the batched
ranks are called once per MoE layer in the forward and once more in each
recomputation (nested for a pattern of more than one slot), as
``transformer.moe_forwards`` counts.
"""

import pytest
import torch

from repro_torch import convert
from repro_torch.kernels import ops
from repro_torch.models import transformer as TT
from test_torch_train_step import (REMATS, check_grads, configs, jax_batch,
                                   jax_params, to_torch)


@pytest.mark.parametrize("remat,policy", REMATS)
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "deepseek-v2-lite-16b"])
def test_loss_and_grads_match_jax(arch, remat, policy):
    check_grads(arch, remat, policy)


@pytest.mark.parametrize("remat,policy", REMATS)
@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "jamba-v0.1-52b"])
def test_batched_ranks_calls_per_backward(monkeypatch, arch, remat, policy):
    """The MoE's ``ops.batched_ranks`` calls in one loss and gradient:
    moonshot (one slot a group) 1 a layer without remat and 2 with it;
    jamba (8 slots: each block checkpointed inside its checkpointed
    group) 1 and 3, less one a group for its last slot's MoE."""
    _, tc = configs(arch, remat=remat, remat_policy=policy)
    calls, inner = [], ops.batched_ranks

    def counting(flags):
        calls.append(flags.shape)
        return inner(flags)

    monkeypatch.setattr(ops, "batched_ranks", counting)
    model = convert.params_from_jax(tc, jax_params(arch), device="cpu",
                                    requires_grad=True)
    loss, _ = TT.loss_fn(tc, model, to_torch(jax_batch(tc, 0, B=2, S=8)))
    layers = tc.num_groups * sum(s.ffn == "moe" for s in tc.pattern)
    assert len(calls) == layers
    torch.autograd.grad(loss, list(model.parameters()))
    assert len(calls) == TT.moe_forwards(tc)
    assert len(calls) == {(False, 1): layers, (True, 1): 2 * layers,
                          (False, 8): layers, (True, 8): 3 * layers - 2}[
        (remat, len(tc.pattern))]
