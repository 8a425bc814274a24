"""``loss_fn`` and its gradients against ``jax.value_and_grad(loss_fn)``:
the attention + MLP configs (qwen3-4b: qk-norm; granite-34b: MQA;
chatglm3-6b: 2d rope, biases, GQA; command-r-plus-104b: LayerNorm).

JAX's parameters carried across (``convert.params_from_jax``), the same
numpy batch (labels include one below 0 and one in the vocab padding,
both masked), f32 reduced configs, with remat off and on (both policies,
``full`` and ``dots``), JAX with the same remat. The loss and its parts
within 1e-5; every gradient leaf within 1e-4 of its largest |JAX
gradient|, plus 1e-7 (``test_torch_train_step.check_grads``).
"""

import pytest

from test_torch_train_step import REMATS, check_grads


@pytest.mark.parametrize("remat,policy", REMATS)
@pytest.mark.parametrize("arch", ["qwen3-4b", "granite-34b", "chatglm3-6b",
                                  "command-r-plus-104b"])
def test_loss_and_grads_match_jax(arch, remat, policy):
    check_grads(arch, remat, policy)
