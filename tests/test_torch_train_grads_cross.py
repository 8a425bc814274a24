"""``loss_fn`` and its gradients against ``jax.value_and_grad(loss_fn)``:
the encoder-decoder and cross-attention families (whisper-large-v3: the
encoder, sinusoidal positions and ``attn_cross``, the frames [B, S, D]
its media; llama-3.2-vision-90b: ``cross`` layers over the media [B,
num_media_tokens, D]). The gradients reach the encoder's and the cross
layers' parameters through the memory. Method and tolerances as
``test_torch_train_grads_dense.py``.
"""

import pytest

from test_torch_train_step import REMATS, check_grads


@pytest.mark.parametrize("remat,policy", REMATS)
@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-90b"])
def test_loss_and_grads_match_jax(arch, remat, policy):
    check_grads(arch, remat, policy)
