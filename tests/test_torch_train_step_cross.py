"""The port's training step against the JAX package's on
the encoder-decoder family, whisper-large-v3 (the encoder and ``attn_cross``; the batch's frames are its media). As ``test_torch_train_step.py``, whose helpers and
tolerances these are: three steps plain, with ``microbatch=2`` and with
``compress_grads=True``.
"""

import pytest

from test_torch_train_step import MODES, run_steps


@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_matches_jax(mode):
    run_steps("whisper-large-v3", mode)
