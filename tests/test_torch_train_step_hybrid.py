"""The port's training step against the JAX package's on
the hybrid family, jamba-v0.1-52b (Mamba, attention, MLP and MoE; a pattern of 8 slots). As ``test_torch_train_step.py``, whose helpers and
tolerances these are: three steps plain, with ``microbatch=2`` and with
``compress_grads=True``.
"""

import pytest

from test_torch_train_step import MODES, run_steps


@pytest.mark.parametrize("mode", list(MODES))
def test_train_step_matches_jax(mode):
    run_steps("jamba-v0.1-52b", mode)
