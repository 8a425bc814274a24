"""The port's sharded prefill and serve steps on four CPU ranks (gloo), a
(2, 2) mesh, for the families beside attention: MLA (deepseek-v2-lite:
``c_kv`` and ``k_rope`` on the sequence, the MoE under EP), Mamba
(jamba: ``conv`` and ``ssm`` on the model axis), xLSTM (``C``, ``n``,
``c`` on the model axis) and whisper (the encoder's memory on the data
axis, the ``attn_cross`` cache). What is held, and against what, is
``test_torch_sharded_serve_steps.py``'s.
"""

import pytest
import torch

from test_torch_sharded_serve_steps import check_case, sharded_outputs

torch.set_num_threads(1)

CASES = {  # id -> (arch, config change, batch)
    "deepseek": ("deepseek-v2-lite-16b", {}, 4),
    "jamba": ("jamba-v0.1-52b", {}, 4),
    "xlstm": ("xlstm-350m", {}, 4),
    "whisper": ("whisper-large-v3", {}, 4),
}


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return sharded_outputs(CASES, tmp_path_factory.mktemp("serve_steps_hybrid"))


@pytest.mark.parametrize("cid", list(CASES))
def test_sharded_serve_steps_match_unsharded(sharded, cid):
    check_case(sharded[cid], cid, CASES)
