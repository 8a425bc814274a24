"""The port's dry-run against the JAX package's for the families beside
the dense and MoE decoders: MLA (deepseek-v2-lite), Mamba (jamba),
xLSTM, whisper (the encoder and ``attn_cross``) and llama-3.2-vision
(``cross`` layers over the media), a train, a prefill and a decode cell
each on (2, 4); and a ``long_500k`` cell of a pure-attention arch, which
both skip with the same reason. What is held is ``test_torch_dryrun.py``'s.
"""

import pytest

from test_torch_dryrun import cells_of, check_cell, records

CELLS = {
    **cells_of(["deepseek-v2-lite-16b", "jamba-v0.1-52b", "xlstm-350m",
                "whisper-large-v3", "llama-3.2-vision-90b"]),
    "qwen3-4b-long_500k-2x4": dict(arch="qwen3-4b", change={},
                                   case=("long_500k", "decode", 524288, 1),
                                   mesh=[2, 4]),
}
SKIPPED = {"qwen3-4b-long_500k-2x4"}


@pytest.fixture(scope="module")
def recs():
    return records(CELLS)


@pytest.mark.parametrize("cid", [c for c in CELLS if c not in SKIPPED])
def test_run_cell_matches_jax(recs, cid):
    jrecs, precs = recs
    check_cell(jrecs[cid], precs[cid])


@pytest.mark.parametrize("cid", sorted(SKIPPED))
def test_skipped_cell_matches_jax(recs, cid):
    jrecs, precs = recs
    assert precs[cid]["status"] == jrecs[cid]["status"] == "skipped"
    assert precs[cid] == jrecs[cid]
    assert "sub-quadratic" in precs[cid]["reason"]
