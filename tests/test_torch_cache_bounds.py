"""A cache write past the cache's length raises in the port's attention and
MLA, unsharded and with the cache's sequence dim split over the model axis
(split-KV decode): no position is dropped.

Unsharded: reduced qwen3 (attention) and deepseek (MLA), prefill of 6
tokens into a cache of 6, then a decode at pos 6 (the cache's length); a
prefill of 6 tokens into a cache of 4. Split: the first slot's mixer of
the same configs, its weights whole, on rank 0 of the fake process group
of 4 ranks on a (1, 4) mesh, its cache a block of 4 of 16 positions: a
decode at pos 16 raises, and ``seq_rows`` gives rank 0 a position of its
own block, none of another rank's, and raises past 16.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.launch import collectives as cc
from repro_torch.launch.dryrun import init_fake_group
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import greedy, make_prefill_step, make_serve_step
from repro_torch.models import transformer as TT
from repro_torch.models.attention import seq_rows
from repro_torch.models.common import CacheSlot

ARCHS = ("qwen3-4b", "deepseek-v2-lite-16b")
B, P = 2, 6


def model_and_tokens(arch):
    cfg = get_config(arch).reduced()
    model = TT.init_params(cfg, device="cpu")
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, P))
    return cfg, model, torch.from_numpy(toks).long()


@pytest.mark.parametrize("arch", ARCHS)
def test_unsharded_decode_at_the_cache_length_raises(arch):
    cfg, model, toks = model_and_tokens(arch)
    with torch.no_grad():
        logits, cache = make_prefill_step(cfg, cache_len=P)(model, {"tokens": toks})
        tok = greedy(cfg, logits)
        with pytest.raises(IndexError, match="past its length 6"):
            make_serve_step(cfg)(model, cache, {"tokens": tok, "pos": P})


@pytest.mark.parametrize("arch", ARCHS)
def test_unsharded_prefill_longer_than_the_cache_raises(arch):
    cfg, model, toks = model_and_tokens(arch)
    with torch.no_grad(), pytest.raises(IndexError, match=r"\[0, 6\) past its length 4"):
        make_prefill_step(cfg, cache_len=4)(model, {"tokens": toks})


@pytest.mark.parametrize("arch", ARCHS)
def test_split_kv_decode_at_the_cache_length_raises(arch):
    cfg, model, _ = model_and_tokens(arch)
    spec = cfg.pattern[0]
    whole = TT.init_cache(cfg, B, 16, device="cpu")["0"]
    init_fake_group(4)
    try:
        tp = cc.Split(make_mesh((1, 4), ("data", "model"), device="cpu"), ("model",))
        cache = CacheSlot({k: v[0, :, :4].clone() for k, v in whole.items()})
        cache.seq = ("model",)
        assert seq_rows(cache, 2, 1, tp) == (slice(0, 1), slice(2, 3))
        assert seq_rows(cache, 9, 1, tp) is None  # rank 2's block
        with pytest.raises(IndexError, match=r"\[16, 17\) past its length 16"):
            seq_rows(cache, 16, 1, tp)
        x = torch.zeros(B, 1, cfg.d_model)
        with torch.no_grad(), pytest.raises(IndexError, match="past its length 16"):
            TT._apply_mixer(cfg, spec, model.groups[0]["0"], x, memory=None,
                            mode="decode", cache=cache, pos=16, tp=tp)
    finally:
        dist.destroy_process_group()
