"""The port's language-model substrate against the JAX package.

Same parameters (``repro.models.transformer.init_params`` carried across
by ``repro_torch.convert.params_from_jax``), same numpy token ids, f32
reduced configs: moonshot-v1-16b-a3b (attention + MoE), qwen3-4b (qk-norm;
also with 2 KV heads, since its reduced form has as many KV heads as
heads, and with the int8 KV cache), granite-34b (MQA), chatglm3-6b (2d
rope, biases, GQA), command-r-plus-104b (LayerNorm), deepseek-v2-lite-16b
(MLA + MoE with shared experts), jamba-v0.1-52b (Mamba and attention,
MLP and MoE), xlstm-350m (mLSTM and sLSTM, tied embeddings),
whisper-large-v3 (the encoder and ``attn_cross``; also with the int8 KV
cache) and llama-3.2-vision-90b (``cross`` layers over the media). The
media are numpy normals: vision's [B, num_media_tokens, D], whisper's
frames [B, 10, D]; whisper decodes against ``encode``'s memory.

Tolerance for logits and f32 cache leaves: rtol 1e-5 / atol 1e-5 (logits
are about 0.6 in size; the two frameworks sum in other orders and XLA
contracts some multiply-adds into FMAs, and the observed difference is
about 2e-7). The MoE routing, the int8 cache values and every greedy
token must be identical.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.steps import make_prefill_step, make_serve_step
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import get_config as torch_config
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

RTOL = ATOL = 1e-5
SERVED = ["moonshot-v1-16b-a3b", "qwen3-4b", "qwen3-4b-gqa", "granite-34b",
          "chatglm3-6b", "command-r-plus-104b", "deepseek-v2-lite-16b",
          "jamba-v0.1-52b", "xlstm-350m", "qwen3-4b-int8", "whisper-large-v3",
          "llama-3.2-vision-90b"]
# the families this file serves beside attention + MLP/MoE
FAMILIES = ["deepseek-v2-lite-16b", "jamba-v0.1-52b", "xlstm-350m"]
# the encoder-decoder and cross-attention families
CROSS = ["whisper-large-v3", "llama-3.2-vision-90b"]
FRAMES = 10  # whisper's frames in these tests (the prompts have 12 tokens)
VARIANTS = {"-gqa": dict(num_kv_heads=2), "-int8": dict(kv_cache_dtype="int8"),
            "-qchunk": dict(q_chunk=2)}


def _configs(arch):
    """(JAX config, port config), reduced; ``qwen3-4b-gqa`` is qwen3-4b
    reduced with 2 KV heads, ``qwen3-4b-int8`` with the int8 KV cache,
    ``-qchunk`` with queries in chunks of 2 rows."""
    for suffix, change in VARIANTS.items():
        if arch.endswith(suffix):
            jc, tc = _configs(arch[:-len(suffix)])
            return (dataclasses.replace(jc, **change),
                    dataclasses.replace(tc, **change))
    return jax_config(arch).reduced(), torch_config(arch).reduced()


@functools.lru_cache(maxsize=None)
def _pair(arch, seed=0):
    jc, tc = _configs(arch)
    params = jax.jit(functools.partial(JT.init_params, jc))(
        jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jc, tc, params, convert.params_from_jax(tc, tree, device="cpu")


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _media(cfg, B, seed=0):
    """numpy media of ``cfg``: vision [B, num_media_tokens, D], audio frames
    [B, FRAMES, D], or None."""
    if cfg.frontend == "vision":
        shape = (B, cfg.num_media_tokens, cfg.d_model)
    elif cfg.frontend == "audio":
        shape = (B, FRAMES, cfg.d_model)
    else:
        return None
    return np.random.default_rng(seed + 100).normal(size=shape).astype(np.float32)


def _as(media, fn):
    return None if media is None else fn(media)


def _decode_kw(jc, tc, params, model, media):
    """(JAX's, the port's) decode-step keyword arguments for ``media``:
    vision passes the media, audio the memory each package's ``encode``
    makes of the frames."""
    if media is None:
        return {}, {}
    jm = jnp.asarray(media)
    jkw = ({"memory": JT.encode(jc, params, jm)} if jc.encoder_layers
           else {"media": jm})
    return jkw, {"memory": TT.make_memory(tc, model, torch.from_numpy(media))}


def _close(got, want, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


# -- convert -----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "whisper-large-v3"])
def test_params_from_jax_round_trip(arch):
    """Every JAX leaf lands in one port parameter per group (or encoder
    layer), holding its values; leaf and element counts equal."""
    jc, tc, params, model = _pair(arch)
    leaves = jax.tree_util.tree_flatten_with_path(params)[0]
    port = dict(model.named_parameters())

    def stack(keys):  # (prefix, layers) of a stacked leaf, or None
        name = ".".join(keys)
        return next(((st, n) for st, n in TT.stacks(tc).items()
                     if name.startswith(st)), None)

    expected = sum((stack([k.key for k in path]) or (None, 1))[1]
                   for path, _ in leaves)
    assert len(port) == expected
    assert sum(p.numel() for p in port.values()) == sum(
        x.size for _, x in leaves) == jc.param_count()
    seen = set()
    for path, leaf in leaves:
        keys = [k.key for k in path]
        leaf = np.asarray(leaf)
        st = stack(keys)
        if st:
            prefix, n = st
            rest = ".".join(keys[prefix.count("."):])
            parts = [(f"{prefix}{g}.{rest}", leaf[g]) for g in range(n)]
        else:
            parts = [(".".join(keys), leaf)]
        for name, value in parts:
            np.testing.assert_array_equal(port[name].numpy(), value, err_msg=name)
            seen.add(name)
    assert seen == set(port)


def test_params_from_jax_rejects_a_mismatched_tree():
    jc, tc, params, _ = _pair("qwen3-4b")
    tree = jax.tree_util.tree_map(np.asarray, params)
    bad = dict(tree, lm_head={"w": tree["lm_head"]["w"][:, :-1]})
    with pytest.raises(ValueError, match="lm_head"):
        convert.params_from_jax(tc, bad, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="final_norm"):
        convert.params_from_jax(tc, missing, device="cpu")
    extra = dict(tree, extra={"w": np.zeros((2,), np.float32)})
    with pytest.raises(ValueError, match="extra"):
        convert.params_from_jax(tc, extra, device="cpu")


def test_params_from_jax_takes_bf16():
    jc = dataclasses.replace(jax_config("qwen3-4b").reduced(),
                             param_dtype="bfloat16")
    tc = dataclasses.replace(torch_config("qwen3-4b").reduced(),
                             param_dtype="bfloat16")
    params = jax.jit(functools.partial(JT.init_params, jc))(
        jax.random.PRNGKey(2))
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = convert.params_from_jax(tc, tree, device="cpu")
    w = model.groups[1]["0"].mixer.wq.w
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(), np.asarray(params["groups"]["0"]["mixer"]["wq"]["w"][1],
                                      np.float32))


# -- forward, prefill and decode against JAX -------------------------------------

def _pad_jax_cache(jc, cache, S):
    """JAX's prompt-length cache padded to S rows, as its serve CLI pads
    it (the recurrent states have no length and stay as they are)."""
    B = jax.tree_util.tree_leaves(cache)[0].shape[1]
    full = JT.init_cache(jc, B, S)
    return jax.tree_util.tree_map(
        lambda d, s: d.at[tuple(slice(0, x) for x in s.shape)].set(s), full, cache)


def _same_cache(got, want, msg):
    """Every slot's every leaf: int8 values equal, the rest within 1e-5."""
    assert set(got) == set(want), msg
    for slot, leaves in want.items():
        assert set(got[slot]) == set(leaves), msg
        for name, w in leaves.items():
            w, g = np.asarray(w), got[slot][name]
            assert g.shape == w.shape and str(g.dtype)[6:] == str(w.dtype), name
            if w.dtype == np.int8:
                np.testing.assert_array_equal(g.numpy(), w,
                                              err_msg=f"{slot}.{name} {msg}")
            else:
                np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL,
                                           err_msg=f"{slot}.{name} {msg}")


@pytest.mark.parametrize("arch", SERVED)
def test_prefill_decode_forward_match_jax(arch):
    match_jax(arch)


def match_jax(arch):
    """forward, prefill and each decode step of ``arch`` against JAX's:
    the logits and, after prefill and each step, every cache leaf."""
    jc, tc, params, model = _pair(arch)
    B, S, P = 2, 12, 6
    toks = _tokens(jc, B, S)
    media = _media(jc, B)
    jm, tm = _as(media, jnp.asarray), _as(media, torch.from_numpy)
    jkw, tkw = _decode_kw(jc, tc, params, model, media)
    jfwd = jax.jit(functools.partial(JT.forward, jc))
    jpre = jax.jit(functools.partial(JT.prefill, jc))
    jdec = jax.jit(functools.partial(JT.decode_step, jc))
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        logits, _ = TT.forward(tc, model, t, tm)
        _close(logits, jfwd(params, jnp.asarray(toks), jm)[0], "forward")
        lp, cache = TT.prefill(tc, model, t[:, :P], tm, cache_len=S)
    jl, jcache = jpre(params, jnp.asarray(toks[:, :P]), jm)
    _close(lp, jl, "prefill")
    jcache = _pad_jax_cache(jc, jcache, S)
    _same_cache(cache, jcache, "after prefill")
    for pos in range(P, S):
        with torch.no_grad():
            ld, cache = TT.decode_step(tc, model, cache, t[:, pos:pos + 1], pos,
                                       **tkw)
        jl, jcache = jdec(params, jcache, jnp.asarray(toks[:, pos:pos + 1]),
                          jnp.int32(pos), **jkw)
        _close(ld, jl, f"decode at {pos}")
        _same_cache(cache, jcache, f"after decode at {pos}")


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "jamba-v0.1-52b"])
def test_moe_routing_per_layer_equals_jax(arch, monkeypatch):
    """Each MoE layer's per-expert token counts (the routing) through
    prefill and two decode steps equal JAX's: JAX's ``moe_apply`` recorded
    layer by layer (its scan run eagerly under ``jax.disable_jit``), the
    port's from each ``ops.batched_ranks`` call."""
    from repro_torch.kernels import ops
    jc, tc, params, model = _pair(arch)
    B, P = 2, 6
    toks = _tokens(jc, B, P + 2, seed=7)
    want, inner = [], JT.moe_lib.moe_apply

    def jax_recording(*a, **k):
        y, aux = inner(*a, **k)
        want.append(np.asarray(aux["expert_counts"]))
        return y, aux

    monkeypatch.setattr(JT.moe_lib, "moe_apply", jax_recording)
    with jax.disable_jit():
        _, jcache = JT.prefill(jc, params, jnp.asarray(toks[:, :P]))
        jcache = _pad_jax_cache(jc, jcache, P + 2)
        for pos in (P, P + 1):
            _, jcache = JT.decode_step(jc, params, jcache,
                                       jnp.asarray(toks[:, pos:pos + 1]),
                                       jnp.int32(pos))
    got, ranks = [], ops.batched_ranks

    def recording(flags):
        r, c = ranks(flags)
        got.append(c.sum(dim=0).numpy())
        return r, c

    monkeypatch.setattr(ops, "batched_ranks", recording)
    t = torch.from_numpy(toks).long()
    with torch.no_grad():
        _, cache = TT.prefill(tc, model, t[:, :P], cache_len=P + 2)
        for pos in (P, P + 1):
            TT.decode_step(tc, model, cache, t[:, pos:pos + 1], pos)
    moe_layers = tc.num_groups * sum(s.ffn == "moe" for s in tc.pattern)
    assert len(got) == len(want) == 3 * moe_layers
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, err_msg=f"MoE call {i}")


def _jax_generate(jc, params, toks, gen, media=None):
    """The JAX package's serving loop (launch/serve.py without a mesh):
    jitted prefill and serve steps, the cache padded to prompt + gen;
    ``media`` goes to prefill and, as vision's media or audio's encoded
    memory, to every serve step."""
    B, P = toks.shape
    prefill, serve = jax.jit(make_prefill_step(jc)), jax.jit(make_serve_step(jc))
    batch, extra = {"tokens": jnp.asarray(toks)}, {}
    if media is not None:
        batch["media"] = jnp.asarray(media)
        extra = ({"memory": JT.encode(jc, params, batch["media"])}
                 if jc.encoder_layers else {"media": batch["media"]})
    logits, cache = prefill(params, batch)
    full = JT.init_cache(jc, B, P + gen)
    cache = jax.tree_util.tree_map(
        lambda d, s: d.at[tuple(slice(0, x) for x in s.shape)].set(s), full, cache)
    tok = jnp.argmax(logits.at[..., jc.vocab_size:].set(-jnp.inf),
                     axis=-1).astype(jnp.int32)[:, None]
    out = [tok]
    for i in range(gen - 1):
        tok, cache = serve(params, cache, {"tokens": tok, "pos": jnp.int32(P + i),
                                           **extra})
        out.append(tok)
    return np.concatenate([np.asarray(x) for x in out], axis=1)


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen3-4b",
                                  "qwen3-4b-int8", *FAMILIES])
def test_generate_tokens_equal_jax(arch):
    jc, tc, params, model = _pair(arch)
    toks = _tokens(jc, 2, 16, seed=5)
    want = _jax_generate(jc, params, toks, 6)
    res = tserve.generate(tc, model, torch.from_numpy(toks).long(), 6)
    assert res.tokens.dtype == torch.int32 and res.tokens.shape == (2, 6)
    np.testing.assert_array_equal(res.tokens.numpy(), want)
    assert res.prefill_ms > 0 and res.decode_ms > 0


def test_vocab_padding_masked_in_serve():
    from repro_torch.launch.steps import make_serve_step as tstep
    tc = dataclasses.replace(torch_config("qwen3-4b").reduced(),
                             vocab_size=500, vocab_pad_multiple=64)
    assert tc.padded_vocab > tc.vocab_size
    model = TT.init_params(tc, device="cpu")
    with torch.no_grad():
        model.lm_head.b = None
        model.lm_head.w[:, tc.vocab_size:] = 10.0  # padding would win
    cache = TT.init_cache(tc, 2, 8, device="cpu")
    tok, _ = tstep(tc)(model, cache, {"tokens": torch.zeros((2, 1), dtype=torch.long),
                                      "pos": 0})
    assert tok.shape == (2, 1) and int(tok.max()) < tc.vocab_size


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", *FAMILIES, *CROSS])
def test_decode_matches_forward_teacher_forcing(arch):
    """prefill(prompt) + decode_step(token t) reproduce forward()'s logits
    (the port alone; tests/test_models.py holds JAX to the same), with a
    capacity factor at which nothing drops. xLSTM's prefill is the
    parallel form and its decode the recurrent step, so this holds the two
    together."""
    tc = torch_config(arch).reduced()
    if tc.moe:
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                             capacity_factor=8.0))
    model = TT.init_params(tc, seed=1, device="cpu")
    t = torch.from_numpy(_tokens(tc, 2, 12, seed=1)).long()
    media = _as(_media(tc, 2, seed=1), torch.from_numpy)
    with torch.no_grad():
        kw = {"memory": TT.make_memory(tc, model, media)}
        full, _ = TT.forward(tc, model, t, media)
        lp, cache = TT.prefill(tc, model, t[:, :6], media, cache_len=12)
        np.testing.assert_allclose(lp.numpy(), full[:, 5].numpy(),
                                   rtol=RTOL, atol=ATOL)
        for pos in range(6, 12):
            ld, cache = TT.decode_step(tc, model, cache, t[:, pos:pos + 1], pos,
                                       **kw)
            np.testing.assert_allclose(ld.numpy(), full[:, pos].numpy(),
                                       rtol=RTOL, atol=ATOL)


INT8_TF_TOL = 1e-2  # of the largest |logit|


@pytest.mark.parametrize("arch", ["qwen3-4b", "jamba-v0.1-52b",
                                  "whisper-large-v3"])
def test_int8_cache_teacher_forcing(arch):
    """With the int8 KV cache, prefill + decode_step against forward (whose
    attention reads the unquantised keys and values): each step's logits
    within ``INT8_TF_TOL`` of the largest |logit| (observed 0.03-0.07% on
    the reduced configs: the quantisation's error, up to max|x| / 254 a
    value). The int8 cache equals JAX's exactly in
    ``test_prefill_decode_forward_match_jax``."""
    tc = dataclasses.replace(torch_config(arch).reduced(), kv_cache_dtype="int8")
    if tc.moe:
        tc = dataclasses.replace(tc, moe=dataclasses.replace(tc.moe,
                                                             capacity_factor=8.0))
    model = TT.init_params(tc, seed=2, device="cpu")
    t = torch.from_numpy(_tokens(tc, 2, 12, seed=2)).long()
    media = _as(_media(tc, 2, seed=2), torch.from_numpy)
    with torch.no_grad():
        kw = {"memory": TT.make_memory(tc, model, media)}
        full, _ = TT.forward(tc, model, t, media)
        _, cache = TT.prefill(tc, model, t[:, :6], media, cache_len=12)
        assert any(c.get("k_q") is not None and c["k_q"].dtype == torch.int8
                   for c in cache.values())
        for pos in range(6, 12):
            ld, cache = TT.decode_step(tc, model, cache, t[:, pos:pos + 1], pos,
                                       **kw)
            want = full[:, pos]
            err = float((ld - want).abs().max())
            assert 0 < err <= INT8_TF_TOL * float(want.abs().max()), (pos, err)


# -- entry points --------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", *FAMILIES, *CROSS])
def test_serve_cli_on_cpu(arch, capsys):
    assert tserve.main(["--arch", arch, "--reduced",
                        "--batch", "2", "--prompt-len", "8", "--gen", "3",
                        "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced batch=2 prompt=8 gen=3" in out
