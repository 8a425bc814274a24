"""The port's model configs and entry points, against the JAX package where
it has a counterpart: every config's parameter leaves and count (JAX's
``param_specs``/``param_count``, by ``jax.eval_shape``; the port's model on
the ``meta`` device; nothing allocated) and active count, the full-size
counts, the parameter names and the seeded init."""

import dataclasses

import jax
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs.shapes import param_specs
from repro_torch import convert
from repro_torch.configs import get_config as torch_config
from repro_torch.configs import registry as torch_registry
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT

torch.set_num_threads(1)

ARCHS = sorted(jax_registry())
# the configs whose mixers the port builds: every one
BUILT = {"moonshot-v1-16b-a3b", "qwen3-4b", "chatglm3-6b",
         "command-r-plus-104b", "granite-34b", "deepseek-v2-lite-16b",
         "jamba-v0.1-52b", "xlstm-350m", "whisper-large-v3",
         "llama-3.2-vision-90b"}


def _jax_shapes(jc):
    """``{"groups.0.mixer.wq.w": (num_groups, D, H*hd), ...}``: every leaf
    of JAX's parameter pytree, dot-joined, with its shape."""
    specs = jax.tree_util.tree_flatten_with_path(param_specs(jc))[0]
    return {".".join(k.key for k in path): tuple(leaf.shape)
            for path, leaf in specs}


def _jax_name(cfg, name):
    """(JAX leaf name, stack) of port parameter ``name``: ``groups.<g>.<path>``
    is ``groups.<path>`` and ``encoder.groups.<i>.<path>``
    ``encoder.groups.<path>``; stack is the prefix, or None."""
    for stack in TT.stacks(cfg):
        if name.startswith(stack):
            return stack + name[len(stack):].split(".", 1)[1], stack
    return name, None


def _port_shapes(cfg, model):
    """The port's parameters under JAX's leaf names: each stacked one
    collected into one list of shapes per JAX leaf."""
    got = {}
    for name, p in model.named_parameters():
        leaf, stack = _jax_name(cfg, name)
        if stack:
            got.setdefault(leaf, []).append(tuple(p.shape))
        else:
            got[leaf] = tuple(p.shape)
    return got


def test_every_config_is_built_or_later():
    assert set(ARCHS) == BUILT


@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_and_count_match_jax(arch):
    """Every leaf of JAX's parameter pytree, at full size and reduced."""
    for jc, tc in ((jax_registry()[arch], torch_registry()[arch]),
                   (jax_registry()[arch].reduced(),
                    torch_registry()[arch].reduced())):
        want = _jax_shapes(jc)
        got = _port_shapes(tc, TT.init_params(tc, device="meta"))
        assert set(got) == set(want)
        for k, shape in want.items():
            stack = next((st for st in TT.stacks(tc) if k.startswith(st)), None)
            if stack:
                assert got[k] == [shape[1:]] * shape[0], k
            else:
                assert got[k] == shape, k
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()


@pytest.mark.parametrize("arch,count,active", [
    ("whisper-large-v3", 1_602_360_320, 1_602_360_320),
    ("llama-3.2-vision-90b", 87_666_794_496, 87_666_794_496),
    ("deepseek-v2-lite-16b", 16_210_324_992, 2_663_247_360),
    ("jamba-v0.1-52b", 51_570_315_264, 12_110_303_232),
    ("xlstm-350m", 429_401_184, 429_401_184),
    ("moonshot-v1-16b-a3b", 28_057_995_264, 3_974_301_696)])
def test_full_size_counts(arch, count, active):
    """The JAX package's full-size counts (``param_count``,
    ``active_param_count``), from the port's meta-device model."""
    cfg = torch_config(arch)
    assert (cfg.param_count(), cfg.active_param_count()) == (count, active)


def test_moonshot_param_count_full_size():
    cfg = torch_config("moonshot-v1-16b-a3b")
    assert cfg.param_count() == 28_057_995_264
    model = TT.init_params(cfg, device="meta")  # allocates nothing
    assert TT.count_params(model) == 28_057_995_264
    assert model.groups[0]["0"].ffn.router.w.dtype == torch.float32
    assert model.groups[0]["0"].ffn.experts.gate.dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["moonshot-v1-16b-a3b", "qwen3-4b",
                                  "chatglm3-6b", "command-r-plus-104b",
                                  "deepseek-v2-lite-16b", "jamba-v0.1-52b",
                                  "xlstm-350m", "whisper-large-v3",
                                  "llama-3.2-vision-90b"])
def test_meta_model_names_follow_jax_paths(arch):
    """Port parameter ``groups.<g>.<path>`` is JAX leaf ``groups.<path>[g]``
    (``encoder.groups.<i>.<path>`` is ``encoder.groups.<path>[i]``), in the
    leaf's dtype (the router's f32, Mamba's ``A_log`` and ``D`` among bf16
    weights)."""
    cfg = torch_config(arch)
    specs = jax.tree_util.tree_flatten_with_path(
        param_specs(jax_registry()[arch]))[0]
    want = {".".join(k.key for k in path): str(leaf.dtype) for path, leaf in specs}
    model = TT.init_params(cfg, device="meta")
    seen = set()
    for name, p in model.named_parameters():
        leaf, stack = _jax_name(cfg, name)
        if stack:
            g = int(name[len(stack):].split(".", 1)[0])
            assert 0 <= g < TT.stacks(cfg)[stack]
            name = leaf
        assert str(p.dtype) == "torch." + want[name], name
        seen.add(name)
    assert seen == set(want)  # every leaf has its parameters


def test_dtypes_are_torch():
    cfg = torch_config("moonshot-v1-16b-a3b")
    assert cfg.pdtype == torch.bfloat16 and cfg.cdtype == torch.bfloat16
    assert cfg.reduced().pdtype == torch.float32
    assert cfg.reduced() == dataclasses.replace(
        cfg.reduced(), name="moonshot-v1-16b-a3b-reduced")


def test_init_is_seeded():
    tc = torch_config("moonshot-v1-16b-a3b").reduced()
    a = TT.init_params(tc, seed=3, device="cpu")
    b = TT.init_params(tc, seed=3, device="cpu")
    c = TT.init_params(tc, seed=4, device="cpu")
    wa, wb, wc = (m.groups[0]["0"].ffn.experts.up for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert float(wa.abs().max()) <= 0.04 + 1e-7  # truncated at 2 sigma
    assert abs(float(wa.std()) - 0.0176) < 0.002  # 0.02 * std of N(0,1) on [-2, 2]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card behaviour cannot show")


def test_default_device_needs_a_card(no_card):
    tc = torch_config("moonshot-v1-16b-a3b").reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        TT.init_params(tc)
    with pytest.raises(RuntimeError, match="cuda"):
        tserve.main(["--arch", "qwen3-4b", "--reduced"])
    with pytest.raises(RuntimeError, match="cuda"):
        convert.params_from_jax(tc, {})


@pytest.mark.parametrize("arch", sorted(BUILT))
def test_int8_cache_and_q_chunk_run_every_built_config(arch):
    """With the int8 KV cache and q_chunk set, every config the port
    builds runs forward, prefill and decode (held against JAX in
    tests/test_torch_models.py and tests/test_torch_attention.py)."""
    tc = dataclasses.replace(torch_config(arch).reduced(),
                             kv_cache_dtype="int8", q_chunk=4)
    model = TT.init_params(tc, device="cpu")
    t = torch.zeros((1, 8), dtype=torch.long)
    media = tserve.make_media(tc, 1, 8, torch.Generator().manual_seed(0), "cpu")
    with torch.no_grad():
        memory = TT.encode(tc, model, media) if tc.encoder_layers else media
        logits, _ = TT.forward(tc, model, t, media)
        lp, cache = TT.prefill(tc, model, t, media, cache_len=9)
        ld, _ = TT.decode_step(tc, model, cache, t[:, :1], 8, memory=memory)
    assert logits.shape == (1, 8, tc.padded_vocab)
    assert bool(torch.isfinite(ld).all()) and bool(torch.isfinite(lp).all())
    kinds = {str(v.dtype) for c in cache.values() for v in c.values()}
    assert ("torch.int8" in kinds) == any(s.mixer in ("attn", "attn_cross")
                                          for s in tc.pattern)
