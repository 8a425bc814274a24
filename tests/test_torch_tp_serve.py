"""Tensor-parallel serving: the port's sharded prefill and decode steps with
their products split over the model axis, on four CPU ranks (gloo),
against the JAX package's unsharded steps and the port's.

R1, R4: JAX's sharded steps fail on jax 0.9.0, so the sharded steps are
held against JAX's jitted ``make_prefill_step`` / ``make_serve_step``
without a mesh. One spawned group of four ranks runs every case, each on
its own mesh, (1, 4) or (2, 2), its inputs laid out as the dry-run lays
them out (``test_torch_sharded_serve_steps.py``'s rank task).

Cases: qwen3 with 2 KV heads on 4 ranks (whole KV projections, one q head
a rank; a sequence-split cache read as the rank's block of positions,
split-KV decode; a 500-token vocabulary, so greedy masks padding inside
a rank's block), the same with the int8 cache, qwen3 with 12 heads and 6
KV heads on 4 ranks (3 q heads a rank read KV heads that straddle two
groups; the cache split on the sequence), qwen3 with the int8 cache on
(2, 2) (the KV heads' blocks used in place), qwen3 tied with a batch of 3
(no row split), chatglm3 with 8 heads on 4 ranks (H/M < rep; 2 KV heads,
the cache split on the sequence), moonshot (EP and TP on one axis),
deepseek (MLA, its latent cache split on the sequence), jamba at M = 4
and M = 2 (``in_proj``'s exchange, Mamba's cache channels in place),
whisper (the encoder and ``attn_cross``) and vision (cross-attention to
the media). The prompt of 11 in a cache of 16 leaves the last rank's
block of 4 positions empty at the first decode step.

Each case runs the prefill (prompt 11, cache 16) and 4 decode steps: the
greedy tokens equal JAX's and the port's unsharded ones exactly; the
prefill logits within 1e-5 of both; the cache after the last step,
gathered, within 1e-5 of the port's unsharded cache; each rank's block of
every cache leaf has JAX's shard shape at its mesh coordinates, holds that
block and is the storage the prefill made; and each step's bind gives
every leaf that JAX's ``param_spec`` splits over the model axis as that
block, with no all-gather (``test_torch_tp_train.check_binds``); and no
decode step all-gathers a cache leaf that a model axis splits past the
batch (no all-gather's result has the dims, in any order, of a group's
leaf with those dims whole, which gathering it builds): the sequence of
a split-KV cache in the cases that have one (``SEQ_SPLIT``), the KV
heads, Mamba's channels.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh as JaxAbstractMesh
from jax.sharding import NamedSharding as JaxNamedSharding

from repro.launch import sharding as jsh
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.launch.steps import make_serve_step as jax_serve_step
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.launch.steps import greedy, make_prefill_step, make_serve_step
from repro_torch.models import transformer as TT
from test_torch_sharded_step import _block, configs
from test_torch_tp_train import check_binds
from torch_ranks import run_ranks, save_tree

torch.set_num_threads(1)

P, GEN, FRAMES = 11, 5, 10  # prompt, tokens generated (4 decode steps), frames
RTOL = ATOL = 1e-5
AXES = ("data", "model")
MOE = "moonshot-v1-16b-a3b"
QWEN3 = "qwen3-4b"
CASES = {  # id -> (mesh, arch, config change, batch)
    "1x4-qwen3-gqa": ((1, 4), QWEN3, {"num_kv_heads": 2, "vocab_size": 500}, 4),
    "1x4-qwen3-int8-gqa": ((1, 4), QWEN3, {"num_kv_heads": 2,
                                           "kv_cache_dtype": "int8"}, 4),
    "1x4-qwen3-h12": ((1, 4), QWEN3, {"num_heads": 12, "num_kv_heads": 6}, 4),
    "2x2-qwen3-int8": ((2, 2), QWEN3, {"kv_cache_dtype": "int8"}, 4),
    "2x2-qwen3-tied-b3": ((2, 2), QWEN3, {"tie_embeddings": True}, 3),
    "1x4-chatglm3-h8": ((1, 4), "chatglm3-6b", {"num_heads": 8}, 4),
    "2x2-moonshot": ((2, 2), MOE, {}, 4),
    "1x4-deepseek": ((1, 4), "deepseek-v2-lite-16b", {}, 4),
    "1x4-jamba": ((1, 4), "jamba-v0.1-52b", {}, 4),
    "2x2-jamba": ((2, 2), "jamba-v0.1-52b", {}, 4),
    "2x2-whisper": ((2, 2), "whisper-large-v3", {}, 4),
    "1x4-vision": ((1, 4), "llama-3.2-vision-90b", {}, 4),
}
SEQ_SPLIT = ("1x4-qwen3-gqa", "1x4-qwen3-int8-gqa", "1x4-qwen3-h12",
             "1x4-chatglm3-h8", "1x4-deepseek")  # caches split on the sequence


def freeze(case) -> tuple:
    """A case (mesh, arch, change, batch) as a hashable key."""
    mesh, arch, change, B = case
    return tuple(mesh), arch, tuple(sorted(change.items())), B


@functools.lru_cache(maxsize=None)
def case_inputs(arch, change, B):
    """(JAX config, port config, JAX params, tokens [B, P] (seed 5), media:
    whisper's frames or vision's patch embeddings, else None)."""
    jc, tc = configs(arch, dict(change))
    params = jax.jit(functools.partial(JT.init_params, jc))(jax.random.PRNGKey(0))
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (B, P)).astype(np.int32)
    media = None
    if jc.frontend == "audio":
        media = np.random.default_rng(105).normal(
            size=(B, FRAMES, jc.d_model)).astype(np.float32)
    elif jc.num_media_tokens:
        media = np.random.default_rng(106).normal(
            size=(B, jc.num_media_tokens, jc.d_model)).astype(np.float32)
    return jc, tc, params, toks, media


def ranks_outputs(cases: dict, root, world: int, axes) -> dict:
    """Every case's ranks' outputs: one run of ``world`` ranks, each case
    on its own mesh."""
    specs = []
    for cid, case in cases.items():
        mesh, arch, change, B = freeze(case)
        _, _, params, toks, media = case_inputs(arch, change, B)
        save_tree(root / f"{cid}.npz", jax.tree_util.tree_map(np.asarray, params))
        np.save(root / f"{cid}-tokens.npy", toks)
        spec = dict(arch=arch, change=dict(change), params=f"{cid}.npz",
                    tokens=f"{cid}-tokens.npy", gen=GEN, mesh=list(mesh),
                    axes=list(axes))
        if media is not None:
            np.save(root / f"{cid}-media.npy", media)
            spec["media"] = f"{cid}-media.npy"
        specs.append(spec)
    outs = run_ranks("serve_steps", root, world, timeout=400,
                     mesh=[1] * (len(axes) - 1) + [world], axes=list(axes),
                     cases=specs, record=True)
    return {cid: [r[i] for r in outs] for i, cid in enumerate(cases)}


@functools.lru_cache(maxsize=None)
def jax_run(arch, change, B):
    """JAX's unsharded steps: (prefill logits, tokens [B, GEN]), jitted, the
    cache padded to P + GEN."""
    jc, _, params, toks, media = case_inputs(arch, change, B)
    prefill, serve = jax.jit(jax_prefill_step(jc)), jax.jit(jax_serve_step(jc))
    batch, extra = {"tokens": jnp.asarray(toks)}, {}
    if media is not None:
        batch["media"] = jnp.asarray(media)
        extra = ({"memory": JT.encode(jc, params, batch["media"])}
                 if jc.encoder_layers else {"media": batch["media"]})
    logits, cache = prefill(params, batch)
    full = JT.init_cache(jc, B, P + GEN)
    cache = jax.tree_util.tree_map(
        lambda d, s: d.at[tuple(slice(0, x) for x in s.shape)].set(s), full, cache)
    tok = jnp.argmax(logits.at[..., jc.vocab_size:].set(-jnp.inf),
                     axis=-1).astype(jnp.int32)[:, None]
    out = [tok]
    for i in range(GEN - 1):
        tok, cache = serve(params, cache, {"tokens": tok, "pos": jnp.int32(P + i),
                                           **extra})
        out.append(tok)
    return np.asarray(logits), np.concatenate([np.asarray(x) for x in out], axis=1)


@functools.lru_cache(maxsize=None)
def port_run(arch, change, B):
    """The port's unsharded steps: (prefill logits, tokens, final cache)."""
    _, tc, params, toks, media = case_inputs(arch, change, B)
    model = convert.params_from_jax(tc, jax.tree_util.tree_map(np.asarray, params),
                                    device="cpu")
    batch, extra = {"tokens": torch.from_numpy(toks).long()}, {}
    if media is not None:
        batch["media"] = torch.from_numpy(media)
        with torch.no_grad():
            extra = {"memory": TT.make_memory(tc, model, batch["media"])}
    logits, cache = make_prefill_step(tc, cache_len=P + GEN)(model, batch)
    tok = greedy(tc, logits)
    out = [tok]
    serve = make_serve_step(tc)
    for i in range(GEN - 1):
        tok, cache = serve(model, cache, {"tokens": tok, "pos": P + i, **extra})
        out.append(tok)
    return logits, torch.cat(out, dim=1), cache


SEQ_LEAVES = ("k", "v", "k_q", "v_q", "k_s", "v_s", "c_kv", "k_rope")


def model_axes_of(entry) -> tuple:
    """The model axes of one dim's JAX spec entry."""
    names = (entry,) if isinstance(entry, str) else tuple(entry or ())
    return tuple(a for a in names if a.startswith("model"))


def gathered_shape(block, full, spec):
    """The shape of one group of a cache leaf's block with every dim past
    the batch that a model axis splits made whole (what gathering the
    leaf over those axes builds), or None when no model axis splits such
    a dim (``spec``: the stacked leaf's JAX spec, its group dim 0 and
    batch dim 1; ``full`` the leaf gathered)."""
    shape, cut = list(block.shape[1:]), False
    for d in range(2, len(spec)):
        if model_axes_of(spec[d]):
            shape[d - 1], cut = full.shape[d], True
    return tuple(shape) if cut else None


def check_serving(outs, case, axes, what) -> tuple:
    """Every assertion of the module docstring for one case; returns the
    number of cache leaves split on the sequence (attention's and MLA's),
    and of all those a model axis splits past the batch."""
    mesh, arch, change, B = freeze(case)
    jc, tc, _, _, _ = case_inputs(arch, change, B)
    jlogits, jtokens = jax_run(arch, change, B)
    plogits, ptokens, pcache = port_run(arch, change, B)
    sizes = dict(zip(axes, mesh))
    jm = JaxAbstractMesh(mesh, tuple(axes))
    jpol = jsh.ShardingPolicy.for_arch(jc, jm)
    jcache = jax.eval_shape(functools.partial(JT.init_cache, jc, B, P + GEN))
    jshard = jsh.cache_shardings(jc, jm, jpol, jcache)
    shapes = {n: tuple(p.shape) for n, p in
              TT.init_params(tc, device="meta").named_parameters()}
    seq_split = cut = 0
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["tokens"].numpy(), jtokens,
                                      err_msg=f"{what} rank {r}")
        assert torch.equal(out["tokens"], ptokens), (what, r)
        for want in (jlogits, plogits.numpy()):
            np.testing.assert_allclose(out["logits"].numpy(), want, rtol=RTOL,
                                       atol=ATOL, err_msg=f"{what} rank {r}")
        assert out["in_place"], (what, r)
        coord = dict(zip(axes, out["coord"]))
        gathered = [sorted(g) for g in out["decode_gathers"]]
        for j, slot in out["cache"].items():
            for k, full in slot.items():
                np.testing.assert_allclose(
                    full.numpy(), pcache[j][k].numpy(), rtol=RTOL, atol=ATOL,
                    err_msg=f"{what} rank {r} cache {j}.{k}")
                spec = tuple(jshard[j][k].spec)
                assert out["cache_specs"][j][k] == spec, (what, j, k)
                block = out["blocks"][j][k]
                shard = JaxNamedSharding(jm, jshard[j][k].spec).shard_shape(
                    jcache[j][k].shape)
                assert tuple(block.shape) == tuple(shard), (what, j, k)
                assert torch.equal(block, _block(full, spec, coord, sizes)), (
                    what, r, j, k)
                whole = gathered_shape(block, full, spec)
                if whole is not None:  # in any order: gathered on dim 0 first
                    cut += r == 0
                    seq_split += r == 0 and k in SEQ_LEAVES and bool(
                        model_axes_of(spec[2]))
                    assert sorted(whole) not in gathered, (what, r, j, k)
        assert len(out["binds"]) == 2, (what, r)  # the prefill's, a decode's
        check_binds(out["binds"], jc, tc, mesh, axes, shapes, f"{what} rank {r}")
    return seq_split, cut


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return ranks_outputs(CASES, tmp_path_factory.mktemp("tp_serve"), 4, AXES)


@pytest.mark.parametrize("cid", list(CASES))
def test_tp_serving_steps_match_unsharded(ranks, cid):
    seq_split, _ = check_serving(ranks[cid], CASES[cid], AXES, cid)
    assert bool(seq_split) == (cid in SEQ_SPLIT)
