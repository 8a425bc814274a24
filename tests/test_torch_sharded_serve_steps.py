"""The port's sharded prefill and serve steps on four CPU ranks (gloo), a
(2, 2) mesh, against the JAX package's unsharded steps and the port's.

R1, R4: JAX's sharded steps fail on jax 0.9.0, so the sharded steps are
held against JAX's ``make_prefill_step`` / ``make_serve_step`` without a
mesh (jitted), and against the port's. The inputs are laid out as the
dry-run lays them out: parameters by ``params_shardings``, the batch by
``batch_shardings``, ``act_sharding`` the data axis when the batch
divides over it, ``ep_axis`` the model axis for a MoE config.

Each case runs the sharded prefill step (prompt 11, cache 16) and 4
serve steps: the greedy tokens equal JAX's and the port's unsharded ones
exactly; the prefill logits are within 1e-5 of both; the cache after the
last step, gathered, is within 1e-5 of the port's unsharded cache; each
rank's block of every cache leaf has JAX's shard shape at its mesh
coordinates (JAX's ``cache_spec`` on an ``AbstractMesh``), holds that
block of the gathered cache, and is the storage the prefill step made
(the serve steps update it in place). This file: attention with its
heads on the model axis (qwen3-4b), with one KV head (the sequence on
the model axis, SP), MoE under EP (moonshot: each rank is given E/2
experts), and a batch of 3 that does not divide over the data axis
(every rank computes every row). ``test_torch_sharded_serve_steps_hybrid.py``
holds MLA, Mamba, xLSTM and whisper's memory.
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
from torch_ranks import run_ranks, save_tree

torch.set_num_threads(1)

MESH, AXES = (2, 2), ("data", "model")
P, GEN, FRAMES = 11, 5, 10  # prompt, tokens generated (4 serve steps), frames
RTOL = ATOL = 1e-5
MOE = "moonshot-v1-16b-a3b"
CASES = {  # id -> (arch, config change, batch)
    "qwen3": ("qwen3-4b", {}, 4),
    "qwen3-kv1": ("qwen3-4b", {"num_kv_heads": 1}, 4),
    "moonshot": (MOE, {}, 4),
    "qwen3-b3": ("qwen3-4b", {}, 3),
}


def sharded_outputs(cases: dict, root) -> dict:
    """Every case's ranks' outputs: one run of the four ranks, the cases
    one after another."""
    specs = []
    for cid in cases:
        _, _, params, toks, media = case_inputs(cid, freeze(cases))
        save_tree(root / f"{cid}.npz", jax.tree_util.tree_map(np.asarray, params))
        np.save(root / f"{cid}-tokens.npy", toks)
        arch, change, _ = cases[cid]
        spec = dict(arch=arch, change=change, params=f"{cid}.npz",
                    tokens=f"{cid}-tokens.npy", gen=GEN)
        if media is not None:
            np.save(root / f"{cid}-media.npy", media)
            spec["media"] = f"{cid}-media.npy"
        specs.append(spec)
    ranks = run_ranks("serve_steps", root, MESH[0] * MESH[1], mesh=list(MESH),
                      axes=list(AXES), cases=specs)
    return {cid: [r[i] for r in ranks] for i, cid in enumerate(cases)}


def freeze(cases: dict) -> tuple:
    """``cases`` as a hashable key of the cached runs below."""
    return tuple((k, (a, tuple(sorted(c.items())), b)) for k, (a, c, b) in cases.items())


@functools.lru_cache(maxsize=None)
def case_inputs(cid, frozen):
    """(JAX config, port config, JAX params, tokens, media) of case ``cid``
    of the frozen cases: tokens [B, P] (seed 5), whisper's frames."""
    arch, change, B = dict(frozen)[cid]
    jc, tc = configs(arch, dict(change))
    params = jax.jit(functools.partial(JT.init_params, jc))(jax.random.PRNGKey(0))
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (B, P)).astype(np.int32)
    media = None
    if jc.frontend == "audio":
        media = np.random.default_rng(105).normal(
            size=(B, FRAMES, jc.d_model)).astype(np.float32)
    return jc, tc, params, toks, media


@functools.lru_cache(maxsize=None)
def jax_run(cid, frozen):
    """JAX's unsharded steps: (prefill logits, tokens [B, GEN]), jitted,
    the cache padded to P + GEN (``test_torch_models._jax_generate``)."""
    jc, _, params, toks, media = case_inputs(cid, frozen)
    B = toks.shape[0]
    prefill, serve = jax.jit(jax_prefill_step(jc)), jax.jit(jax_serve_step(jc))
    batch, extra = {"tokens": jnp.asarray(toks)}, {}
    if media is not None:
        batch["media"] = jnp.asarray(media)
        extra = {"memory": JT.encode(jc, params, batch["media"])}
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
def port_run(cid, frozen):
    """The port's unsharded steps: (prefill logits, tokens, final cache)."""
    jc, tc, params, toks, media = case_inputs(cid, frozen)
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


def jax_cache_specs(cid, frozen):
    """{slot: {leaf: (JAX's spec, its shard shape)}} on the (2, 2) mesh."""
    jc, _, _, toks, _ = case_inputs(cid, frozen)
    jm = JaxAbstractMesh(MESH, AXES)
    pol = jsh.ShardingPolicy.for_arch(jc, jm)
    cache = jax.eval_shape(functools.partial(JT.init_cache, jc, toks.shape[0],
                                             P + GEN))
    shardings = jsh.cache_shardings(jc, jm, pol, cache)
    return {j: {k: (tuple(shardings[j][k].spec),
                    JaxNamedSharding(jm, shardings[j][k].spec).shard_shape(
                        cache[j][k].shape))
                for k in cache[j]} for j in cache}


def check_case(outs, cid, cases):
    """Every assertion of the module docstring for case ``cid``."""
    frozen = freeze(cases)
    arch, _, B = cases[cid]
    jlogits, jtokens = jax_run(cid, frozen)
    plogits, ptokens, pcache = port_run(cid, frozen)
    sizes = dict(zip(AXES, MESH))
    jspecs = jax_cache_specs(cid, frozen)
    divides = B % MESH[0] == 0
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out["tokens"].numpy(), jtokens,
                                      err_msg=f"{cid} rank {r}")
        assert torch.equal(out["tokens"], ptokens), (cid, r)
        np.testing.assert_allclose(out["logits"].numpy(), jlogits, rtol=RTOL,
                                   atol=ATOL, err_msg=f"{cid} rank {r}")
        np.testing.assert_allclose(out["logits"].numpy(), plogits.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=f"{cid} rank {r}")
        want_rows = ("data" if divides else None, None)
        assert out["logits_spec"] == want_rows and out["tokens_spec"] == want_rows
        assert out["in_place"], (cid, r)
        coord = dict(zip(AXES, out["coord"]))
        for j, slot in out["cache"].items():
            for k, full in slot.items():
                np.testing.assert_allclose(
                    full.numpy(), pcache[j][k].numpy(), rtol=RTOL, atol=ATOL,
                    err_msg=f"{cid} rank {r} cache {j}.{k}")
                spec, shard = jspecs[j][k]
                assert out["cache_specs"][j][k] == spec, (cid, j, k)
                block = out["blocks"][j][k]
                assert tuple(block.shape) == tuple(shard), (cid, j, k)
                assert torch.equal(block, _block(full, spec, coord, sizes)), (
                    cid, r, j, k)
        if arch == MOE:  # EP: each rank is given its E / |model| experts
            E = case_inputs(cid, frozen)[1].moe.num_experts
            assert out["bound_experts"], cid
            for n, shape in out["bound_experts"].items():
                assert shape[0] == E // MESH[1], (n, shape)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    return sharded_outputs(CASES, tmp_path_factory.mktemp("serve_steps"))


@pytest.mark.parametrize("cid", list(CASES))
def test_sharded_serve_steps_match_unsharded(sharded, cid):
    check_case(sharded[cid], cid, CASES)
