"""Per-shard init: each rank makes only its blocks of the train state.

``init_params(cfg, seed)`` draws each parameter from a generator of its
own, seeded from (seed, the leaf's index in the order of creation), so a
leaf can be made alone (``transformer.leaves``, ``common.make_leaf``) with
the values it has in the whole model. ``launch.train.build``'s
``init_state(seed)`` on a mesh (``steps.init_train_state``) walks the
leaves one at a time, keeps the rank's block of each and makes the
block's master, m and v (and residual), so no rank holds more than its
blocks and one whole leaf.

Held here:
- every leaf made alone equals the same leaf of the whole model, for
  every config (reduced), and the values depend on the seed;
- on (2, 2) and (2, 2, 2) gloo ranks with FSDP on, for five families
  (dense qwen3, MoE moonshot with the residual of int8 compression, MLA
  deepseek, hybrid Mamba jamba, whisper), every rank's block of every
  leaf of params, master, m, v (and residual) equals the same block of
  the unsharded ``init_params`` + ``adamw_init`` (``shard_train_state``),
  bit for bit, and so do the serving steps' parameters
  (``steps.init_sharded_params``); some leaves are split over the data
  axes;
- the peak of per-shard init of command-r-plus-104b on rank 0 of a fake
  (16, 16) group, traced under ``FakeTensorMode`` (nothing allocated) by
  ``step_analysis.StepTrace``: at least the rank's blocks of the state,
  at most those plus ``steps.init_bound_bytes`` (twice the largest whole
  leaf in f32), and under a tenth of the whole state.
"""

import dataclasses
import math

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, registry
from repro_torch.launch.steps import init_bound_bytes
from repro_torch.models import transformer as TT
from repro_torch.models.common import make_leaf
from torch_ranks import run_ranks

torch.set_num_threads(1)

FAMILIES = {  # id -> (arch, config change, compress)
    "qwen3": ("qwen3-4b", {}, False),
    "moonshot-compress": ("moonshot-v1-16b-a3b", {}, True),
    "deepseek": ("deepseek-v2-lite-16b", {}, False),
    "jamba": ("jamba-v0.1-52b", {}, False),
    "whisper": ("whisper-large-v3", {}, False),
}
MESHES = {(2, 2): ("data", "model"), (2, 2, 2): ("data", "model_a", "model_b")}
SEED = 7


@pytest.mark.parametrize("arch", sorted(registry()))
def test_a_leaf_made_alone_is_the_models_leaf(arch):
    cfg = get_config(arch).reduced()
    model = TT.init_params(cfg, SEED, "cpu")
    leaves = TT.leaves(cfg)
    assert list(leaves) == [n for n, _ in model.named_parameters()]
    for n, p in model.named_parameters():
        alone = make_leaf(leaves[n], SEED, "cpu")
        assert alone.dtype == p.dtype and torch.equal(alone, p.detach()), n
    other = TT.init_params(cfg, SEED + 1, "cpu")
    assert not torch.equal(other.embed.w, model.embed.w)


def test_a_leaf_does_not_depend_on_the_others():
    """Adding a layer leaves every leaf of the first layers as it was:
    the layers' own leaves keep their indices, and no draw is shared."""
    cfg = get_config("qwen3-4b").reduced()
    deeper = dataclasses.replace(cfg, num_layers=cfg.num_layers + 1)
    a = dict(TT.init_params(cfg, SEED, "cpu").named_parameters())
    b = dict(TT.init_params(deeper, SEED, "cpu").named_parameters())
    for n, p in a.items():
        if n.startswith("groups."):
            assert torch.equal(p, b[n]), n
    dense = [n for n, leaf in TT.leaves(cfg).items() if leaf.kind == "dense"]
    assert len({float(a[n].flatten()[0]) for n in dense}) == len(dense)


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    out = {}
    for mesh, axes in MESHES.items():
        cases = [dict(arch=arch, change=change, compress=compress, seed=SEED,
                      mesh=list(mesh), axes=list(axes))
                 for arch, change, compress in FAMILIES.values()]
        world = math.prod(mesh)
        ranks = run_ranks("init", tmp_path_factory.mktemp("init"), world,
                          timeout=300, mesh=[1] * (len(mesh) - 1) + [world],
                          axes=list(axes), cases=cases)
        for i, fid in enumerate(FAMILIES):
            out[mesh, fid] = [r[i] for r in ranks]
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("fid", list(FAMILIES))
def test_per_shard_init_equals_unsharded_blocks(made, mesh, fid):
    outs = made[mesh, fid]
    compress = FAMILIES[fid][2]
    split = 0
    for r, out in enumerate(outs):
        assert set(out["made"]) == set(out["want"]), r
        assert ("residual" in out["made"]) == compress
        for part, tree in out["want"].items():
            assert list(out["made"][part]) == list(tree), (r, part)
            for n, want in tree.items():
                got = out["made"][part][n]
                assert got.dtype == want.dtype and torch.equal(got, want), (r, part, n)
        for n, want in out["want"]["params"].items():
            assert torch.equal(out["serve"][n], want), (r, n)
            split += math.prod(want.shape) < math.prod(out["whole"][n])
        assert int(out["step"]) == 0
    assert split, "no leaf is split"
    coords = {tuple(out["coord"]) for out in outs}
    assert len(coords) == math.prod(mesh)


def test_init_peak_within_its_bound_on_a_fake_16x16_group():
    """command-r-plus-104b's train state made per shard on rank 0 of 256,
    traced: the peak lies between the rank's blocks and the blocks plus
    twice the largest leaf in f32."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import sharding as sh
    from repro_torch.launch.dryrun import init_fake_group, spec_bytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.step_analysis import StepTrace
    from repro_torch.launch.steps import init_train_state, train_state_specs
    cfg = get_config("command-r-plus-104b")
    init_fake_group(256)
    try:
        mesh = make_mesh((16, 16), ("data", "model"), device="cpu")
        pol = sh.ShardingPolicy.for_arch(cfg, mesh)
        assert pol.fsdp
        specs, shardings = train_state_specs(cfg, mesh, pol)
        blocks = spec_bytes(specs, shardings)
        with FakeTensorMode(), StepTrace() as trace:
            state = init_train_state(cfg, shardings, SEED, "cpu")
        whole = sum(math.prod(t.shape) * t.element_size()
                    for tree in (specs["params"], specs["opt"]["master"],
                                 specs["opt"]["m"], specs["opt"]["v"])
                    for t in tree.values())
    finally:
        dist.destroy_process_group()
    assert set(state["params"]) == set(specs["params"])
    bound = blocks + init_bound_bytes(cfg)
    assert blocks <= trace.peak_bytes <= bound, (blocks, trace.peak_bytes, bound)
    assert trace.peak_bytes < whole / 10, (trace.peak_bytes, whole)
