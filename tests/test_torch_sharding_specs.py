"""The port's sharding rules against the JAX package's, exactly.

For all ten configs at full size on the meshes (16, 16), (2, 16, 16),
the production split mesh (16, 4, 4) and the small (2, 4) and split
(2, 2, 2): ``ShardingPolicy.for_arch`` and ``heads_split``; every
parameter's spec (JAX stacks a layer's parameters under ``groups``, the
port keeps one tensor a layer: the port's spec is JAX's without the
stacked dim's leading None); every optimizer-state and residual spec
and ``step`` (``train_state_specs``); every decode-cache spec; every
batch spec. JAX's side runs on a ``jax.sharding.AbstractMesh`` (no
devices: ``jax.make_mesh``'s Explicit axes fail on jax 0.9.0, R1), the
port's on its ``AbstractMesh``. Also ``make_production_mesh``'s axes and
shapes (a ``DeviceMesh`` over the fake process group, one process),
``placements``' mesh-order check and ``auto_microbatch`` over a mesh.
"""

import dataclasses
import functools

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JaxAbstractMesh

from repro.configs import get_config as jax_config
from repro.configs.base import registry as jax_registry
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.configs.shapes import applicable as jax_applicable
from repro.configs.shapes import batch_specs as jax_batch_specs
from repro.configs.shapes import cache_specs as jax_cache_specs
from repro.configs.shapes import param_specs as jax_param_specs
from repro.launch import sharding as jsh
from repro.launch.steps import auto_microbatch as jax_auto_microbatch
from repro.launch.steps import train_state_specs as jax_train_state_specs
from repro_torch.configs import get_config as torch_config
from repro_torch.configs.shapes import SHAPES, batch_specs, cache_specs
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tsh
from repro_torch.launch.steps import auto_microbatch, train_state_specs
from repro_torch.models import transformer as TT

ARCHS = sorted(jax_registry())
MESHES = {
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
    "16x4x4": ((16, 4, 4), ("data", "model_a", "model_b")),
    "2x4": ((2, 4), ("data", "model")),
    "2x2x2": ((2, 2, 2), ("data", "model_a", "model_b")),
}
CASES = [(a, m) for a in ARCHS for m in MESHES]


def meshes(mesh_name):
    """(JAX's AbstractMesh, the port's) of ``mesh_name``."""
    shape, axes = MESHES[mesh_name]
    return JaxAbstractMesh(shape, axes), tmesh.AbstractMesh(shape, axes)


@functools.lru_cache(maxsize=None)
def param_count(arch):
    return torch_config(arch).param_count()


@functools.lru_cache(maxsize=None)
def policies(arch, mesh_name):
    """(JAX's policy, the port's), FSDP from the port's parameter count
    (``test_policy_matches_jax`` holds ``for_arch``'s own count)."""
    jm, tm = meshes(mesh_name)
    fsdp = param_count(arch) >= tsh.FSDP_THRESHOLD
    return (jsh.ShardingPolicy.for_arch(jax_config(arch), jm, fsdp=fsdp),
            tsh.ShardingPolicy.for_arch(torch_config(arch), tm, fsdp=fsdp))


@functools.lru_cache(maxsize=None)
def jax_params(arch):
    return jax_param_specs(jax_config(arch))


@functools.lru_cache(maxsize=None)
def torch_params(arch):
    return {n: p for n, p in
            TT.init_params(torch_config(arch), device="meta").named_parameters()}


def path_name(path) -> str:
    return ".".join(str(getattr(p, "key", getattr(p, "name", p))) for p in path)


def jax_leaf(tc, name: str):
    """(JAX's dotted leaf path, stacked) of the port's parameter ``name``:
    ``groups.<g>.<rest>`` is JAX's ``groups.<rest>`` [num_groups, ...],
    ``encoder.groups.<i>.<rest>`` its ``encoder.groups.<rest>``."""
    for st in TT.stacks(tc):
        if name.startswith(st):
            index, _, rest = name[len(st):].partition(".")
            if index.isdigit():
                return st + rest, True
    return name, False


def jax_param_spec_of(arch, mesh_name, name):
    """JAX's spec of the port's parameter ``name``, the stacked dim's
    entry taken off."""
    jm, _ = meshes(mesh_name)
    jpol, _ = policies(arch, mesh_name)
    specs = jax_param_spec_table(arch, mesh_name)
    leaf, stacked = jax_leaf(torch_config(arch), name)
    spec = specs[leaf]
    if stacked:
        assert spec[0] is None, (name, spec)
        return tuple(spec)[1:]
    return tuple(spec)


@functools.lru_cache(maxsize=None)
def jax_param_spec_table(arch, mesh_name):
    jm, _ = meshes(mesh_name)
    jpol, _ = policies(arch, mesh_name)
    jc = jax_config(arch)
    return {path_name(p): jsh.param_spec(jc, jm, jpol, p, leaf)
            for p, leaf in jax.tree_util.tree_flatten_with_path(jax_params(arch))[0]}


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_policy_matches_jax(arch, mesh_name):
    jm, tm = meshes(mesh_name)
    jc, tc = jax_config(arch), torch_config(arch)
    jpol = jsh.ShardingPolicy.for_arch(jc, jm)
    tpol = tsh.ShardingPolicy.for_arch(tc, tm)
    assert (tpol.fsdp, tpol.data, tpol.model) == (jpol.fsdp, jpol.data, jpol.model)
    for heads in sorted({tc.num_heads, tc.num_kv_heads, 1, 20, 24}):
        assert tpol.heads_split(tm, heads) == jpol.heads_split(jm, heads), heads
    assert tmesh.data_axes(tm) == tuple(a for a in MESHES[mesh_name][1]
                                        if not a.startswith("model"))


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_param_specs_match_jax(arch, mesh_name):
    _, tm = meshes(mesh_name)
    _, tpol = policies(arch, mesh_name)
    tc = torch_config(arch)
    got = tsh.params_shardings(tc, tm, tpol, torch_params(arch))
    assert set(got) == set(torch_params(arch))
    table = jax_param_spec_table(arch, mesh_name)
    used = set()
    for name, sharding in got.items():
        assert tuple(sharding.spec) == jax_param_spec_of(arch, mesh_name, name), name
        used.add(jax_leaf(tc, name)[0])
    assert used == set(table)  # every JAX leaf has its port tensors


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_train_state_specs_match_jax(arch, mesh_name):
    """master, m, v and the residual: their parameter's spec; step: P();
    the state's shapes and dtypes as JAX's leaves (unstacked)."""
    jm, tm = meshes(mesh_name)
    jpol, tpol = policies(arch, mesh_name)
    jc, tc = jax_config(arch), torch_config(arch)
    jstate, jshard = jax_train_state_specs(jc, jm, jpol, compress=True)
    state, shard = train_state_specs(tc, tm, tpol, compress=True)
    assert tuple(shard["opt"]["step"].spec) == tuple(jshard["opt"]["step"].spec) == ()
    assert state["opt"]["step"].shape == () and state["opt"]["step"].dtype == torch.int32
    jleaves = {}
    for part, tree in (("master", jshard["opt"]["master"]), ("m", jshard["opt"]["m"]),
                       ("v", jshard["opt"]["v"]), ("residual", jshard["residual"])):
        for p, ns in jax.tree_util.tree_flatten_with_path(tree)[0]:
            jleaves[part, path_name(p)] = tuple(ns.spec)
    jsds = {path_name(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(jstate["opt"]["master"])[0]}
    for part in ("master", "m", "v", "residual"):
        sh = shard["opt"][part] if part != "residual" else shard["residual"]
        st = state["opt"][part] if part != "residual" else state["residual"]
        assert set(sh) == set(torch_params(arch))
        for name, ns in sh.items():
            leaf, stacked = jax_leaf(tc, name)
            want = jleaves[part, leaf][1:] if stacked else jleaves[part, leaf]
            assert tuple(ns.spec) == want, (part, name)
            sds = jsds[leaf]
            assert st[name].dtype == torch.float32 and str(sds.dtype) == "float32"
            assert tuple(st[name].shape) == (tuple(sds.shape)[1:] if stacked
                                             else tuple(sds.shape)), name
    for name, ns in shard["params"].items():
        assert tuple(ns.spec) == jax_param_spec_of(arch, mesh_name, name), name


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_cache_specs_match_jax(arch, mesh_name):
    """Every cache leaf of each decode shape the config runs."""
    jm, tm = meshes(mesh_name)
    jpol, tpol = policies(arch, mesh_name)
    jc, tc = jax_config(arch), torch_config(arch)
    seen = 0
    for case_name, case in SHAPES.items():
        if case.kind != "decode" or jax_applicable(jc, JAX_SHAPES[case_name]):
            continue
        jcache = jax_cache_specs(jc, JAX_SHAPES[case_name])
        jsh_tree = jsh.cache_shardings(jc, jm, jpol, jcache)
        want = {tuple(str(getattr(k, "key", k)) for k in p): tuple(ns.spec)
                for p, ns in jax.tree_util.tree_flatten_with_path(jsh_tree)[0]}
        cache = cache_specs(tc, case)
        got = {p: tuple(ns.spec)
               for p, ns in _flat(tsh.cache_shardings(tc, tm, tpol, cache))}
        assert got == want, case_name
        for p, leaf in _flat(cache):
            assert tuple(tsh.cache_spec(tc, tm, tpol, p, leaf)) == want[p]
        seen += len(got)
    assert seen > 0 or not any(s.mixer in ("attn", "attn_cross", "mla", "mamba",
                                           "mlstm", "slstm") for s in tc.pattern)


@pytest.mark.parametrize("arch,mesh_name", CASES)
def test_batch_specs_match_jax(arch, mesh_name):
    jm, tm = meshes(mesh_name)
    jpol, tpol = policies(arch, mesh_name)
    jc, tc = jax_config(arch), torch_config(arch)
    for case_name, case in SHAPES.items():
        jb = jsh.batch_shardings(jc, jm, jpol, jax_batch_specs(jc, JAX_SHAPES[case_name]))
        got = tsh.batch_shardings(tc, tm, tpol, batch_specs(tc, case))
        assert set(got) == set(jb), case_name
        for k, ns in got.items():
            assert tuple(ns.spec) == tuple(jb[k].spec), (case_name, k)


@pytest.mark.parametrize("multi_pod,model_split", [(False, None), (True, None),
                                                   (False, 4), (True, 4)])
def test_production_mesh_names_and_shapes(multi_pod, model_split):
    """``make_production_mesh`` over a fake process group of its size (one
    process); its axes and shape equal ``production_mesh_shape``'s and
    JAX's (computed by hand: JAX's builds through ``jax.make_mesh``, R1)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, axes = tmesh.production_mesh_shape(multi_pod=multi_pod,
                                              model_split=model_split)
    want_axes = (("pod",) if multi_pod else ()) + (
        ("data", "model_a", "model_b") if model_split else ("data", "model"))
    want_shape = ((2,) if multi_pod else ()) + (
        (16, model_split, 16 // model_split) if model_split else (16, 16))
    assert (shape, axes) == (want_shape, want_axes)
    world = 512 if multi_pod else 256
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        m = tmesh.make_production_mesh(multi_pod=multi_pod, model_split=model_split,
                                       device="cpu")
        assert tuple(m.mesh_dim_names) == axes
        assert tuple(m.mesh.shape) == shape and m.mesh.numel() == world
        assert tmesh.data_axes(m) == (("pod", "data") if multi_pod else ("data",))
        assert tmesh.model_axes(m) == (("model_a", "model_b") if model_split
                                       else ("model",))
        assert tmesh.mesh_shape(m) == dict(zip(axes, shape))
    finally:
        dist.destroy_process_group()


def test_make_mesh_without_a_process_group_raises():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_mesh((2, 2), ("data", "model"), device="cpu")


def test_placements_follow_mesh_order():
    """A spec entry of two axes shards its dim over them in mesh order;
    out of order, or an axis twice, raises (a rank would hold another
    rank's block)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        m = tmesh.make_mesh((2, 2, 2), ("data", "model_a", "model_b"), device="cpu")
        P = tsh.P
        assert tsh.placements(m, P(None, ("model_a", "model_b"))) == (
            Replicate(), Shard(1), Shard(1))
        assert tsh.placements(m, P("data", None)) == (Shard(0), Replicate(), Replicate())
        with pytest.raises(ValueError, match="mesh order"):
            tsh.placements(m, P(("model_b", "model_a")))
        with pytest.raises(ValueError, match="twice"):
            tsh.placements(m, P("data", "data"))
        with pytest.raises(ValueError, match="no axis"):
            tsh.placements(m, P("pod"))
        assert tsh.shard_shape(m, P(("data", "model_a"), None), (8, 3)) == (2, 3)
    finally:
        dist.destroy_process_group()


def test_partition_spec_normalises_as_jax():
    from jax.sharding import PartitionSpec as JP
    for entries in [(("data",), None), (("pod", "data"), "model"), (None,), ()]:
        assert tuple(tsh.P(*entries)) == tuple(JP(*entries)), entries


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_auto_microbatch_over_a_mesh_matches_jax(mesh_name):
    """Every config and shape of ``SHAPES`` at three targets; the factor
    divides the per-shard token count by the data axes' product."""
    jm, tm = meshes(mesh_name)
    seen = set()
    for arch in ARCHS:
        jc, tc = jax_config(arch), torch_config(arch)
        for case_name, case in SHAPES.items():
            for target in (4 << 30, 1 << 30, 64 << 20):
                want = jax_auto_microbatch(jc, JAX_SHAPES[case_name], jm,
                                           target_bytes=target)
                assert auto_microbatch(tc, case, tm, target_bytes=target) == want
                seen.add(want)
    assert len(seen) > 1
    small = dataclasses.replace(SHAPES["train_4k"], global_batch=64)
    assert auto_microbatch(torch_config("qwen3-4b"), small, tm, target_bytes=1) == \
        jax_auto_microbatch(jax_config("qwen3-4b"), small, jm, target_bytes=1)
