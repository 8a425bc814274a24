"""The port's kernel routing (``repro_torch.kernels.policy`` and
``kernels.ops._route``) against the JAX package's, on the CPU.

Mirrors the policy half of tests/test_tuned.py: the canonical form of the
overrides, validation, hashing, ``coerce`` / ``with_backend``, the
``resolve_policy`` shim and its ``DeprecationWarning``, the precedence of
explicit keyword < tuned choice < overrides, and the grid arm. The port's
rungs are ``torch`` / ``cuda`` / ``tuned`` where JAX has ``jnp`` /
``pallas`` / ``tuned``; JAX's ``interpret`` flag has no counterpart (the
device decides). Outputs are compared exactly.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.policy import KERNEL_NAMES as J_KERNEL_NAMES
from repro.kernels.policy import KernelPolicy as JKernelPolicy
from repro.workloads import FrameProblem as JFrameProblem
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.policy import (CUDA_POLICY, DEFAULT_POLICY,
                                        KERNEL_NAMES, TORCH_POLICY,
                                        TUNED_POLICY, Backend, KernelPolicy,
                                        resolve_policy)
from repro_torch.workloads import FrameProblem, exhaustive, get_workload

torch.set_num_threads(1)

OVERRIDES = [
    {},
    {"dwell": {"block": (16, 16), "unroll": 8}},
    {"dwell": {"unroll": 4, "block": [8, 32]},
     "perimeter_query": {"unroll": 16}},
    {"region_dwell_pooled": {"unroll": 4}, "olt_compact": {"block": 4096},
     "region_fill": {"scheme": "mbr", "tile": 16}},
    (("region_dwell", (("unroll", 8),)),),
]


@pytest.fixture(autouse=True)
def _fresh_memo():
    """choose() memoises per (cache, key); tests must not see each other."""
    autotune.clear_memo()
    yield
    autotune.clear_memo()


def test_kernel_names_equal_jax():
    assert KERNEL_NAMES == J_KERNEL_NAMES


@pytest.mark.parametrize("overrides", OVERRIDES, ids=range(len(OVERRIDES)))
def test_canonical_overrides_equal_jax(overrides):
    got = KernelPolicy(overrides=overrides)
    want = JKernelPolicy(overrides=overrides)
    assert got.overrides == want.overrides
    for kernel in KERNEL_NAMES:
        assert got.override_for(kernel) == want.override_for(kernel)
    # canonical input is a fixed point, as in JAX
    assert KernelPolicy(overrides=got.overrides) == got


def test_policy_is_frozen_and_hashable():
    a = KernelPolicy(backend="tuned",
                     overrides={"dwell": {"block": (8, 32), "unroll": 4}})
    b = KernelPolicy(backend="tuned",
                     overrides={"dwell": {"unroll": 4, "block": [8, 32]}})
    assert a == b and hash(a) == hash(b)  # order/list-vs-tuple insensitive
    assert a.override_for("dwell") == {"block": (8, 32), "unroll": 4}
    assert a.override_for("olt_compact") == {}
    assert len({a, b, TUNED_POLICY, CUDA_POLICY}) == 3
    with pytest.raises(dataclasses.FrozenInstanceError):
        a.backend = Backend.TORCH


def test_policy_validates_inputs():
    for bad in ("pallas", "jnp", "triton"):  # the port's rungs only
        with pytest.raises(ValueError, match="backend"):
            KernelPolicy(backend=bad)
    with pytest.raises(ValueError):
        KernelPolicy(overrides={"not_a_kernel": {"unroll": 2}})
    with pytest.raises(TypeError):
        KernelPolicy(overrides={"dwell": 3})
    with pytest.raises(TypeError):
        KernelPolicy(overrides=[("dwell", 3)])
    # the same inputs fail the same way in JAX
    with pytest.raises(ValueError):
        JKernelPolicy(overrides={"not_a_kernel": {"unroll": 2}})
    with pytest.raises(TypeError):
        JKernelPolicy(overrides={"dwell": 3})


def test_policy_rungs_and_defaults():
    assert [b.value for b in Backend] == ["torch", "cuda", "tuned"]
    assert str(Backend.TUNED) == "tuned"
    assert DEFAULT_POLICY == CUDA_POLICY and DEFAULT_POLICY.backend is Backend.CUDA
    assert TORCH_POLICY.backend is Backend.TORCH
    assert TUNED_POLICY.backend is Backend.TUNED
    # no interpret flag: the device of the tensors decides
    assert "interpret" not in {f.name for f in dataclasses.fields(KernelPolicy)}
    assert "interpret" in {f.name for f in dataclasses.fields(JKernelPolicy)}
    assert KernelPolicy(tuning_cache=123).tuning_cache == "123"


def test_policy_with_backend_and_coerce():
    pol = CUDA_POLICY.with_backend("tuned")
    assert pol.backend is Backend.TUNED
    assert CUDA_POLICY.backend is Backend.CUDA  # original untouched
    assert KernelPolicy.coerce("torch") == TORCH_POLICY
    assert KernelPolicy.coerce(Backend.TUNED) == TUNED_POLICY
    assert KernelPolicy.coerce(pol) is pol


def test_resolve_policy_shim_warns_and_maps():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        pol = resolve_policy("torch", None)
    assert pol.backend is Backend.TORCH
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert resolve_policy(None, None) == DEFAULT_POLICY
        assert resolve_policy(None, "tuned") == TUNED_POLICY
    assert not caught


def test_resolve_policy_rejects_both():
    with pytest.raises(ValueError, match="not both"):
        resolve_policy("torch", TORCH_POLICY)


@pytest.mark.parametrize("workload", ["mandelbrot", "julia", "burning_ship",
                                      "multibrot"])
def test_ops_legacy_backend_kwarg_still_works(workload):
    """The deprecated string keyword gives the same image as ``policy=``,
    JAX's plain version's on every rung."""
    tw = get_workload(workload)
    b = tw.default_bounds
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        legacy = ops.mandelbrot(32, bounds=b, max_dwell=16, workload=tw,
                                backend="torch", device="cpu")
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    from repro.workloads import registry as jreg
    want = np.asarray(jref.mandelbrot_ref(32, b, 16,
                                          workload=jreg.get_workload(workload)))
    for pol in (TORCH_POLICY, CUDA_POLICY, TUNED_POLICY):
        new = ops.mandelbrot(32, bounds=b, max_dwell=16, workload=tw,
                             policy=pol, device="cpu")
        np.testing.assert_array_equal(new.numpy(), legacy.numpy())
    np.testing.assert_array_equal(legacy.numpy(), want)


def test_exhaustive_legacy_backend_warns_once_at_the_caller():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        canvas, st = exhaustive(32, max_dwell=16, backend="torch",
                                device="cpu")
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1 and dep[0].filename == __file__
    assert st.kernel_launches == 1 and canvas.shape == (32, 32)


def test_route_rungs_on_the_cpu():
    sig = dict(n=64, max_dwell=32)
    assert ops._route(TORCH_POLICY, "dwell", device="cpu", **sig) == ("torch", {})
    assert ops._route(CUDA_POLICY, "dwell", device="cpu", **sig) == ("cuda", {})
    # tuned on the CPU: the heuristic names the plain version
    assert ops._route(TUNED_POLICY, "dwell", device="cpu", **sig) == ("torch", {})
    pol = KernelPolicy(overrides={"dwell": {"unroll": 4, "block": (8, 32)}})
    assert ops._route(pol, "dwell", device="cpu", **sig) == (
        "cuda", {"unroll": 4, "block": (8, 32)})


def test_policy_overrides_beat_tuned_choice(tmp_path):
    """Precedence: policy.overrides > cache entry > explicit keyword."""
    cache = autotune.TuningCache()
    cache.put(autotune.cache_key("dwell", n=64, max_dwell=32, device="cpu"),
              autotune.Choice("cuda", (("unroll", 4),), us=1.0))
    path = tmp_path / "tc.json"
    cache.save(str(path))
    pol = KernelPolicy(backend="tuned", tuning_cache=str(path),
                       overrides={"dwell": {"unroll": 8}})
    impl, params = ops._route(pol, "dwell", device="cpu", n=64, max_dwell=32)
    assert impl == "cuda" and params == {"unroll": 8}
    impl, params = ops._route(KernelPolicy(backend="tuned",
                                           tuning_cache=str(path)),
                              "dwell", device="cpu", n=64, max_dwell=32)
    assert impl == "cuda" and params == {"unroll": 4}


def test_region_fill_override_reaches_the_wrapper(monkeypatch):
    """The schedule params of the fill's route (a policy override here)
    reach the kernel module's wrapper, and the defaults stay otherwise."""
    from repro_torch.kernels import region_fill
    seen = {}

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return region_fill.region_fill(*args, **kwargs)

    monkeypatch.setattr(ops, "_region_fill", spy)
    n, side = 64, 32
    canvas = torch.zeros((n, n), dtype=torch.int32)
    coords = torch.zeros((4, 2), dtype=torch.int32)
    values = torch.ones((4,), dtype=torch.int32)
    count = torch.tensor([1], dtype=torch.int32)
    pol = KernelPolicy(overrides={"region_fill": {"scheme": "mbr", "tile": 16}})
    ops.region_fill(canvas, coords, values, count, side=side, n=n, policy=pol)
    assert seen["tile"] == 16 and seen["scheme"] == "mbr"
    seen.clear()
    ops.region_fill(canvas, coords, values, count, side=side, n=n)
    assert seen["tile"] == 256 and seen["scheme"] == "sbr"  # defaults kept
    assert int(canvas[:side, :side].min()) == 1


def test_grid_workload_always_routes_torch():
    ssd = get_workload("ssd_synth")
    assert autotune.heuristic("dwell", workload=ssd, device="cpu").impl == "torch"
    for pol in (TORCH_POLICY, CUDA_POLICY, TUNED_POLICY):
        for kernel in ("dwell", "perimeter_query", "region_dwell",
                       "region_dwell_pooled"):
            impl, _ = ops._route(pol, kernel, workload=ssd, device="cpu",
                                 n=64, max_dwell=32)
            assert impl == "torch"
    # an override still reaches the grid arm's params, as in JAX
    pol = KernelPolicy(overrides={"dwell": {"unroll": 4}})
    assert ops._route(pol, "dwell", workload=ssd, device="cpu", n=64,
                      max_dwell=32) == ("torch", {"unroll": 4})


def test_frame_problem_policy_field_sync():
    kw = dict(n=64, g=2, B=16, max_dwell=16)
    p = FrameProblem(**kw, backend="torch", device="cpu")
    assert p.policy == TORCH_POLICY and p.backend == "torch"
    q = FrameProblem(**kw, backend="cuda", policy=KernelPolicy(backend="tuned"),
                     device="cpu")
    assert q.backend == "tuned"  # policy wins, backend field re-synced
    r = dataclasses.replace(p, policy=p.policy.with_backend("tuned"))
    assert r.backend == "tuned" and r != p
    assert r.graph_key() != p.graph_key()  # distinct CUDA graphs
    d = FrameProblem(**kw, device="cpu")
    assert d.policy == DEFAULT_POLICY and d.backend == "cuda"
    # the same reconciliation in JAX
    jq = JFrameProblem(**kw, backend="pallas", policy=JKernelPolicy(backend="tuned"))
    assert jq.backend == "tuned"
    with pytest.raises(ValueError, match="backend"):
        FrameProblem(**kw, backend="pallas", device="cpu")


@pytest.mark.parametrize("backend", ["torch", "cuda", "tuned"])
def test_every_rung_runs_every_engine_alike(backend):
    """On the CPU every rung is the plain path: each engine gives the same
    canvas under each policy."""
    from repro_torch.workloads import solve
    kw = dict(n=128, g=4, r=2, B=16, max_dwell=32, device="cpu")
    base = FrameProblem(**kw)
    p = FrameProblem(**kw, backend=backend)
    for m in ("ex", "ask", "ask_fused", "ask_scan", "ask_tuned", "dp"):
        kw = {"safety_factor": 1e9} if m in ("ask_scan", "ask_tuned") else {}
        assert torch.equal(solve(p, m, **kw)[0], solve(base, m, **kw)[0]), m
