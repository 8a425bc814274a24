"""The port's optimizer, gradient compression, schedule, data pipeline and
``auto_microbatch`` against the JAX package's, on the same numpy inputs.

``cosine_schedule`` at every step of a range equals JAX's (jitted, as its
train step runs it) within 2.4e-7 (XLA's f32 cosine and torch's differ by
an ulp, which the schedule's 0.45 x (1 + cos) carries: up to 2 ulps of a
value below 1); ``adamw_update`` on JAX's quadratic and clip-metric cases
(tests/test_optim_data.py) gives JAX's update within 1e-6 of each leaf's
largest |value| at every step of JAX's trajectory; ``quantize_int8`` and
``compress_with_feedback`` give JAX's int8 values exactly (one scale a
stacked leaf); ``SyntheticLMData`` gives JAX's batches byte for byte for a
text, a vision and an audio config, ``make_pipeline`` the same steps in
order; ``auto_microbatch`` equals JAX's on a one-device mesh (Auto axes,
R1) for every config and train shape.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as jax_config
from repro.configs import registry as jax_registry
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.configs.shapes import ShapeCase as JaxShapeCase
from repro.data import SyntheticLMData as JaxData
from repro.data import make_pipeline as jax_pipeline
from repro.launch.steps import auto_microbatch as jax_auto_microbatch
from repro.optim import adamw as jax_adamw
from repro.optim import grad_compress as jax_gc
from repro.optim.schedule import cosine_schedule as jax_schedule
from repro.testing.hypothesis_compat import given, settings, strategies as st
from repro_torch.configs import get_config as torch_config
from repro_torch.configs.shapes import SHAPES, ShapeCase
from repro_torch.data import SyntheticLMData, make_pipeline
from repro_torch.launch.steps import auto_microbatch
from repro_torch.optim import adamw, grad_compress
from repro_torch.optim.schedule import cosine_schedule

torch.set_num_threads(1)


# -- schedule ---------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(warmup=10, total=100), {},
                                dict(warmup=0, total=50, min_ratio=0.0)])
def test_cosine_schedule_matches_jax(kw):
    steps = np.array([0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 101, 1000, 5055,
                      9999, 10000, 20000], np.int32)
    want = np.asarray(jax.jit(jax.vmap(lambda s: jax_schedule(s, **kw)))(
        jnp.asarray(steps)))
    got = np.array([float(cosine_schedule(torch.tensor(int(s), dtype=torch.int32),
                                          **kw)) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    assert got[0] == want[0] == 0.0


# -- AdamW --------------------------------------------------------------------------

def test_adamw_quadratic_matches_jax():
    """JAX's quadratic case, 200 steps at lr 0.1, no weight decay. At every
    step of JAX's trajectory the port's update from JAX's state and
    gradient gives JAX's weights, master, m and v within 1e-6 of each
    one's largest |value| (a few ulps: XLA contracts the moment updates
    into FMAs, torch rounds each product), and the gradient norm; the port's own 200 steps end
    within 1e-2 of the target, as JAX's do. (Two trajectories are not
    compared step by step: near the optimum Adam's normalised steps
    amplify an ulp into ~1e-6 a few dozen steps later.)"""
    target = np.array([1.0, -2.0, 3.0], np.float32)
    jparams = {"w": jnp.zeros(3)}
    jstate = jax_adamw.adamw_init(jparams)
    jcfg = jax_adamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    jupdate = jax.jit(jax_adamw.adamw_update, static_argnums=0)
    cfg = adamw.AdamWConfig(lr=0.1, weight_decay=0.0)
    own = {"w": torch.zeros(3)}
    own_state = adamw.adamw_init(own)
    for _ in range(200):
        state = jax.tree_util.tree_map(lambda x: torch.from_numpy(np.array(x)), jstate)
        params = {"w": torch.from_numpy(np.array(jparams["w"]))}
        jg = {"w": 2 * (jstate["master"]["w"] - target)}
        jparams, jstate, jm = jupdate(jcfg, jg, jstate, jparams)
        params, state, m = adamw.adamw_update(
            cfg, {"w": torch.from_numpy(np.array(jg["w"]))}, state, params)
        for got, want in ((params["w"], jparams["w"]),
                          (state["master"]["w"], jstate["master"]["w"]),
                          (state["m"]["w"], jstate["m"]["w"]),
                          (state["v"]["w"], jstate["v"]["w"])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=1e-6 * np.abs(want).max() + 1e-12)
        assert int(state["step"]) == int(jstate["step"])
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
        g = {"w": 2 * (own_state["master"]["w"] - torch.from_numpy(target))}
        own, own_state, _ = adamw.adamw_update(cfg, g, own_state, own)
    assert int(jstate["step"]) == int(own_state["step"]) == 200
    np.testing.assert_allclose(own["w"].numpy(), target, atol=1e-2)
    np.testing.assert_allclose(np.asarray(jparams["w"]), target, atol=1e-2)


def test_adamw_grad_clip_metric_matches_jax():
    jparams = {"w": jnp.zeros(4)}
    _, jstate, jm = jax_adamw.adamw_update(
        jax_adamw.AdamWConfig(), {"w": jnp.full((4,), 100.0)},
        jax_adamw.adamw_init(jparams), jparams)
    params = {"w": torch.zeros(4)}
    _, state, m = adamw.adamw_update(adamw.AdamWConfig(), {"w": torch.full((4,), 100.0)},
                                     adamw.adamw_init(params), params)
    assert float(m["grad_norm"]) == pytest.approx(200.0, rel=1e-5)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-6)
    np.testing.assert_allclose(state["master"]["w"].numpy(),
                               np.asarray(jstate["master"]["w"]), rtol=1e-6)


def test_adamw_bf16_params_recast_from_master():
    """A bf16 parameter takes its f32 master's value rounded (JAX's
    ``astype``), and the state stays f32."""
    params = {"w": torch.tensor([0.1, -0.2, 0.3], dtype=torch.bfloat16)}
    state = adamw.adamw_init(params)
    assert all(state[k]["w"].dtype == torch.float32 for k in ("master", "m", "v"))
    grads = {"w": torch.tensor([1.0, -1.0, 0.5], dtype=torch.bfloat16)}
    params, state, _ = adamw.adamw_update(adamw.AdamWConfig(lr=1e-2), grads, state,
                                          params)
    assert params["w"].dtype == torch.bfloat16
    assert torch.equal(params["w"], state["master"]["w"].to(torch.bfloat16))


# -- int8 compression ---------------------------------------------------------------

@settings(max_examples=100, deadline=None)
@given(st.lists(st.floats(-1e3, 1e3, allow_nan=False), min_size=1, max_size=64))
def test_int8_quantisation_matches_jax(vals):
    """The same int8 values and scale as JAX's jitted ``quantize_int8``
    (its quotient by 127 compiled to a multiply), within the half-step
    error bound."""
    x = np.asarray(vals, np.float32)
    jq, js = jax.jit(jax_gc.quantize_int8)(jnp.asarray(x))
    q, s = grad_compress.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    err = np.abs(grad_compress.dequantize_int8(q, s).numpy() - x)
    assert err.max() <= float(s) * 0.5 + 1e-6


def test_error_feedback_matches_jax_on_stacked_leaves():
    """50 steps of ``compress_with_feedback`` on JAX's stacked leaf [3, 16]
    and a plain one against the port's three tensors of a stack and the
    plain one: the dequantised gradients bit for bit (equal int8 values
    and scales: the stack shares one), the residuals within 1e-7 of their
    largest |value|, and the delivered mass conserved."""
    rng = np.random.default_rng(0)
    stacks = ("groups.",)
    jres = {"groups": {"w": jnp.zeros((3, 16))}, "head": jnp.zeros(5)}
    res = {f"groups.{i}.w": torch.zeros(16) for i in range(3)}
    res["head"] = torch.zeros(5)
    delivered, true = np.zeros((3, 16)), np.zeros((3, 16))
    jfn = jax.jit(jax_gc.compress_with_feedback)
    for _ in range(50):
        gw = (rng.standard_normal((3, 16)) * [[1.0], [10.0], [0.1]]).astype(np.float32)
        gh = rng.standard_normal(5).astype(np.float32)
        jdeq, jres = jfn({"groups": {"w": jnp.asarray(gw)}, "head": jnp.asarray(gh)},
                         jres)
        grads = {f"groups.{i}.w": torch.from_numpy(gw[i]) for i in range(3)}
        grads["head"] = torch.from_numpy(gh)
        deq, res = grad_compress.compress_with_feedback(grads, res, stacks=stacks)
        for i in range(3):
            np.testing.assert_array_equal(deq[f"groups.{i}.w"].numpy(),
                                          np.asarray(jdeq["groups"]["w"][i]))
            r, jr = res[f"groups.{i}.w"].numpy(), np.asarray(jres["groups"]["w"][i])
            np.testing.assert_allclose(r, jr, rtol=0,
                                       atol=1e-7 * np.abs(jr).max() + 1e-12)
        np.testing.assert_array_equal(deq["head"].numpy(), np.asarray(jdeq["head"]))
        delivered += np.stack([deq[f"groups.{i}.w"].numpy() for i in range(3)])
        true += gw
    final = np.stack([res[f"groups.{i}.w"].numpy() for i in range(3)])
    np.testing.assert_allclose(delivered + final, true, atol=1e-4)


def test_init_residual_is_f32_zeros():
    res = grad_compress.init_residual({"a": torch.ones(2, 3, dtype=torch.bfloat16)})
    assert res["a"].dtype == torch.float32 and not res["a"].any()


# -- data --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-4b", "llama-3.2-vision-90b",
                                  "whisper-large-v3"])
def test_synthetic_batches_are_jax_bytes(arch):
    """Text, vision (media [B, num_media_tokens, D]) and audio (frames [B,
    S, D]): every array of several steps and host slices is JAX's, byte
    for byte."""
    jc, tc = jax_config(arch).reduced(), torch_config(arch).reduced()
    jd = JaxData(jc, JaxShapeCase("t", "train", 24, 4), seed=3)
    d = SyntheticLMData(tc, ShapeCase("t", "train", 24, 4), seed=3)
    for step in (0, 1, 7):
        got, want = d.batch_at(step), jd.batch_at(step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
            assert got[k].tobytes() == want[k].tobytes(), (step, k)
        for h in range(2):
            got, want = d.host_slice(step, h, 2), jd.host_slice(step, h, 2)
            for k in want:
                assert got[k].tobytes() == want[k].tobytes(), (step, h, k)
    if tc.frontend == "none":
        assert "media" not in d.batch_at(0)


def test_pipeline_prefetch_order_matches_jax():
    jc, tc = jax_config("qwen3-4b").reduced(), torch_config("qwen3-4b").reduced()
    d = SyntheticLMData(tc, ShapeCase("t", "train", 16, 2))
    jd = JaxData(jc, JaxShapeCase("t", "train", 16, 2))
    got = list(make_pipeline(d, 3, stop_step=8, prefetch=2))
    want = list(jax_pipeline(jd, 3, stop_step=8, prefetch=2))
    assert [s for s, _ in got] == [s for s, _ in want] == [3, 4, 5, 6, 7]
    for (_, a), (_, b) in zip(got, want):
        assert a["tokens"].tobytes() == b["tokens"].tobytes()


def test_pipeline_surfaces_a_producer_failure():
    class Broken(SyntheticLMData):
        def batch_at(self, step):
            if step == 2:
                raise ValueError("boom")
            return super().batch_at(step)

    d = Broken(torch_config("qwen3-4b").reduced(), ShapeCase("t", "train", 8, 1))
    it = make_pipeline(d, 0, stop_step=5)
    assert next(it)[0] == 0 and next(it)[0] == 1
    with pytest.raises(RuntimeError, match="data producer failed"):
        next(it)


# -- auto_microbatch -------------------------------------------------------------

def test_auto_microbatch_matches_jax_on_one_device():
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    seen = set()
    for name in jax_registry():
        for case_name, case in SHAPES.items():
            jc, tc = jax_config(name), torch_config(name)
            for target in (4 << 30, 1 << 30, 64 << 20):
                want = jax_auto_microbatch(jc, JAX_SHAPES[case_name], mesh,
                                           target_bytes=target)
                got = auto_microbatch(tc, case, target_bytes=target)
                assert got == want, (name, case_name, target)
                seen.add(got)
    assert len(seen) > 2  # the cases reach several factors
    small = dataclasses.replace(SHAPES["train_4k"], global_batch=2)
    assert auto_microbatch(torch_config("qwen3-4b"), small, target_bytes=1) == 2


def test_auto_microbatch_over_a_mesh_matches_jax():
    """Over a (data=4, model=2) mesh the per-shard tokens are a quarter:
    every config and shape of ``SHAPES`` at three targets equals JAX's
    (JAX's on an AbstractMesh, R1); a (1, 1) mesh equals no mesh."""
    from jax.sharding import AbstractMesh as JaxAbstractMesh

    from repro_torch.launch.mesh import AbstractMesh
    jm, tm = JaxAbstractMesh((4, 2), ("data", "model")), AbstractMesh((4, 2),
                                                                      ("data", "model"))
    one = AbstractMesh((1, 1), ("data", "model"))
    for name in jax_registry():
        for case_name, case in SHAPES.items():
            jc, tc = jax_config(name), torch_config(name)
            for target in (4 << 30, 1 << 30, 64 << 20):
                want = jax_auto_microbatch(jc, JAX_SHAPES[case_name], jm,
                                           target_bytes=target)
                assert auto_microbatch(tc, case, tm, target_bytes=target) == want
                assert (auto_microbatch(tc, case, one, target_bytes=target)
                        == auto_microbatch(tc, case, target_bytes=target))
