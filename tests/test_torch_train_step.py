"""The port's training step against the JAX package's.

Same parameters and optimizer state (JAX's ``init_params`` and
``adamw_init`` carried across by ``repro_torch.convert.state_from_jax``),
same batches (JAX's ``SyntheticLMData``; the port's gives the same bytes,
``test_torch_optim_data.py``), f32 reduced configs. Three steps of
``make_train_step`` (the learning rate is 0 at step 0, and the schedule
reads the step count before the update, so three steps tell an off-by-one
apart) plain, with ``microbatch=2`` and with ``compress_grads=True``, on
qwen3-4b and moonshot-v1-16b-a3b here, jamba-v0.1-52b and whisper-large-v3
in ``test_torch_train_step_hybrid.py`` and ``_cross.py``; then
test_system.py's learning test, 30 steps, through the port.

Tolerances: ``opt.step`` exactly; every leaf of the parameters, the
master weights, m, v and the residual within 1e-5 of that leaf's largest
|value| in JAX's state, plus a floor far below any other leaf's scale:
a gradient that is zero, or all but, in exact arithmetic (a Mamba dt
projection deep in the softplus's flat end) is rounding noise, up to
~1e-14, in each package, which its m (1e-12), v (1e-20) and weights
(1e-10) carry. The keys' bias (``wk.b``: whisper, chatglm3) has a zero
gradient in exact arithmetic (it shifts each query's scores by one
constant, which the softmax ignores), and Adam scales each package's
noise there up to as much as the learning rate: its weights are held to
the sum of the learning rates so far. Every metric within 1e-5 of JAX's,
relative.

With ``compress_grads`` two things differ, both from the int8 rounding
grid and not from the port. An element whose quantised value sits within
the gradients' difference (~1e-7 of the leaf) of a half step rounds the
other way in one of the two: its m, v and weights then differ by a
quantum's worth (about 1 in 10^5 elements here), so at most 1 in 10^4
elements of a state may lie outside the tolerance. And the residual,
the difference of the quantised value and its rounding, is at most half a
quantum, 1/254 of the quantised value's largest |value|, which is the
scale its tolerance takes: 1e-5 of 254 x the leaf's largest |residual|.
``test_compressed_update_matches_jax`` holds the compression and the
update with no such slack, on JAX's own gradients carried across: the
dequantised gradients bit for bit, every state leaf within 1e-5.

The helpers here are shared by the other ``test_torch_train_*`` files.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_config as jax_config
from repro.configs.shapes import ShapeCase as JaxShapeCase
from repro.data import SyntheticLMData as JaxData
from repro.launch import steps as jax_steps
from repro.models import transformer as JT
from repro.optim.adamw import AdamWConfig as JaxAdamW
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.optim.grad_compress import init_residual as jax_init_residual
from repro_torch import convert
from repro_torch.configs import get_config as torch_config
from repro_torch.launch.steps import StepOptions, make_train_step
from repro_torch.models import transformer as TT
from repro_torch.optim.adamw import AdamWConfig

torch.set_num_threads(1)

LOSS_TOL = 1e-5  # the loss, absolute
GRAD_TOL = 1e-4  # a gradient leaf, of its largest |JAX value|, + GRAD_ATOL
GRAD_ATOL = 1e-7
STATE_TOL = 1e-5  # a state leaf, of its largest |JAX value|, + STATE_ATOL
STATE_ATOL = {"params": 1e-10, "master": 1e-10, "m": 1e-12, "v": 1e-20,
              "residual": 1e-12}  # the noise of a gradient that is 0
METRIC_RTOL = 1e-5
MODES = {"plain": {}, "microbatch2": dict(microbatch=2),
         "compress": dict(compress_grads=True)}


def configs(arch, **change):
    """(JAX config, port config), reduced, with ``change`` applied."""
    return (dataclasses.replace(jax_config(arch).reduced(), **change),
            dataclasses.replace(torch_config(arch).reduced(), **change))


@functools.lru_cache(maxsize=None)
def jax_params(arch, seed=0):
    """JAX's parameters of the reduced ``arch`` (remat does not change
    them), as numpy."""
    jc = jax_config(arch).reduced()
    params = jax.jit(functools.partial(JT.init_params, jc))(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, params)


def jax_batch(jc, step, *, B=4, S=16, seed=0):
    """JAX's synthetic batch (numpy) at ``step``."""
    return JaxData(jc, JaxShapeCase("t", "train", S, B), seed=seed).batch_at(step)


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


ROUNDED_OTHER_WAY = 1e-4  # compressed steps: the share of a state's
# elements that may lie outside the tolerance (see the module docstring)
RESIDUAL_SCALE = 254.0  # largest |quantised value| / largest |residual|


ZERO_GRAD = ".wk.b"  # the keys' bias: a zero gradient in exact arithmetic


def assert_leaves_close(tc, got, want_tree, rel, what, atol=0.0, scale=1.0,
                        allowed=0.0, zero_grad_atol=None):
    """Every leaf of the port's dict ``got`` within ``rel`` x ``scale`` of
    the largest |value| of JAX's leaf (+ ``atol``; a ZERO_GRAD leaf +
    ``zero_grad_atol`` if given), but at most an ``allowed`` share of all
    the elements; ``want_tree`` is params-shaped."""
    want = convert.named_from_jax(tc, numpy_tree(want_tree), device="cpu")
    assert list(got) == list(want), what
    outside, total, worst = 0, 0, ""
    for n, w in want.items():
        g = got[n].detach().to(torch.float32)
        w = w.to(torch.float32)
        err = (g - w).abs()
        floor = atol
        if zero_grad_atol is not None and n.endswith(ZERO_GRAD):
            floor = zero_grad_atol
        lim = rel * scale * float(w.abs().max()) + floor
        bad = int((err > lim).sum())
        if bad:
            outside += bad
            worst = f"{n}: max abs diff {float(err.max()):.3g} > {lim:.3g}"
        total += w.numel()
    assert outside <= allowed * total, \
        f"{what}: {outside} of {total} elements outside; {worst}"


def one_device_mesh():
    """JAX's microbatch step constrains its split to a ``data`` axis: a
    one-device mesh with an Auto axis (R1: the Explicit default fails)."""
    return jax.make_mesh((1,), ("data",), axis_types=(AxisType.Auto,))


def loss_and_grads(tc, model, batch):
    """The port's (loss, parts, {name: grad})."""
    loss, parts = TT.loss_fn(tc, model, batch)
    named = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(named.values()))
    return loss, parts, dict(zip(named, grads))


def check_grads(arch, remat, policy="full"):
    """``loss_fn`` and every gradient leaf of the port (with ``remat`` and
    ``policy``) against ``jax.value_and_grad(loss_fn)`` (the same remat),
    on a batch whose labels include one below 0 and one in the vocab
    padding (both masked)."""
    jc, tc = configs(arch, remat=remat, remat_policy=policy)
    tree = jax_params(arch)
    batch = jax_batch(jc, 0, B=2, S=8)
    batch["labels"][0, 0] = -1
    batch["labels"][1, 1] = jc.vocab_size + 3
    (jl, jparts), jg = jax.jit(jax.value_and_grad(
        functools.partial(JT.loss_fn, jc), has_aux=True))(
        jax.tree_util.tree_map(jnp.asarray, tree),
        {k: jnp.asarray(v) for k, v in batch.items()})
    model = convert.params_from_jax(tc, tree, device="cpu", requires_grad=True)
    loss, parts, grads = loss_and_grads(tc, model, to_torch(batch))
    loss = loss.detach()
    assert abs(float(loss) - float(jl)) <= LOSS_TOL, (float(loss), float(jl))
    assert set(parts) == set(jparts)
    for k, v in parts.items():
        assert v.ndim == 0
        assert abs(float(v.detach()) - float(jparts[k])) <= LOSS_TOL, k
    assert_leaves_close(tc, grads, jg, GRAD_TOL, f"{arch} gradient",
                        atol=GRAD_ATOL)


REMATS = [(False, "full"), (True, "full"), (True, "dots")]


def run_steps(arch, mode, n=3, **opt):
    """``n`` steps of JAX's jitted train step and of the port's from the
    same state and batches; after each, the state and metrics compared."""
    kw = MODES[mode]
    jc, tc = configs(arch)
    tree = jax_params(arch)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = {"params": jparams, "opt": jax_adamw_init(jparams)}
    if kw.get("compress_grads"):
        jstate["residual"] = jax_init_residual(jparams)
    state = convert.state_from_jax(tc, numpy_tree(jstate), device="cpu")
    jstep = jax.jit(jax_steps.make_train_step(
        jc, jax_steps.StepOptions(opt=JaxAdamW(**opt), **kw)))
    step = make_train_step(tc, StepOptions(opt=AdamWConfig(**opt), **kw))
    losses, lr_sum = [], 0.0
    for s in range(n):
        batch = jax_batch(jc, s)
        with one_device_mesh():
            jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, to_torch(batch))
        assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == s + 1
        assert state["opt"]["step"].dtype == torch.int32
        assert set(m) == set(jm), (sorted(m), sorted(jm))
        for k, v in m.items():
            want = float(jm[k])
            assert abs(float(v) - want) <= METRIC_RTOL * abs(want), \
                f"step {s} {k}: {float(v)} vs {want}"
        lr_sum += float(jm["lr"])
        check_state(tc, state, jstate, f"{arch} {mode} step {s}",
                    compressed=bool(kw.get("compress_grads")), lr_sum=lr_sum)
        losses.append((float(m["loss"]), float(jm["loss"])))
    return losses


def check_state(tc, state, jstate, what, compressed=False, lr_sum=0.0):
    """The port's train state against JAX's (module docstring): with
    ``compressed``, a share ROUNDED_OTHER_WAY of each state's elements may
    be outside the tolerance; a residual is held at RESIDUAL_SCALE; the
    weights of a ZERO_GRAD leaf to ``lr_sum``."""
    allowed = ROUNDED_OTHER_WAY if compressed else 0.0
    named = dict(state["params"].named_parameters())
    for name, got, want in (("params", named, jstate["params"]),
                            ("master", state["opt"]["master"],
                             jstate["opt"]["master"]),
                            ("m", state["opt"]["m"], jstate["opt"]["m"]),
                            ("v", state["opt"]["v"], jstate["opt"]["v"])):
        assert_leaves_close(
            tc, got, want, STATE_TOL, f"{what} {name}", atol=STATE_ATOL[name],
            allowed=allowed,
            zero_grad_atol=lr_sum if name in ("params", "master") else None)
    if "residual" in jstate:
        assert_leaves_close(tc, state["residual"], jstate["residual"],
                            STATE_TOL, f"{what} residual",
                            atol=STATE_ATOL["residual"],
                            allowed=allowed,
                            scale=RESIDUAL_SCALE if compressed else 1.0)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ["qwen3-4b", "moonshot-v1-16b-a3b"])
def test_train_step_matches_jax(arch, mode):
    run_steps(arch, mode)


@pytest.mark.parametrize("arch", ["qwen3-4b", "moonshot-v1-16b-a3b"])
def test_compressed_update_matches_jax(arch):
    """Three steps of the compressed step's tail on JAX's gradients of
    JAX's state, carried across: ``compress_with_feedback`` (one scale a
    JAX leaf, the stacked layers' tensors together), the schedule and
    ``adamw_update``. The dequantised gradients equal JAX's bit for bit
    (the same int8 values and scales) and every state leaf is within 1e-5
    of its largest |value|."""
    from repro.optim.grad_compress import compress_with_feedback as jax_compress
    from repro.optim.adamw import adamw_update as jax_adamw
    from repro.optim.schedule import cosine_schedule as jax_schedule
    from repro_torch.optim.adamw import adamw_update
    from repro_torch.optim.grad_compress import compress_with_feedback
    from repro_torch.optim.schedule import cosine_schedule
    jc, tc = configs(arch)
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_params(arch))
    jstate = {"params": jparams, "opt": jax_adamw_init(jparams),
              "residual": jax_init_residual(jparams)}
    state = convert.state_from_jax(tc, numpy_tree(jstate), device="cpu")
    grad_fn = jax.jit(jax.grad(lambda p, b: JT.loss_fn(jc, p, b)[0]))

    @jax.jit
    def jax_tail(st, grads):
        deq, res = jax_compress(grads, st["residual"])
        params, opt, _ = jax_adamw(JaxAdamW(), deq, st["opt"], st["params"],
                                   jax_schedule(st["opt"]["step"]))
        return {"params": params, "opt": opt, "residual": res}, deq

    for s in range(3):
        batch = {k: jnp.asarray(v) for k, v in jax_batch(jc, s).items()}
        jgrads = grad_fn(jstate["params"], batch)
        grads = convert.named_from_jax(tc, numpy_tree(jgrads), device="cpu")
        deq, state["residual"] = compress_with_feedback(
            grads, state["residual"], stacks=TT.stacks(tc))
        lr_scale = cosine_schedule(state["opt"]["step"])
        adamw_update(AdamWConfig(), deq, state["opt"], state["params"], lr_scale)
        jstate, jdeq = jax_tail(jstate, jgrads)
        jdeq = convert.named_from_jax(tc, numpy_tree(jdeq), device="cpu")
        for n, d in deq.items():  # the same int8 values times the same scale
            assert torch.equal(d, jdeq[n]), n
        assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == s + 1
        check_state(tc, state, jstate, f"{arch} compressed tail step {s}")


def test_step0_moves_nothing_and_step1_moves():
    """The schedule reads the step before the update: step 0's learning
    rate is 0 (the parameters keep their values), step 1's is not."""
    jc, tc = configs("qwen3-4b")
    state = convert.state_from_jax(tc, numpy_tree(
        {"params": jax_params("qwen3-4b"),
         "opt": jax_adamw_init(jax_params("qwen3-4b"))}), device="cpu")
    step = make_train_step(tc)
    before = {n: p.detach().clone() for n, p in state["params"].named_parameters()}
    state, m = step(state, to_torch(jax_batch(jc, 0)))
    assert float(m["lr"]) == 0.0
    for n, p in state["params"].named_parameters():
        assert torch.equal(p, before[n]), n
    state, m = step(state, to_torch(jax_batch(jc, 1)))
    assert float(m["lr"]) == pytest.approx(3e-4 * 0.01, rel=1e-5)
    assert any(not torch.equal(p, before[n])
               for n, p in state["params"].named_parameters())


def test_microbatch_must_divide_the_batch():
    jc, tc = configs("qwen3-4b")
    state = convert.state_from_jax(tc, numpy_tree(
        {"params": jax_params("qwen3-4b"),
         "opt": jax_adamw_init(jax_params("qwen3-4b"))}), device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(tc, StepOptions(microbatch=3))(
            state, to_torch(jax_batch(jc, 0)))


def test_training_learns_synthetic_structure_like_jax():
    """test_system.py's learning test through the port: 30 steps of
    qwen3-4b reduced (batch 4 x 64, lr 3e-3, no weight decay) from JAX's
    parameters; every loss within 1e-4 of JAX's, and the last five below
    the first five by 0.1."""
    jc, tc = configs("qwen3-4b")
    case = JaxShapeCase("t", "train", 64, 4)
    data = JaxData(jc, case, seed=0)
    opt = dict(lr=3e-3, weight_decay=0.0)
    jparams = jax.tree_util.tree_map(jnp.asarray, jax_params("qwen3-4b"))
    jstate = {"params": jparams, "opt": jax_adamw_init(jparams)}
    state = convert.state_from_jax(tc, numpy_tree(jstate), device="cpu")
    jstep = jax.jit(jax_steps.make_train_step(
        jc, jax_steps.StepOptions(opt=JaxAdamW(**opt))))
    step = make_train_step(tc, StepOptions(opt=AdamWConfig(**opt)))
    losses, jlosses = [], []
    for s in range(30):
        batch = data.batch_at(s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, to_torch(batch))
        losses.append(float(m["loss"]))
        jlosses.append(float(jm["loss"]))
    assert np.isfinite(losses).all()
    np.testing.assert_allclose(losses, jlosses, rtol=0, atol=1e-4)
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.1, losses
