"""The port's ``configs/shapes.py`` against the JAX package's: for all ten
configs and all four shapes, the step operands (``batch_specs``), the
decode cache (``cache_specs``), the skip reasons (``applicable``) and, per
config, the parameter pytree (``param_specs``), each equal in layout,
shape and dtype. JAX's specs come from ``jax.eval_shape``, the port's are
``meta`` tensors: nothing is allocated on either side."""

import math

import jax
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.configs import shapes as JS
from repro_torch.configs import registry as torch_registry
from repro_torch.configs import shapes as TS

ARCHS = sorted(jax_registry())


def _flat(tree):
    """{dotted path: (shape, dtype name)} of a JAX pytree of specs."""
    return {".".join(str(getattr(k, "key", k)) for k in path):
            (tuple(leaf.shape), str(leaf.dtype))
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(tree, prefix=""):
    """The same of the port's nested dict of meta tensors."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flat_port(v, name))
        else:
            assert v.device.type == "meta", name
            out[name] = (tuple(v.shape), str(v.dtype).removeprefix("torch."))
    return out


def test_shape_cases_equal_jax():
    assert list(TS.SHAPES) == list(JS.SHAPES)
    for name, case in JS.SHAPES.items():
        t = TS.SHAPES[name]
        assert (t.name, t.kind, t.seq_len, t.global_batch) == (
            case.name, case.kind, case.seq_len, case.global_batch)


@pytest.mark.parametrize("shape", list(JS.SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_cache_specs_equal_jax(arch, shape):
    jc, tc = jax_registry()[arch], torch_registry()[arch]
    jcase, tcase = JS.SHAPES[shape], TS.SHAPES[shape]
    assert TS.applicable(tc, tcase) == JS.applicable(jc, jcase)
    assert _flat_port(TS.batch_specs(tc, tcase)) == _flat(JS.batch_specs(jc, jcase))
    assert _flat_port(TS.cache_specs(tc, tcase)) == _flat(JS.cache_specs(jc, jcase))


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax(arch):
    """The nested layout, the stacked [num_groups, ...] and
    [encoder_layers, ...] shapes and every dtype."""
    jc, tc = jax_registry()[arch], torch_registry()[arch]
    got = TS.param_specs(tc)
    assert _flat_port(got) == _flat(JS.param_specs(jc))
    assert sum(math.prod(shape) for shape, _ in _flat_port(got).values()) == \
        tc.param_count()


def test_batch_specs_take_the_media_dtype():
    arch = "llama-3.2-vision-90b"
    tc, jc = torch_registry()[arch], jax_registry()[arch]
    got = TS.batch_specs(tc, TS.SHAPES["prefill_32k"], dtype=torch.float32)["media"]
    want = JS.batch_specs(jc, JS.SHAPES["prefill_32k"],
                          dtype=jax.numpy.float32)["media"]
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), torch.float32)
