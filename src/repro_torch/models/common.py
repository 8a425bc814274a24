"""Shared model components: norms, projections, MLPs, position encodings.

Counterpart of ``repro/models/common.py``. Parameters live in
``nn.Module`` containers whose attribute names are the JAX package's
pytree keys (``Linear.w``/``.b``, ``Norm.w``/``.b``, ``MLP.up``/``.down``/
``.gate``), so a parameter's dotted name is its JAX path. The functions
(``linear``, ``rmsnorm``, ``mlp_apply``, ...) compute with them as the JAX
functions compute with the dicts, intermediate dtypes included.

Parameters are created by an ``Init``: on its device, one tensor at a
time, in the dtype asked for. Each is a ``Leaf`` (how it is made: dense,
full or rows, and its index in the order of creation), and a dense leaf
is drawn from a generator of its own, seeded from (seed, index) and
from nothing drawn before it (``make_leaf``; truncated normal at 0.02 as
JAX's ``dense_init``; the numbers differ from JAX's, whose keys torch
cannot reproduce: ``convert.params_from_jax`` carries JAX's parameters
across). So a leaf can be made alone, with the values it has in the
whole model, which is how the sharded steps' per-shard init makes each
rank's block (``launch/steps.py``). On the ``meta`` device nothing is
allocated. Parameters require grad only when the ``Init`` is made with
``requires_grad=True`` (a model built to train: ``launch.train``,
``convert.state_from_jax``); serving runs under ``torch.no_grad()``
either way.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Init", "Leaf", "make_leaf", "leaf_seed", "resolve_device", "Linear", "Norm", "MLP", "linear", "gelu",
           "rmsnorm", "layernorm", "norm_apply", "mlp_apply", "rope_angles",
           "apply_rope", "sinusoidal_pos", "sinusoidal_at", "f32", "CacheSlot",
           "seq_block"]

_TRUNC = 2.0  # JAX's truncated_normal(-2, 2)
_SCALE = 0.02


class CacheSlot(dict):
    """One slot's cache leaves as a sharded step hands them to its mixer:
    ``seq`` names the model axes whose ranks split the attention or MLA
    leaves' sequence dim (dim 1) in blocks, the rank holding block
    ``collectives.axis_index(seq)``; () when the dim is whole. A plain
    dict is a slot with ``seq`` () (``seq_block``)."""

    seq: tuple = ()


def seq_block(cache) -> tuple:
    """(axes, n): the model axes that split ``cache``'s sequence dim (a
    ``CacheSlot``'s ``seq``; () for a plain dict) and the positions of
    the rank's block."""
    return getattr(cache, "seq", ()), next(iter(cache.values())).shape[1]


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; CUDA with no card raises (the entry
    points run on the card unless the caller passes ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' for the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}: use 'cuda', 'cpu' or 'meta'")
    return dev


@dataclasses.dataclass(frozen=True, eq=False)
class Leaf:
    """How one parameter is made: ``kind`` "dense" (0.02 * truncated
    normal(-2, 2), drawn in f32, then cast), "full" (every element
    ``value``) or "rows" (every row ``row``, a CPU tensor); ``index``: its
    place in the order of creation, which keys a dense leaf's generator."""

    kind: str
    shape: tuple
    dtype: torch.dtype
    index: int
    value: float = 0.0
    row: Optional[torch.Tensor] = None

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def leaf_seed(seed: int, index: int) -> int:
    """The seed of leaf ``index``'s generator: a hash of (seed, index)
    (numpy's ``SeedSequence``), below 2^63."""
    state = np.random.SeedSequence((seed, index)).generate_state(1, np.uint64)
    return int(state[0]) >> 1


def make_leaf(leaf: Leaf, seed: int, device) -> torch.Tensor:
    """The whole leaf on ``device`` (not ``meta``): a dense leaf from its
    own generator (``leaf_seed``), on the device's generator type, so one
    device type gives one set of values."""
    device = torch.device(device)
    if leaf.kind == "dense":
        gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, leaf.index))
        t = torch.empty(leaf.shape, dtype=torch.float32, device=device)
        lo = math.erf(-_TRUNC / math.sqrt(2.0))
        t.uniform_(lo, -lo, generator=gen)
        t.erfinv_().mul_(math.sqrt(2.0)).clamp_(-_TRUNC, _TRUNC).mul_(_SCALE)
        return t.to(leaf.dtype)
    t = torch.empty(leaf.shape, dtype=leaf.dtype, device=device)
    if leaf.kind == "full":
        return t.fill_(leaf.value)
    return t.copy_(leaf.row.to(leaf.dtype).expand(leaf.shape[0], -1))


class Init:
    """Creates parameters on ``device``, one tensor at a time, leaf i
    from its own generator seeded from (``seed``, i) (``make_leaf``);
    they require grad if ``requires_grad``. ``leaves``: (parameter,
    ``Leaf``) of each, in order."""

    def __init__(self, device="cuda", seed: int = 0, requires_grad: bool = False):
        self.device = resolve_device(device)
        self.seed = seed
        self.requires_grad = requires_grad
        self.leaves = []

    def _param(self, kind: str, shape, dtype, **kw) -> nn.Parameter:
        leaf = Leaf(kind, tuple(shape), dtype, len(self.leaves), **kw)
        if self.device.type == "meta":
            t = torch.empty(leaf.shape, dtype=dtype, device=self.device)
        else:
            t = make_leaf(leaf, self.seed, self.device)
        p = nn.Parameter(t, requires_grad=self.requires_grad)
        self.leaves.append((p, leaf))
        return p

    def dense(self, shape, dtype) -> nn.Parameter:
        """0.02 * truncated_normal(-2, 2), drawn in f32, then cast."""
        return self._param("dense", shape, dtype)

    def full(self, shape, value: float, dtype) -> nn.Parameter:
        return self._param("full", shape, dtype, value=value)

    def rows(self, row: torch.Tensor, n: int, dtype) -> nn.Parameter:
        """[n, len(row)]: every row is ``row`` (a CPU tensor), in ``dtype``."""
        return self._param("rows", (n, row.shape[0]), dtype, row=row)


def f32(value: float, device) -> torch.Tensor:
    """``value`` as a 0-dim f32 tensor on ``device``: JAX's weakly typed
    scalar. Dividing by it is a true division on every device (a Python
    float divisor on the card is a multiply by its reciprocal), and, being
    0-dim, it leaves a bf16 operand's result in bf16."""
    return torch.tensor(value, dtype=torch.float32, device=device)


class Linear(nn.Module):
    """``w`` [d_in, d_out] (JAX's layout: ``x @ w``), optional ``b``."""

    def __init__(self, init: Init, d_in: int, d_out: int, *, bias: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.w = init.dense((d_in, d_out), dtype)
        if bias:
            self.b = init.full((d_out,), 0.0, dtype)
        else:
            self.b = None


def linear(p: Linear, x: torch.Tensor) -> torch.Tensor:
    y = x @ p.w
    if p.b is not None:
        y = y + p.b
    return y


class Norm(nn.Module):
    """RMSNorm (``w``) or LayerNorm (``w``, ``b``)."""

    def __init__(self, init: Init, kind: str, d: int, dtype=torch.float32):
        super().__init__()
        if kind not in ("rmsnorm", "layernorm"):
            raise ValueError(f"unknown norm {kind!r}")
        self.kind = kind
        self.w = init.full((d,), 1.0, dtype)
        self.b = init.full((d,), 0.0, dtype) if kind == "layernorm" else None


def rmsnorm(p: Norm, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    xf = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * p.w.float()).to(dt)


def layernorm(p: Norm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * p.w.float() + p.b.float()).to(dt)


def norm_apply(p: Norm, x: torch.Tensor) -> torch.Tensor:
    return rmsnorm(p, x) if p.kind == "rmsnorm" else layernorm(p, x)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class MLP(nn.Module):
    def __init__(self, init: Init, d_model: int, d_ff: int, *,
                 act: str = "swiglu", bias: bool = False, dtype=torch.float32):
        super().__init__()
        self.act = act
        self.hidden = d_ff  # the whole hidden dim (a split MLP binds a block)
        self.up = Linear(init, d_model, d_ff, bias=bias, dtype=dtype)
        self.down = Linear(init, d_ff, d_model, bias=bias, dtype=dtype)
        self.gate = (Linear(init, d_model, d_ff, bias=bias, dtype=dtype)
                     if act == "swiglu" else None)


def mlp_apply(p: MLP, x: torch.Tensor, tp=None) -> torch.Tensor:
    """The MLP. ``tp`` (a ``launch.collectives.Split``): when the bound
    weights are blocks of the hidden dim, ``gate`` and ``up`` are
    column-parallel and ``down`` row-parallel, its partial products summed
    over the model axes and its bias added once, after the sum."""
    axes = tp.over(p.hidden, p.up.w.shape[1]) if tp is not None else None
    if axes:
        x = tp.copy(x, axes)
    if p.act == "swiglu":
        h = F.silu(linear(p.gate, x)) * linear(p.up, x)
    else:
        h = gelu(linear(p.up, x))
    if not axes:
        return linear(p.down, h)
    y = tp.reduce(h @ p.down.w, axes)
    return y if p.down.b is None else y + p.down.b


# ---------------------------------------------------------------------------
# Rotary embeddings (1d standard; "2d" = half-dim rotary a la ChatGLM)
# ---------------------------------------------------------------------------

def rope_angles(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """positions [...] -> (cos, sin) [..., dim/2] in f32. The inverse
    frequencies are computed in numpy f32, as the JAX package does."""
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    inv_t = torch.from_numpy(np.asarray(inv, np.float32)).to(positions.device)
    ang = positions[..., None].float() * inv_t
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               fraction: float = 1.0) -> torch.Tensor:
    """x: [..., S, H, dh]; cos/sin: [S, rot/2] broadcastable. ``fraction``
    rotates only the first fraction of head dims (ChatGLM-style 2d RoPE).
    The rotation is computed in f32 and cast back to x's dtype."""
    dh = x.shape[-1]
    rot = int(dh * fraction)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    c = cos[..., None, :]  # [S, 1, rot/2] -> broadcast over heads
    s = sin[..., None, :]
    o1 = x1 * c - x2 * s
    o2 = x2 * c + x1 * s
    xr = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([xr, xp], dim=-1) if rot < dh else xr


# ---------------------------------------------------------------------------
# Fixed sinusoidal positions (whisper)
# ---------------------------------------------------------------------------

def sinusoidal_pos(seq: int, d: int, dtype=torch.float32,
                   device="cuda") -> torch.Tensor:
    """Whisper-style fixed sinusoidal position embedding [seq, d]: JAX's
    numpy expression in f32, then a tensor in ``dtype`` on ``device`` (the
    table equals JAX's bit for bit)."""
    device = resolve_device(device)
    pos = np.arange(seq, dtype=np.float32)[:, None]
    dim = np.arange(d // 2, dtype=np.float32)[None, :]
    ang = pos / np.power(10000.0, 2.0 * dim / d)
    emb = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.from_numpy(np.asarray(emb, np.float32)).to(device=device,
                                                             dtype=dtype)


def sinusoidal_at(pos: int, d: int, dtype=torch.float32,
                  device="cuda") -> torch.Tensor:
    """The sinusoidal row at position ``pos`` -> [d], computed with torch
    ops in f32 on ``device`` (JAX's ``jnp`` in f32), then cast to
    ``dtype``. The f32 power 10000^(2i/d) is rounded from f64, as XLA's
    is correctly rounded (torch's f32 ``pow`` is not, in 11 of 640 at
    d=1280, and an angle of ~1500 rad carries that ulp into the sine)."""
    device = resolve_device(device)
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)
    den = torch.pow(torch.tensor(10000.0, dtype=torch.float64, device=device),
                    (2.0 * dim / d).double()).float()
    ang = f32(float(pos), device) / den
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)
