"""Mamba (S6 selective SSM) mixer: the sub-quadratic half of Jamba.

Counterpart of ``repro/models/mamba.py``. ``mamba_train`` runs the causal
depthwise conv (JAX's sum of shifted products) and the selective recurrence
over time; ``return_state=True`` also gives the decode cache: ``conv``, the
last ``d_conv - 1`` pre-conv rows (compute dtype), and ``ssm``, the final
state [B, d_inner, d_state] (f32). ``mamba_decode`` is the one-token step.

The recurrence is a Python loop over time (JAX's ``lax.scan``; its
two-level chunking only changes what backward saves, not the values). Its
elementwise terms exp(delta A) and delta B x are computed for a block of
time steps at once (the same elementwise values), so a step launches only
the multiply-add and the store; y_t = h_t C_t is one product per block.
No kernel computes it: JAX computes it with ``jnp``, outside any Pallas
kernel.

Dtypes follow JAX: projections and the conv in the compute dtype; delta,
B, C, the state and A = -exp(A_log) in f32 (``A_log`` and ``D`` are f32
parameters among bf16 ones).

Tensor parallelism (``tp``, a ``launch.collectives.Split``): when the
weights are bound as blocks of the inner channels (``in_proj`` as the
rank's x and z blocks side by side, ``conv_w``/``conv_b``, ``dt_proj``,
``A_log``, ``D``; ``x_proj`` and ``out_proj`` row-parallel), the module
runs its channels only: the input enters through ``copy``, ``x_proj``'s
(dt, B, C) is summed over the axes and enters the channels through
``copy``, ``out_proj``'s output is summed. The cache holds the rank's
channels.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import Init, Linear, linear

__all__ = ["Mamba", "mamba_train", "mamba_init_cache", "mamba_decode",
           "softplus"]

_BLOCK = 32  # time steps whose elementwise terms are made at once


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, JAX's ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)). ``F.softplus`` is another formula: log1p(exp(x))
    below its threshold of 20, and x above it. Past 20 the two agree in
    f32 (log1p(exp(-x)) < 2.1e-9 is below half an ulp of x >= 20); below,
    their roundings may differ, so the port spells JAX's."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


class DtProj(nn.Module):
    """JAX's ``dt_proj`` = {"w" [dt_rank, d_inner], "b" [d_inner]}: a plain
    pair (``dt @ w + b``), the bias at softplus^-1(0.01)."""

    def __init__(self, init: Init, dt_rank: int, d_inner: int, dtype):
        super().__init__()
        self.w = init.dense((dt_rank, d_inner), dtype)
        self.b = init.full((d_inner,), -4.6, dtype)


class Mamba(nn.Module):
    """JAX's ``mamba_init``: ``in_proj``, ``conv_w`` [d_conv, d_inner],
    ``conv_b``, ``x_proj``, ``dt_proj``, ``A_log`` and ``D`` (f32 always),
    ``out_proj``. ``dt_rank`` is max(1, d_model // 16)."""

    def __init__(self, init: Init, *, d_model: int, d_state: int = 16,
                 d_conv: int = 4, expand: int = 2, dt_rank: Optional[int] = None,
                 dtype=torch.float32):
        super().__init__()
        d_inner = expand * d_model
        dt_rank = dt_rank or max(1, d_model // 16)
        self.in_proj = Linear(init, d_model, 2 * d_inner, dtype=dtype)
        self.conv_w = init.dense((d_conv, d_inner), dtype)
        self.conv_b = init.full((d_inner,), 0.0, dtype)
        self.x_proj = Linear(init, d_inner, dt_rank + 2 * d_state, dtype=dtype)
        self.dt_proj = DtProj(init, dt_rank, d_inner, dtype)
        a = torch.arange(1, d_state + 1, dtype=torch.float32)
        self.A_log = init.rows(torch.log(a), d_inner, torch.float32)
        self.D = init.full((d_inner,), 1.0, torch.float32)
        self.out_proj = Linear(init, d_inner, d_model, dtype=dtype)


def _axes(p: Mamba, tp, d_model: int, expand: int):
    """The model axes that split the bound channels (None: all)."""
    return tp.over(expand * d_model, p.conv_b.shape[0]) if tp is not None else None


def _ssm_params(p: Mamba, x, *, d_state: int, dt_rank: int, tp=None, axes=None):
    """x: [B, S, d_inner] -> (delta [B, S, d_inner], Bm, Cm [B, S, d_state]),
    in f32."""
    if axes:
        proj = tp.copy(tp.reduce(x @ p.x_proj.w, axes), axes)
    else:
        proj = linear(p.x_proj, x)
    dt, Bm, Cm = torch.split(proj, [dt_rank, d_state, d_state], dim=-1)
    delta = softplus(dt @ p.dt_proj.w + p.dt_proj.b)
    return delta.float(), Bm.float(), Cm.float()


def _scan(delta, Bm, Cm, xf, A, h):
    """The selective recurrence from state h [B, di, ds]: h_t = exp(delta_t
    A) h_{t-1} + delta_t B_t x_t, y_t = h_t C_t. Returns (y [B, S, di], the
    last h)."""
    S = delta.shape[1]
    ys = []
    for t0 in range(0, S, _BLOCK):
        blk = slice(t0, min(t0 + _BLOCK, S))
        d = delta[:, blk, :, None]  # [B, T, di, 1]
        dA = torch.exp(d * A)
        dBx = d * Bm[:, blk, None, :] * xf[:, blk, :, None]
        hs = torch.empty_like(dA)
        for t in range(dA.shape[1]):
            h = dA[:, t] * h + dBx[:, t]
            hs[:, t] = h
        ys.append(torch.einsum("btds,bts->btd", hs, Cm[:, blk]))
    return torch.cat(ys, dim=1), h


def _project_out(p: Mamba, y, tp, axes):
    return tp.reduce(y @ p.out_proj.w, axes) if axes else linear(p.out_proj, y)


def mamba_train(p: Mamba, x, *, d_state: int = 16, d_conv: int = 4,
                expand: int = 2, dt_rank: Optional[int] = None,
                return_state: bool = False, tp=None):
    """x: [B, S, D] -> [B, S, D]; with ``return_state`` also the decode
    cache {"conv", "ssm"}. S < d_conv - 1 raises (JAX's shapes do not
    allow it)."""
    B, S, D = x.shape
    axes = _axes(p, tp, D, expand)
    d_inner = p.conv_b.shape[0]
    dt_rank = dt_rank or max(1, D // 16)
    if return_state and S < d_conv - 1:
        raise ValueError(f"S={S} is shorter than the conv tail d_conv - 1 = "
                         f"{d_conv - 1}")
    if axes:
        x = tp.copy(x, axes)
    xs_pre, z = torch.chunk(linear(p.in_proj, x), 2, dim=-1)

    # causal depthwise conv over time
    pad = F.pad(xs_pre, (0, 0, d_conv - 1, 0))
    conv = sum(pad[:, i:i + S, :] * p.conv_w[i] for i in range(d_conv))
    xs = F.silu(conv + p.conv_b)

    delta, Bm, Cm = _ssm_params(p, xs, d_state=d_state, dt_rank=dt_rank, tp=tp,
                                axes=axes)
    A = -torch.exp(p.A_log)  # [d_inner, d_state]
    xf = xs.float()
    h0 = torch.zeros((B, d_inner, d_state), dtype=torch.float32, device=x.device)
    ys, h_last = _scan(delta, Bm, Cm, xf, A, h0)

    y = ys + xf * p.D[None, None, :]
    y = y.to(x.dtype) * F.silu(z)
    out = _project_out(p, y, tp, axes)
    if return_state:
        return out, {"conv": xs_pre[:, S - (d_conv - 1):, :], "ssm": h_last}
    return out


def mamba_prefill(p: Mamba, x, cache: Dict[str, torch.Tensor], **kw):
    """``mamba_train`` over the prompt that writes the final states into
    ``cache`` in place. Returns (out, cache)."""
    out, state = mamba_train(p, x, return_state=True, **kw)
    cache["conv"].copy_(state["conv"])
    cache["ssm"].copy_(state["ssm"])
    return out, cache


def mamba_init_cache(batch: int, *, d_model: int, d_state: int = 16,
                     d_conv: int = 4, expand: int = 2, dtype=torch.float32,
                     device="cuda"):
    """{"conv" [B, d_conv - 1, d_inner] in ``dtype``, "ssm" [B, d_inner,
    d_state] f32}, zeroed."""
    d_inner = expand * d_model
    return {
        "conv": torch.zeros((batch, d_conv - 1, d_inner), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, d_inner, d_state), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(p: Mamba, x, cache: Dict[str, torch.Tensor], *, d_state: int = 16,
                 d_conv: int = 4, expand: int = 2, dt_rank: Optional[int] = None,
                 tp=None):
    """One-token step. x: [B, 1, D]. Updates ``cache`` in place; returns
    (y [B, 1, D], cache)."""
    B, _, D = x.shape
    axes = _axes(p, tp, D, expand)
    dt_rank = dt_rank or max(1, D // 16)
    if axes:
        x = tp.copy(x, axes)
    xs, z = torch.chunk(linear(p.in_proj, x[:, 0]), 2, dim=-1)  # [B, d_inner]

    window = torch.cat([cache["conv"], xs[:, None, :]], dim=1)  # [B, dc, di]
    conv = torch.einsum("bcd,cd->bd", window, p.conv_w) + p.conv_b
    xs_c = F.silu(conv)

    delta, Bm, Cm = _ssm_params(p, xs_c[:, None, :], d_state=d_state,
                                dt_rank=dt_rank, tp=tp, axes=axes)
    d_t, B_t, C_t = delta[:, 0], Bm[:, 0], Cm[:, 0]
    A = -torch.exp(p.A_log)
    dA = torch.exp(d_t[..., None] * A[None])
    xf = xs_c.float()
    dBx = d_t[..., None] * B_t[:, None, :] * xf[..., None]
    h = dA * cache["ssm"] + dBx
    y = torch.einsum("bds,bs->bd", h, C_t) + xf * p.D
    y = y.to(x.dtype) * F.silu(z)
    out = _project_out(p, y, tp, axes)[:, None, :]
    cache["conv"].copy_(window[:, 1:])
    cache["ssm"].copy_(h)
    return out, cache
