"""Mixture-of-Experts with OLT-compaction dispatch (the paper's primitive).

Counterpart of ``repro/models/moe.py``. Token->expert routing is the ASK
write-OLT insert: each token "subdivides" into its top-k experts, and its
slot inside an expert's buffer is the exclusive prefix-sum rank over that
expert's flags, per token group: ``kernels.ops.batched_ranks``, the
batched-ranks CUDA kernel on the card (JAX computes the same cumsum inline
at this place). Tokens past an expert's capacity C are dropped: their
combine weight is zero and the residual path carries them.

Shapes: x [B, S, D] -> groups [G, Sg, D] -> buffers [E, G, C, D] -> expert
FFN -> combine [B, S, D]. The dispatch and combine are the GShard grouped
einsums of the JAX package, written as batched matrix products.

Sharded (``mesh=``, ``token_axes``, ``ep_axis``): the groups are cut from
the global token count, each data rank routes its own groups, and each
model rank computes its share of the experts (EP); see ``moe_apply``.

Intermediate dtypes follow JAX: the router's f32 weight is cast to the
compute dtype and the product accumulated in f32; the combine weights are
f32 and cast to the compute dtype for the combine product. Two spellings
differ from JAX's and give the same values: ``lax.top_k`` is a stable
descending sort (ties go to the lower expert index, as in JAX), and the
combine tensor folds ``keep * gate`` into the expert one-hot and takes one
product over k instead of JAX's four-operand einsum (each (token, expert)
pair has at most one k, so the sum has one term either way).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.common import MLP, Init, gelu, mlp_apply

__all__ = ["MoE", "moe_apply", "moe_apply_dense_fallback", "capacity"]


class Router(nn.Module):
    def __init__(self, init: Init, d_model: int, num_experts: int):
        super().__init__()
        self.w = init.dense((d_model, num_experts), torch.float32)  # f32 always


class Experts(nn.Module):
    def __init__(self, init: Init, d_model: int, d_ff: int, num_experts: int,
                 dtype):
        super().__init__()
        self.gate = init.dense((num_experts, d_model, d_ff), dtype)
        self.up = init.dense((num_experts, d_model, d_ff), dtype)
        self.down = init.dense((num_experts, d_ff, d_model), dtype)


class MoE(nn.Module):
    """JAX's ``moe_init``: ``router`` (``w`` [D, E], f32), ``experts``
    (``gate``/``up`` [E, D, F], ``down`` [E, F, D]) and, with shared
    experts, ``shared`` (an MLP)."""

    def __init__(self, init: Init, *, d_model: int, d_ff: int, num_experts: int,
                 top_k: int, num_shared: int = 0, act: str = "swiglu",
                 dtype=torch.float32):
        super().__init__()
        self.router = Router(init, d_model, num_experts)
        self.experts = Experts(init, d_model, d_ff, num_experts, dtype)
        self.shared = (MLP(init, d_model, d_ff * num_shared, act=act, dtype=dtype)
                       if num_shared else None)


def capacity(capacity_factor: float, Sg: int, top_k: int, num_experts: int) -> int:
    """Slots per expert per group: JAX's ``max(1, int(cf * Sg * K / E))``,
    in Python float arithmetic (1 in decode at 8 tokens, 64 experts)."""
    return max(1, int(capacity_factor * Sg * top_k / num_experts))


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _ep_experts(ex: Experts, num_experts: int, m: int, k: int):
    """(gate, up, down) of the ``num_experts // m`` experts of model rank
    ``k``: sliced from whole weights, or the weights themselves when they
    are already that rank's slice (the sharded train step gathers only
    those)."""
    E_loc = num_experts // m
    out = []
    for w in (ex.gate, ex.up, ex.down):
        if w.shape[0] == num_experts:
            w = w[k * E_loc:(k + 1) * E_loc]
        elif w.shape[0] != E_loc:
            raise ValueError(f"expert weights of {w.shape[0]} experts: neither "
                             f"all {num_experts} nor model rank {k}'s {E_loc}")
        out.append(w)
    return out


def moe_apply(p: MoE, x: torch.Tensor, *, num_experts: int, top_k: int,
              capacity_factor: float = 1.25, act: str = "swiglu",
              router_z_weight: float = 1e-3, ep_axis=None, token_axes=None,
              group_size: int = 1024, mesh=None, tp=None):
    """Returns (y [B, S, D], aux) where aux carries the load-balance and
    router-z losses and ``expert_counts`` [E].

    Sharded (``mesh``, a DeviceMesh): ``token_axes`` are the data axes
    that ``x``'s rows are split over (this rank holds its block of the
    global batch), ``ep_axis`` the model axis the experts are split over
    (EP). The groups are cut from the global token count, as JAX cuts
    them: a rank routes its own whole groups when their number divides by
    the data ranks, else every rank gathers all the tokens, routes them
    all and keeps its rows' output, so capacity and drops are JAX's
    either way. The batched ranks run on the rank's groups. Model rank k
    computes experts [k E/m, (k+1) E/m) of the dispatched buffer, and the
    partial outputs are summed over the model axis. The load-balance and
    router-z losses and the expert counts are reduced over the global
    groups and tokens. Either axis without a mesh raises (there is no
    process group to reduce over). ``tp``: the shared experts' MLP runs
    tensor-parallel (``common.mlp_apply``)."""
    if (ep_axis is not None or token_axes is not None) and mesh is None:
        raise ValueError(f"moe_apply: ep_axis={ep_axis!r}, token_axes="
                         f"{token_axes!r} name mesh axes, and no mesh was given "
                         "(a mesh needs a process group)")
    if mesh is not None:
        from repro_torch.launch import collectives as cc
    B, S, D = x.shape
    E, K = num_experts, top_k
    tok = cc.as_axes(token_axes) if mesh is not None else ()
    dsize = cc.axis_size(mesh, tok) if tok else 1
    T_loc = B * S
    T = T_loc * dsize  # the global token count
    Sg = min(group_size, T)
    if T % Sg:
        Sg = T  # degenerate small inputs: one group
    G = T // Sg
    gathered = G % dsize != 0  # a data rank cannot hold whole groups
    own = slice(0, T_loc)
    if gathered:
        own = slice(cc.axis_index(mesh, tok) * T_loc,
                    (cc.axis_index(mesh, tok) + 1) * T_loc)
        xg = cc.gather_rows(x.reshape(T_loc, D), mesh, tok).reshape(G, Sg, D)
    else:
        G //= dsize  # this rank's groups
        xg = x.reshape(G, Sg, D)

    # router: compute-dtype operands, f32 accumulation
    logits = xg.float() @ p.router.w.to(x.dtype).float()  # [G, Sg, E]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, K)  # [G, Sg, K]
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # ---- OLT insert: per-(group, expert) exclusive ranks (the kernel) -------
    ids = expert_ids.reshape(G, Sg * K, 1)
    flags = torch.zeros((G, Sg * K, E), dtype=torch.int32, device=x.device)
    flags.scatter_(2, ids, 1)
    ranks, counts = ops.batched_ranks(flags)  # [G, Sg*K, E], [G, E]
    pos = ranks.gather(2, ids).reshape(G, Sg, K)

    C = capacity(capacity_factor, Sg, K, E)
    keep = (pos < C).float()  # overflow dropped (residual path)

    # ---- EP: this rank's experts [lo, lo + E_loc) ----------------------------
    gate, up, down = p.experts.gate, p.experts.up, p.experts.down
    E_loc, lo, xd = E, 0, xg
    if ep_axis is not None:
        m = cc.axis_size(mesh, ep_axis)
        if E % m:
            raise ValueError(f"{E} experts do not divide over {m} ranks of "
                             f"{ep_axis!r}")
        E_loc = E // m
        lo = cc.axis_index(mesh, ep_axis) * E_loc
        gate, up, down = _ep_experts(p.experts, E, m, lo // E_loc)
        xd = cc.copy_to(xg, mesh, ep_axis)  # the dispatch's input
        gate_vals = cc.copy_to(gate_vals, mesh, ep_axis)  # the combine's

    # ---- combine [G, Sg, E_loc, C] f32 and dispatch one-hots -----------------
    e_w = F.one_hot(expert_ids, E).float() * (keep * gate_vals)[..., None]
    if E_loc != E:
        e_w = e_w[..., lo:lo + E_loc]
    c_oh = F.one_hot(pos.clamp(max=C).long(), C + 1)[..., :C].float()
    Tg = G * Sg
    combine = torch.matmul(e_w.reshape(Tg, K, E_loc).transpose(1, 2),
                           c_oh.reshape(Tg, K, C)).reshape(G, Sg, E_loc * C)
    dispatch = (combine > 0).to(x.dtype)

    # ---- expert buffers [E_loc, G, C, D] -------------------------------------
    buf = torch.bmm(dispatch.transpose(1, 2), xd)  # [G, E_loc*C, D]
    buf = buf.reshape(G, E_loc, C, D).transpose(0, 1).reshape(E_loc, G * C, D)
    if act == "swiglu":
        h = F.silu(torch.bmm(buf, gate)) * torch.bmm(buf, up)
    else:
        h = gelu(torch.bmm(buf, up))
    out = torch.bmm(h, down)  # [E_loc, G*C, D]
    out = out.reshape(E_loc, G, C, D).transpose(0, 1).reshape(G, E_loc * C, D)

    # ---- combine back to tokens ----------------------------------------------
    y = torch.bmm(combine.to(x.dtype), out)  # [G, Sg, D]
    if ep_axis is not None:
        y = cc.reduce_from(y, mesh, ep_axis)
    y = y.reshape(-1, D)[own].reshape(B, S, D)
    if p.shared is not None:
        y = y + mlp_apply(p.shared, x, tp)

    # ---- aux losses (GShard/Switch style), over the global tokens -----------
    if gathered:  # this rank's tokens of the gathered groups
        probs_own = probs.reshape(-1, E)[own]
        top1 = expert_ids.reshape(-1, K)[own, 0]
        lse = torch.logsumexp(logits.reshape(-1, E)[own], dim=-1)
        me, ce, z = (torch.mean(probs_own, dim=0),
                     torch.mean(F.one_hot(top1, E).float(), dim=0),
                     torch.mean(torch.square(lse)))
    else:
        me = torch.mean(probs, dim=(0, 1))
        ce = torch.mean(F.one_hot(expert_ids[..., 0], E).float(), dim=(0, 1))
        z = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    expert_counts = torch.sum(counts, dim=0)
    if tok:  # each rank's mean weighted by its share of the tokens, summed
        frac = T_loc / T
        me = cc.all_reduce_sum(me * frac, mesh, tok)
        ce = cc.all_reduce_sum(ce * frac, mesh, tok)
        z = cc.all_reduce_sum(z * frac, mesh, tok)
        if not gathered:
            expert_counts = cc.psum(expert_counts, mesh, tok)
    load_balance = E * torch.sum(me * ce)
    router_z = router_z_weight * z
    aux = {"load_balance": load_balance, "router_z": router_z,
           "expert_counts": expert_counts}
    return y, aux


def moe_apply_dense_fallback(p: MoE, x: torch.Tensor, *, num_experts: int,
                             top_k: int, act: str = "swiglu"):
    """Reference (oracle) MoE: every expert computes every token, masked by
    router weights. O(E) FLOPs: used only in tests, to hold the OLT
    dispatch path (at a capacity factor high enough that nothing drops)."""
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    logits = xt.float() @ p.router.w
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, top_k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)
    w = torch.zeros((T, num_experts), dtype=torch.float32, device=x.device)
    w.scatter_(1, expert_ids, gate_vals)
    ex = p.experts
    if act == "swiglu":
        h = F.silu(torch.einsum("td,edf->tef", xt, ex.gate))
        h = h * torch.einsum("td,edf->tef", xt, ex.up)
    else:
        h = gelu(torch.einsum("td,edf->tef", xt, ex.up))
    out = torch.einsum("tef,efd->ted", h, ex.down)
    y = torch.einsum("ted,te->td", out, w.to(x.dtype)).reshape(B, S, D)
    if p.shared is not None:
        y = y + mlp_apply(p.shared, x)
    return y
