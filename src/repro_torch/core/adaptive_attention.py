"""ASK-refined block-sparse decode attention: the paper's loop (g, r, B)
over a decode step's KV cache.

Counterpart of ``repro/core/adaptive_attention.py``. The KV sequence is
split into g coarse blocks; per level each active block's children get an
upper bound on q.k from the blocks' elementwise key envelopes (kmin,
kmax): sum_d max(q_d kmin_d, q_d kmax_d) >= q.k for every key in the
block. Blocks whose bound falls more than ``margin`` below the best are
terminated, the rest subdivide by r, down to leaves of B keys. The
surviving leaves enter a top-C selection by bound (the OLT capacity) and
exact attention runs on the gathered C x B keys.

Shapes: q [Bt, H, dh]; k/v [Bt, S, H, dh]; on the caller's device. The
top-C selection is a stable descending sort, so ties go to the lower block
index, as ``jax.lax.top_k`` breaks them.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from repro_torch.models.common import f32

__all__ = ["build_envelope_pyramid", "adaptive_decode_attention",
           "exact_decode_attention"]


def _num_levels(S: int, g: int, r: int, B: int) -> int:
    lv = 0
    blk = S // g
    while blk > B:
        lv += 1
        blk //= r
    return lv


def build_envelope_pyramid(k: torch.Tensor, *, g: int, r: int, B: int
                           ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per-level (kmin, kmax) envelopes, coarse -> leaf. k: [Bt, S, H, dh];
    level i has g * r**i blocks: kmin/kmax [Bt, nblocks, H, dh]. Built
    leaf-up, one pass over the cache."""
    Bt, S, H, dh = k.shape
    levels = _num_levels(S, g, r, B)
    n_leaf = g * r ** levels
    leaf = k.reshape(Bt, n_leaf, S // n_leaf, H, dh)
    kmin, kmax = torch.amin(leaf, dim=2), torch.amax(leaf, dim=2)
    pyr = [(kmin, kmax)]
    for _ in range(levels):
        n = kmin.shape[1] // r
        kmin = torch.amin(kmin.reshape(Bt, n, r, H, dh), dim=2)
        kmax = torch.amax(kmax.reshape(Bt, n, r, H, dh), dim=2)
        pyr.append((kmin, kmax))
    return pyr[::-1]


def _bounds(q, kmin, kmax, live_mask):
    """Upper bound on q.k over each block: [Bt, H, nblocks]."""
    qe = q[:, None]  # [Bt, 1, H, dh]
    ub = torch.sum(torch.maximum(qe * kmin, qe * kmax), dim=-1)  # [Bt, nb, H]
    ub = ub.masked_fill(~live_mask[None, :, None], float("-inf"))
    return ub.transpose(1, 2)


def _live(nb: int, block_len: int, live: int, device) -> torch.Tensor:
    return torch.arange(nb, device=device) * block_len < live


def adaptive_decode_attention(q, k, v, *, g: int = 16, r: int = 2, B: int = 64,
                              margin: float = 10.0,
                              capacity: Optional[int] = None,
                              live_len: Optional[int] = None):
    """Approximate single-token attention over [Bt, S, H, dh] KV.

    Returns (out [Bt, H, dh], stats {"kept_blocks", "leaf_blocks",
    "kept_fraction"}). ``capacity`` = the most leaf blocks attended (top-C
    by bound; default half). ``live_len`` masks a partly filled cache."""
    Bt, S, H, dh = k.shape
    levels = _num_levels(S, g, r, B)
    n_leaf = g * r ** levels
    blk = S // n_leaf
    capacity = min(capacity or max(1, n_leaf // 2), n_leaf)
    live = S if live_len is None else live_len
    dev = q.device

    pyr = build_envelope_pyramid(k, g=g, r=r, B=B)
    scale = 1.0 / math.sqrt(dh)

    # the ASK level loop, fused-static: prune by the bound's margin
    nb, block_len = g, S // g
    ub = _bounds(q, *pyr[0], _live(nb, block_len, live, dev))  # [Bt, H, g]
    active = torch.ones_like(ub, dtype=torch.bool)
    for lv in range(levels):
        best = torch.amax(ub.masked_fill(~active, float("-inf")), dim=-1,
                          keepdim=True)
        active = active & (ub >= best - margin)
        # subdivide: children inherit the parent's active flag
        nb, block_len = nb * r, block_len // r
        active = torch.repeat_interleave(active, r, dim=-1)
        ub = _bounds(q, *pyr[lv + 1], _live(nb, block_len, live, dev))
        ub = ub.masked_fill(~active, float("-inf"))
    best = torch.amax(ub, dim=-1, keepdim=True)
    active = active & (ub >= best - margin)

    # leaf: the OLT's fixed capacity, top-C by bound (ties: lower index)
    sel_ub = ub.masked_fill(~active, float("-inf"))
    idx = torch.sort(sel_ub, dim=-1, descending=True, stable=True)[1][..., :capacity]

    # gather the selected key/value blocks: [Bt, H, C*blk, dh]
    kb = k.reshape(Bt, n_leaf, blk, H, dh).permute(0, 3, 1, 2, 4)
    vb = v.reshape(Bt, n_leaf, blk, H, dh).permute(0, 3, 1, 2, 4)
    at = idx[..., None, None].expand(Bt, H, capacity, blk, dh)
    gk = torch.gather(kb, 2, at).reshape(Bt, H, capacity * blk, dh)
    gv = torch.gather(vb, 2, at).reshape(Bt, H, capacity * blk, dh)

    # positions of the gathered keys, for the live-length mask
    pos = (idx[..., None] * blk + torch.arange(blk, device=dev)).reshape(
        Bt, H, capacity * blk)
    s = torch.einsum("bhd,bhkd->bhk", q, gk) * scale
    s = s.masked_fill(pos >= live, float("-inf"))
    w = torch.softmax(s.float(), dim=-1).to(q.dtype)
    out = torch.einsum("bhk,bhkd->bhd", w, gv)
    kept = torch.clamp(torch.sum(active.to(torch.int32), dim=-1), max=capacity)
    return out, {"leaf_blocks": n_leaf, "kept_blocks": kept,
                 "kept_fraction": kept / n_leaf}


def exact_decode_attention(q, k, v, *, live_len: Optional[int] = None):
    """Oracle: full attention. q [Bt, H, dh]; k/v [Bt, S, H, dh]."""
    Bt, S, H, dh = k.shape
    live = S if live_len is None else live_len
    s = torch.einsum("bhd,bshd->bhs", q, k) / f32(math.sqrt(dh), q.device)
    s = s.masked_fill(torch.arange(S, device=q.device) >= live, float("-inf"))
    w = torch.softmax(s.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhs,bshd->bhd", w, v)
