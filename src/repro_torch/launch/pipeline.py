"""Pipeline parallelism (GPipe schedule) over a mesh axis.

Counterpart of ``repro/launch/pipeline.py``: layer groups are split over a
``stage`` axis of a DeviceMesh, microbatches flow from stage s to stage
s + 1, and the classic (P - 1)-bubble schedule emerges: tick t runs
microbatch t - s on stage s, for M + P - 1 ticks. JAX writes it as a
``shard_map`` with a ``ppermute`` a tick; the port runs one process a
stage and sends with ``torch.distributed`` (``batch_isend_irecv``): at
every tick each stage but the last sends its output to the next, as
JAX's ppermute does, so a forward makes (M + P - 1) * (P - 1) transfers
(``pipeline_forward.transfers`` counts this rank's sends). A stage that
holds no microbatch at a tick passes its input on without running its
groups (JAX runs them on masked data; the values sent are the same).

This is the forward pipeline (inference / prefill shape), as JAX's.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.configs.base import ArchConfig
from repro_torch.launch import collectives as cc

__all__ = ["pipeline_forward"]


def pipeline_forward(cfg: ArchConfig, groups, h: torch.Tensor, mesh, *,
                     stage_axis: str = "stage", microbatches: int = 2):
    """Run the group stack pipelined over ``stage_axis`` of ``mesh``.

    groups: the model's groups (``model.groups``, all G of them on every
    rank), G % num_stages == 0: stage s runs groups [s G/P, (s+1) G/P);
    h: [B, S, D] embedded activations, the same on every stage, B %
    microbatches == 0. Returns [B, S, D] on every stage: the last stage's
    output, broadcast over the stage axis (JAX's psum of the masked
    buffer)."""
    from repro_torch.models.transformer import _run_stack
    P = cc.axis_size(mesh, stage_axis)
    s = cc.axis_index(mesh, stage_axis)
    M = microbatches
    B = h.shape[0]
    if B % M:
        raise ValueError("batch must divide microbatches")
    G = len(groups)
    if G % P:
        raise ValueError(f"{G} groups do not divide over {P} stages")
    local = groups[s * G // P:(s + 1) * G // P]
    (group,) = cc.axis_groups(mesh, stage_axis)
    hs = h.reshape((M, B // M) + tuple(h.shape[1:]))  # [M, b, S, D]
    out_buf = torch.zeros_like(hs)
    h_prev = torch.zeros_like(hs[0])
    for t in range(M + P - 1):
        x_in = hs[min(max(t, 0), M - 1)] if s == 0 else h_prev
        active = 0 <= t - s < M
        y = _run_stack(cfg, local, x_in, mode="train")[0] if active else x_in
        # the last stage banks its finished microbatch t - (P - 1)
        if s == P - 1 and 0 <= t - (P - 1) < M:
            out_buf[t - (P - 1)] = y
        ops = []
        if s < P - 1:
            ops.append(dist.P2POp(dist.isend, y.contiguous(), group=group,
                                  group_peer=s + 1))
            pipeline_forward.transfers += 1
        if s > 0:
            h_prev = torch.empty_like(hs[0])
            ops.append(dist.P2POp(dist.irecv, h_prev, group=group,
                                  group_peer=s - 1))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    dist.broadcast(out_buf, group=group, group_src=P - 1)
    return out_buf.reshape(h.shape)


pipeline_forward.transfers = 0
