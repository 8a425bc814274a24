"""Collectives over named axes of a ``DeviceMesh``, and their gradients.

JAX writes these as ``psum`` / ``all_gather`` inside a GSPMD program and
lets the partitioner place them; the port runs one process a rank and
calls ``torch.distributed`` itself. ``axes`` is an axis name, a tuple of
them, or None / () (no axis: the identity). Over several axes a
collective runs axis by axis in mesh order, and a rank's index along them
is major to minor in mesh order, as JAX lays a tuple spec entry out.

The gradients follow what the two kinds of axis mean to the objective:
- a **data** axis splits the batch, and each rank's objective is a
  partial sum of the global one: ``all_reduce_sum`` (the global value of
  a sum of per-rank terms) all-reduces its gradient too, and
  ``gather_rows`` (every rank's rows) hands back the rank's own rows'
  gradient;
- a **model** axis holds replicas that compute the same objective, and
  splits work inside one layer (the experts): ``copy_to`` (a replicated
  input to a split computation) all-reduces its gradient, and
  ``reduce_from`` (the sum of the split computation's partial outputs)
  passes the gradient through, as Megatron's f and g do.

``Split`` carries a tensor-parallel step's model axes to the model code:
a module whose weights are bound as their blocks over some of them
computes its part between ``copy_to`` and ``reduce_from``. Where a split
activation meets a split computation without a sum between them, the
blocks travel as Megatron's sequence-parallel pair does:
``gather_from`` (every rank's block, into a computation split another
way: the gradient is reduce-scattered) and ``reduce_scatter`` (the sum
of partial outputs, kept as the rank's block: the gradient is
all-gathered); ``take_block`` hands the rank's block of a replicated
tensor to a split computation (the gradient is all-gathered).
``combine_partials`` is flash-decoding's combine of attention over a
sequence-split cache (decode: no gradient).

Every function raises when the mesh has no such axis; none skips a
collective for want of a process group.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["as_axes", "axis_size", "axis_index", "axis_groups", "psum",
           "pmax_world", "all_reduce_sum", "copy_to", "reduce_from",
           "gather_rows", "gather_dim", "block", "gather_from", "reduce_scatter",
           "take_block", "combine_partials", "Split"]


def as_axes(axes) -> Tuple[str, ...]:
    """``axes`` as a tuple of names (None -> ())."""
    if axes is None:
        return ()
    if isinstance(axes, str):
        return (axes,)
    return tuple(axes)


def _dims(mesh, axes) -> Tuple[int, ...]:
    """The mesh dimensions of ``axes``, in mesh order."""
    names = tuple(mesh.mesh_dim_names or ())
    dims = []
    for a in as_axes(axes):
        if a not in names:
            raise ValueError(f"mesh {names} has no axis {a!r}")
        dims.append(names.index(a))
    return tuple(sorted(dims))


def axis_size(mesh, axes) -> int:
    """The number of ranks along ``axes``."""
    return math.prod(mesh.size(d) for d in _dims(mesh, axes))


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes``, major to minor in mesh order."""
    coord = mesh.get_coordinate()
    idx = 0
    for d in _dims(mesh, axes):
        idx = idx * mesh.size(d) + coord[d]
    return idx


def axis_groups(mesh, axes) -> list:
    """The process groups of ``axes``, in mesh order."""
    return [mesh.get_group(d) for d in _dims(mesh, axes)]


def psum(x: torch.Tensor, mesh, axes, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """A new tensor: ``x`` reduced over ``axes`` (no gradient)."""
    out = x.detach().clone()
    for g in axis_groups(mesh, axes):
        dist.all_reduce(out, op=op, group=g)
    return out


def pmax_world(x: torch.Tensor) -> torch.Tensor:
    """A new tensor: the elementwise maximum of ``x`` over every rank of
    the default process group (max is idempotent: a rank that holds a
    copy of another's values changes nothing)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX)
    return out


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return psum(grad, ctx.mesh, ctx.axes), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return psum(grad, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return psum(x, mesh, axes)

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        n = x.shape[0]
        ctx.rows = (axis_index(mesh, axes) * n, n)
        out = x.detach().contiguous()
        # minor axis first: the rows end up major to minor in mesh order
        for g in reversed(axis_groups(mesh, axes)):
            k = dist.get_world_size(g)
            full = out.new_empty((k * out.shape[0], *out.shape[1:]))
            dist.all_gather_into_tensor(full, out, group=g)
            out = full
        return out

    @staticmethod
    def backward(ctx, grad):
        lo, n = ctx.rows
        return grad[lo:lo + n], None, None


def _apply(fn, x: torch.Tensor, mesh, axes):
    axes = as_axes(axes)
    _dims(mesh, axes)  # raises on an unknown axis
    return fn.apply(x, mesh, axes)


def all_reduce_sum(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum of ``x`` over the ranks of data ``axes``; the gradient is
    all-reduced as well (each rank's objective is a partial sum)."""
    return _apply(_AllReduceSum, x, mesh, axes)


def copy_to(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` (the same on every rank of model ``axes``) handed to a
    computation split over them; the gradient is all-reduced."""
    return _apply(_CopyTo, x, mesh, axes)


def reduce_from(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Sum over model ``axes`` of a split computation's partial outputs;
    the gradient passes through (every replica computes the same
    objective)."""
    return _apply(_ReduceFrom, x, mesh, axes)


def gather_rows(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Every rank's ``x`` along data ``axes``, concatenated on dim 0 in
    rank order; the gradient is the rank's own rows' (the rows of other
    ranks reach this rank's objective through nothing differentiable)."""
    return _apply(_GatherRows, x, mesh, axes)


def gather_dim(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The blocks of ``x`` along ``axes`` concatenated on ``dim``, major to
    minor in mesh order (DTensor's and JAX's layout of a split dim); no
    gradient."""
    out = x.detach().movedim(dim, 0).contiguous()
    for g in reversed(axis_groups(mesh, axes)):  # minor axis first
        full = out.new_empty((dist.get_world_size(g) * out.shape[0],
                              *out.shape[1:]))
        dist.all_gather_into_tensor(full, out, group=g)
        out = full
    return out.movedim(0, dim).contiguous() if dim else out


def _scatter_dim(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The sum of ``x`` over ``axes``, this rank's block of ``dim`` (major
    to minor in mesh order, as ``gather_dim`` lays the blocks); no
    gradient."""
    out = x.detach().movedim(dim, 0).contiguous()
    for g in axis_groups(mesh, axes):  # major axis first
        part = out.new_empty((out.shape[0] // dist.get_world_size(g),
                              *out.shape[1:]))
        dist.reduce_scatter_tensor(part, out, group=g)
        out = part
    return out.movedim(0, dim).contiguous() if dim else out


def block(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` over model ``axes`` (a view;
    blocks major to minor in mesh order, as ``gather_dim`` lays them)."""
    n = x.shape[dim] // axis_size(mesh, axes)
    return x.narrow(dim, axis_index(mesh, axes) * n, n)


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return gather_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, grad):
        return _scatter_dim(grad, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return _scatter_dim(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, grad):
        return gather_dim(grad, *ctx.args), None, None, None


class _TakeBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.args = (mesh, axes, dim)
        return block(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        return gather_dim(grad, *ctx.args), None, None, None


def _apply_dim(fn, x: torch.Tensor, mesh, axes, dim: int):
    axes = as_axes(axes)
    _dims(mesh, axes)  # raises on an unknown axis
    return fn.apply(x, mesh, axes, dim % x.ndim)


def gather_from(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Every rank's block ``x`` along model ``axes`` concatenated on
    ``dim`` (``gather_dim``), handed to a computation split over them: the
    gradient is summed over the ranks and scattered, the rank keeping its
    block's (a reduce-scatter)."""
    return _apply_dim(_GatherFrom, x, mesh, axes, dim)


def reduce_scatter(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """The sum over model ``axes`` of a split computation's partial outputs
    ``x``, kept as this rank's block of ``dim``; the gradient is the
    blocks' gradients gathered (every rank's part read the whole)."""
    return _apply_dim(_ReduceScatter, x, mesh, axes, dim)


def take_block(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's block along ``dim`` of ``x`` (the same on every rank of
    model ``axes``), handed to a computation split over them; the
    gradient is the blocks' gradients gathered."""
    return _apply_dim(_TakeBlock, x, mesh, axes, dim)


def combine_partials(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                     mesh, axes) -> torch.Tensor:
    """Flash-decoding's combine of attention over key blocks split over
    ``axes``: each rank gives, for its block, ``o`` [..., d] (f32, the
    unnormalised sum of exp(s - m) v), ``m`` [...] (its largest score;
    -inf, with ``o`` and ``l`` 0, when it holds no key the query sees) and
    ``l`` [...] (the sum of exp(s - m)). One all-gather of (o, m, l);
    returns sum_r e^(m_r - M) o_r / sum_r e^(m_r - M) l_r, M the largest
    m_r, in f32, the same on every rank (no gradient)."""
    parts = torch.cat([o, m[..., None], l[..., None]], dim=-1)
    every = gather_dim(parts[None], mesh, axes, 0)  # [M, ..., d + 2]
    o, m, l = every[..., :-2], every[..., -2], every[..., -1]
    w = torch.exp(m - m.amax(dim=0))  # an empty block: exp(-inf) = 0
    return (o * w[..., None]).sum(dim=0) / (l * w).sum(dim=0)[..., None]


class Split(NamedTuple):
    """Tensor parallelism over the model axes ``axes`` of ``mesh``, mesh
    order (Megatron's): the sharded steps bind a split weight as its
    block, and the module that holds it finds the axes that split it from
    a dim's whole and bound sizes (``over``), enters its part through
    ``copy`` and sums the parts with ``reduce``."""

    mesh: Any
    axes: Tuple[str, ...]

    def over(self, whole: int, part: int) -> Optional[Tuple[str, ...]]:
        """The leading model axes whose ranks cut a dim of ``whole`` into
        blocks of ``part`` (on a split mesh the heads may be cut by the
        first axes only); None when ``part == whole``."""
        if part == whole:
            return None
        size = 1
        for i, a in enumerate(self.axes):
            size *= axis_size(self.mesh, a)
            if size * part == whole:
                return self.axes[:i + 1]
        raise ValueError(f"a dim of {whole} bound as {part}: no leading "
                         f"axes of {self.axes} cut it so")

    def index(self, axes) -> int:
        return axis_index(self.mesh, axes)

    def copy(self, x: torch.Tensor, axes) -> torch.Tensor:
        return copy_to(x, self.mesh, axes)

    def reduce(self, x: torch.Tensor, axes) -> torch.Tensor:
        return reduce_from(x, self.mesh, axes)

    def size(self, axes) -> int:
        return axis_size(self.mesh, axes)

    def block(self, x: torch.Tensor, axes, dim: int) -> torch.Tensor:
        """``block`` of ``x`` over ``axes``; ``x`` itself when they are
        none."""
        return block(x, self.mesh, axes, dim) if axes else x
