"""Counterpart of ``repro/launch/hlo_analysis.py``: the cost, the collectives
and the live memory of one step, counted from what it dispatches.

JAX reads a compiled step's HLO text; PyTorch runs a step eagerly, and
every operation it runs passes through the dispatcher. So the port counts
there (a ``TorchDispatchMode``) instead of parsing a program:

- ``cost_analysis(fn, *args)`` -> ``{"flops", "bytes accessed"}``
  (``cost_analysis_dict``'s keys): ``flops`` is ``torch.utils.
  flop_counter.FlopCounterMode``'s total (2 a multiply-add, as
  ``benchmarks/flops_model.py`` counts them); ``bytes accessed`` sums,
  over the dispatched operations, the bytes of their tensor inputs and
  outputs. Eager mode fuses nothing, so this is XLA's per-operation sum
  with no fusion; views (which move no data) and metadata queries are
  left out.
- ``CollectiveReport`` (JAX's fields): every c10d operation the step
  issues, functional (``_c10d_functional``: what DTensor's redistribution
  calls) and in place (``c10d``: ``torch.distributed.all_reduce`` and
  the like), keyed under JAX's kind names (``KINDS``; send/recv is a
  ``collective-permute``), each counted with its result's bytes, as
  ``collective_bytes`` counts an HLO op's result: a send/recv pair counts
  once, as its receive. Eager mode dispatches every call of a loop, so no
  loop needs a weight and ``unresolved_loops`` is 0.
- ``comm_ops``: the operations a kind (JAX's ``hlo_ops``' collective
  counts); ``shapes``: each one's result shape, in order, a kind.
- The storages read (``StepTrace.read``): those an operation took as an
  input, as JAX's compiled step keeps only the arguments it uses.
- The live memory (``StepTrace.peak_bytes``): the bytes of every storage
  an operation creates, from its creation until Python frees it, plus the
  storages ``track`` is given (the step's arguments, counted once);
  ``meta`` storages hold nothing. A collective's result waited on
  (``wait_tensor``, a new storage under ``FakeTensorMode``) or wrapped
  (``AsyncCollectiveTensor``, eager) is the result itself, counted once,
  until both are freed. Under ``FakeTensorMode`` nothing is allocated and
  the count is the rank's prediction.

A DTensor operation is counted once, at the DTensor level (a mode sees
it before the DTensor's own dispatch, and not the local operations that
dispatch runs): the flop counter then counts the global shape's flops.
The port's steps compute on local tensors (``launch/steps.py``), so their
counts are a rank's.
"""

from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["KINDS", "CollectiveReport", "StepTrace", "cost_analysis",
           "tensor_bytes"]

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

# c10d operation (namespace.name) -> (kind, where its result is): "out"
# the return value (functional), "arg0" the first argument (in place);
# a kind of None is not counted (a send: its receive counts)
_COLLECTIVES = {
    "_c10d_functional.all_reduce": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", "out"),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", "out"),
    "_c10d_functional.all_gather_into_tensor": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_out": ("all-gather", "out"),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", "out"),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", "out"),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter", "out"),
    "_c10d_functional.all_to_all_single": ("all-to-all", "out"),
    "_c10d_functional.isend": (None, "out"),
    "_c10d_functional.irecv": ("collective-permute", "out"),
    "c10d.allreduce_": ("all-reduce", "arg0"),
    "c10d.allreduce_coalesced_": ("all-reduce", "arg0"),
    "c10d.allgather_": ("all-gather", "arg0"),
    "c10d._allgather_base_": ("all-gather", "arg0"),
    "c10d.allgather_coalesced_": ("all-gather", "arg0"),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", "arg0"),
    "c10d.reduce_scatter_": ("reduce-scatter", "arg0"),
    "c10d._reduce_scatter_base_": ("reduce-scatter", "arg0"),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", "arg0"),
    "c10d.alltoall_": ("all-to-all", "arg0"),
    "c10d.alltoall_base_": ("all-to-all", "arg0"),
    "c10d.send": (None, "arg0"),
    "c10d.recv_": ("collective-permute", "arg0"),
    "c10d.recv_any_source_": ("collective-permute", "arg0"),
}
_NOT_COUNTED = {"_c10d_functional.wait_tensor",
                "_c10d_functional._wrap_tensor_autograd", "c10d.barrier",
                "c10d.monitored_barrier_"}
_ALIASES = {"_c10d_functional.wait_tensor",  # result: its input's storage
            "_c10d_functional._wrap_tensor_autograd"}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's block; an ``AsyncCollectiveTensor``'s inner tensor."""
    from torch.distributed._functional_collectives import AsyncCollectiveTensor
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        return t.to_local()
    return t.elem if isinstance(t, AsyncCollectiveTensor) else t


def _tensors(tree) -> list:
    return [_local(t) for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def tensor_bytes(tree) -> int:
    """The bytes of the tensors in ``tree`` (a DTensor: this rank's block)."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


@dataclasses.dataclass
class CollectiveReport:
    total_bytes: float
    by_kind: Dict[str, float]
    op_count: int
    unresolved_loops: int

    def as_dict(self):
        return {"total_bytes": self.total_bytes, "by_kind": dict(self.by_kind),
                "op_count": self.op_count,
                "unresolved_loops": self.unresolved_loops}


class StepTrace(TorchDispatchMode):
    """Records, while it is on, the collectives (``report``, ``comm_ops``,
    ``shapes``),
    the bytes accessed (``bytes_accessed``) and the live memory
    (``live_bytes``, ``peak_bytes``) of the operations dispatched. Raises
    on a c10d operation it does not know (nothing goes uncounted)."""

    def __init__(self):
        super().__init__()
        self.by_kind: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = {k: 0 for k in KINDS}
        self.shapes: Dict[str, list] = {k: [] for k in KINDS}
        self.bytes_accessed = 0
        self.live_bytes = self.peak_bytes = 0
        self._live: Dict[int, weakref.ref] = {}
        self._aliases: Dict[int, tuple] = {}  # alias storage id -> (its
        # weakref, the aliased storage, kept while the alias lives)
        self._read: set = set()  # ids: a live storage keeps its Python object

    def read(self, t: torch.Tensor) -> bool:
        """Whether an operation took ``t``'s storage as an input (JAX's
        compiled step keeps only the arguments it uses)."""
        return id(_local(t).untyped_storage()) in self._read

    def track(self, *trees) -> None:
        """Count the storages of ``trees``' tensors (the arguments) as live."""
        for t in _tensors(trees):
            self._hold(t)

    def _hold(self, t: torch.Tensor) -> None:
        if t.device.type == "meta":
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._live or key in self._aliases:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n):
            self._live.pop(key, None)
            self.live_bytes -= n

        self._live[key] = weakref.ref(st, freed)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _alias(self, out: torch.Tensor, of: torch.Tensor) -> None:
        """Count ``out``'s storage as ``of``'s: no bytes of its own, and
        ``of``'s kept live while ``out``'s lives."""
        st, src = out.untyped_storage(), of.untyped_storage()
        key = id(st)
        if key == id(src) or key in self._live or key in self._aliases:
            return
        self._hold(of)
        self._aliases[key] = (weakref.ref(
            st, lambda _, key=key: self._aliases.pop(key, None)), src)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in _tensors((args, kwargs)):
            if t.device.type != "meta":
                self._read.add(id(t.untyped_storage()))
        out = func(*args, **kwargs)
        name = f"{func.namespace}.{func._schema.name.split('::')[-1]}"
        if func.namespace in ("c10d", "_c10d_functional"):
            if name not in _NOT_COUNTED:
                if name not in _COLLECTIVES:
                    raise NotImplementedError(f"step_analysis: {name} is not "
                                              "a collective it counts")
                kind, where = _COLLECTIVES[name]
                if kind is not None:
                    res = out if where == "out" else args[0]
                    self.by_kind[kind] += tensor_bytes(res)
                    self.counts[kind] += 1
                    self.shapes[kind] += [tuple(t.shape) for t in _tensors(res)]
        elif not func.is_view and func.namespace == "aten":
            self.bytes_accessed += tensor_bytes((args, kwargs)) + tensor_bytes(out)
        if name in _ALIASES:
            self._alias(_local(out), _local(args[0]))
            return out
        for t in _tensors(out):
            self._hold(t)
        return out

    @property
    def report(self) -> CollectiveReport:
        by_kind = {k: v for k, v in self.by_kind.items() if self.counts[k]}
        return CollectiveReport(float(sum(by_kind.values())), by_kind,
                                sum(self.counts.values()), 0)

    @property
    def comm_ops(self) -> Dict[str, int]:
        return dict(self.counts)


def cost_analysis(fn, *args, **kwargs) -> Dict[str, float]:
    """``fn(*args, **kwargs)``'s {"flops", "bytes accessed"}."""
    from torch.utils.flop_counter import FlopCounterMode
    fc = FlopCounterMode(display=False)
    with fc, StepTrace() as st:
        fn(*args, **kwargs)
    return {"flops": float(fc.get_total_flops()),
            "bytes accessed": float(st.bytes_accessed)}
