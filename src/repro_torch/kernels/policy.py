"""KernelPolicy: one frozen object selecting how every kernel runs.

Counterpart of ``repro/kernels/policy.py``. A ``KernelPolicy`` is a
hashable value that rides inside ``workloads.FrameProblem``; since the
problem's fields key the CUDA graphs of the one-dispatch engines
(``FrameProblem.graph_key``), the routing is part of the same identity
that keys a captured level loop. Its fields:

* ``backend`` -- the rung of the routing ladder:
    ``torch``  the plain PyTorch versions (``ref.py``), on the device of
               the tensors they are given; the counterpart of ``jnp``;
    ``cuda``   the default: the hand-written kernel on a CUDA tensor, the
               plain version on a CPU tensor, as every wrapper of
               ``kernels/`` decides by itself; the counterpart of
               ``pallas``, whose interpret mode off the TPU is the plain
               version here;
    ``tuned``  per-kernel measured selection: the autotune cache
               (``kernels.autotune``) names the winning (impl, schedule)
               at the call's static signature, and the heuristics answer
               when it is cold.
* ``overrides`` -- per-kernel schedule parameters (``unroll``, Ex's
  ``block``) applied last, over whatever the backend or the tuner chose;
  a mapping ``{kernel: {param: value}}``, canonicalised to sorted tuples.
* ``tuning_cache`` -- path of the JSON cache the ``tuned`` backend reads
  (None: heuristics only).

JAX's ``interpret`` flag has no counterpart: the device of the tensors
decides (ROADMAP ground rule 6). The legacy ``backend="..."`` keyword of
the entry points goes through ``resolve_policy``, which wraps the string
and warns with a ``DeprecationWarning``.
"""

from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import Mapping, Optional, Tuple, Union

__all__ = ["Backend", "KernelPolicy", "resolve_policy", "DEFAULT_POLICY",
           "TORCH_POLICY", "CUDA_POLICY", "TUNED_POLICY", "KERNEL_NAMES"]

# the kernels a policy can carry overrides for (ops.py entry points)
KERNEL_NAMES = ("dwell", "perimeter_query", "region_fill", "region_dwell",
                "region_fill_pooled", "region_dwell_pooled",
                "olt_compact", "batched_ranks")


class Backend(enum.Enum):
    """The routing ladder: plain version < hand-written kernel < tuned."""

    TORCH = "torch"
    CUDA = "cuda"
    TUNED = "tuned"

    def __str__(self) -> str:  # str(pol.backend) == the legacy string
        return self.value


def _coerce_backend(backend: Union[Backend, str]) -> Backend:
    if isinstance(backend, Backend):
        return backend
    try:
        return Backend(str(backend))
    except ValueError:
        raise ValueError(
            f"unknown backend {backend!r}; expected one of "
            f"{[b.value for b in Backend]}") from None


def _freeze_value(v):
    """Hashable canonical form of one override value (lists -> tuples)."""
    if isinstance(v, (list, tuple)):
        return tuple(_freeze_value(x) for x in v)
    return v


def _freeze_overrides(overrides) -> Tuple[Tuple[str, Tuple], ...]:
    """{kernel: {param: value}} -> sorted nested tuples (hashable)."""
    if not overrides:
        return ()
    if isinstance(overrides, tuple):  # may already be canonical; re-freeze
        overrides = {k: dict(v) for k, v in overrides}
    if not isinstance(overrides, Mapping):
        raise TypeError(
            f"overrides must be a mapping kernel -> params, got "
            f"{type(overrides).__name__}")
    out = []
    for kernel in sorted(overrides):
        if kernel not in KERNEL_NAMES:
            raise ValueError(
                f"unknown kernel {kernel!r} in overrides; known kernels: "
                f"{KERNEL_NAMES}")
        params = overrides[kernel]
        if not isinstance(params, Mapping):
            raise TypeError(
                f"overrides[{kernel!r}] must be a mapping param -> value")
        out.append((kernel, tuple(sorted(
            (str(k), _freeze_value(v)) for k, v in params.items()))))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class KernelPolicy:
    """Frozen, hashable kernel-routing policy (see the module docstring).
    Two problems that differ only in policy capture separate CUDA graphs,
    as they may launch different kernels."""

    backend: Backend = Backend.CUDA
    overrides: Tuple[Tuple[str, Tuple], ...] = ()
    tuning_cache: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "backend", _coerce_backend(self.backend))
        object.__setattr__(self, "overrides",
                           _freeze_overrides(self.overrides))
        if self.tuning_cache is not None:
            object.__setattr__(self, "tuning_cache", str(self.tuning_cache))

    @classmethod
    def coerce(cls, value: Union["KernelPolicy", Backend, str]) -> "KernelPolicy":
        """A policy from a policy (pass-through) or a backend name."""
        if isinstance(value, cls):
            return value
        return cls(backend=value)

    def override_for(self, kernel: str) -> dict:
        """This policy's parameter overrides for one kernel (may be {})."""
        for name, params in self.overrides:
            if name == kernel:
                return dict(params)
        return {}

    def with_backend(self, backend: Union[Backend, str]) -> "KernelPolicy":
        """Same policy, different ladder rung."""
        return dataclasses.replace(self, backend=_coerce_backend(backend))


DEFAULT_POLICY = KernelPolicy()
TORCH_POLICY = KernelPolicy(backend=Backend.TORCH)
CUDA_POLICY = KernelPolicy(backend=Backend.CUDA)
TUNED_POLICY = KernelPolicy(backend=Backend.TUNED)


def resolve_policy(backend=None, policy=None, *,
                   default: KernelPolicy = DEFAULT_POLICY,
                   stacklevel: int = 3) -> KernelPolicy:
    """The shim every ``kernels.ops`` entry point routes through:
    ``policy=`` wins, a legacy ``backend=`` string is wrapped (with a
    ``DeprecationWarning`` at frame ``stacklevel``: 3 is the caller of an
    ``ops`` function), neither gives ``default``. Both raise."""
    if policy is not None:
        if backend is not None:
            raise ValueError(
                "pass policy= OR the legacy backend=, not both")
        return KernelPolicy.coerce(policy)
    if backend is None:
        return default
    warnings.warn(
        "backend= strings on kernels.ops entry points are deprecated; "
        "pass policy=KernelPolicy(backend=...) (or a backend name via "
        "KernelPolicy.coerce) instead",
        DeprecationWarning, stacklevel=stacklevel)
    return KernelPolicy(backend=backend)
