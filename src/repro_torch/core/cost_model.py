"""Subdivision cost model for Self-Similar-Density (SSD) workloads.

Faithful implementation of Section 4 of:
  "Modeling GPU Dynamic Parallelism for Self Similar Density Workloads"
  (Quezada, Navarro, Romero, Aguilera, 2022).

Equation map (paper -> code):
  Eq. (2)   W_E = n^2 A                         -> ``w_exhaustive``
  Eq. (16)  general W_S with per-level P_i      -> ``w_subdivision_general``
  Eq. (20)  W_SSD^M (Mandelbrot/SSD form)       -> ``w_ssd_mandelbrot``
  Eq. (21)  Omega = W_E / W_SSD^M               -> ``omega``
  Eq. (22)  T_Ex  = ceil(n^2/(qc)) A            -> ``t_exhaustive``
  Eq. (23)  T_SBR                               -> ``t_sbr``
  Eq. (24)  T_MBR                               -> ``t_mbr``
  Eq. (25)  S_SBR, S_MBR                        -> ``speedup_sbr``/``speedup_mbr``

Everything is plain NumPy (float64) and vectorises over candidate
{g, r, B} triples so that the optimal-parameter search (paper Sec. 4.2.2,
Figs. 3/4) is a single broadcast evaluation.

Machine-model note: ``q`` is the number of independent multiprocessors
and ``c`` the synchronized cores per multiprocessor. The paper
instantiates q=128, c=64 for a modern GPU (an H100 has 132 SMs).

This module is a copy of ``repro/core/cost_model.py`` (numpy only): the
port never imports the JAX package, and tests/test_torch_ref.py holds the
two result for result.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable, Sequence

import numpy as np

__all__ = [
    "SSDParams",
    "Machine",
    "tau_levels",
    "num_levels",
    "expected_level_counts",
    "w_exhaustive",
    "w_subdivision_general",
    "w_ssd_mandelbrot",
    "omega",
    "t_exhaustive",
    "t_sbr",
    "t_mbr",
    "speedup_sbr",
    "speedup_mbr",
    "grb_space",
    "search_optimal_grb",
    "GRBResult",
]


@dataclasses.dataclass(frozen=True)
class SSDParams:
    """Parameters of an SSD workload instance (paper Sec. 4.2.1)."""

    n: int  # domain is n x n
    A: float  # application work per element (Mandelbrot: the dwell)
    P: float  # per-level subdivision probability, P in [0, 1]
    lam: float  # subdivision overhead S = lam * A   (paper: lambda)


@dataclasses.dataclass(frozen=True)
class Machine:
    """Two-level machine model (paper Sec. 4.3)."""

    q: int = 128  # multiprocessors (no inter-MP sync during a kernel)
    c: int = 64  # synchronized cores per multiprocessor


# ---------------------------------------------------------------------------
# depth
# ---------------------------------------------------------------------------

def tau_levels(n, g, r, B):
    """tau = log_r(n / (g B)) -- assumption iii) of Sec. 4.2.1.

    Vectorised; returns float tau (callers floor it). A configuration is
    only meaningful when tau >= 2 (at least one interior level + a last
    level); callers use ``valid_grb``.
    """
    n = np.asarray(n, dtype=np.float64)
    g = np.asarray(g, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.log(n / (g * B)) / np.log(r)


def num_levels(n: int, g: int, r: int, B: int) -> int:
    """Integer exploration-level count: subdivide while region side > B.

    The single definition shared by the ASK engines
    (``repro_torch.core.ask`` calls it) and the occupancy
    model below -- the floor() of ``tau_levels`` for exact chains.
    """
    levels = 0
    side = n // g
    while side > B:
        levels += 1
        side //= r
    return levels


def expected_level_counts(n: int, g: int, r: int, B: int, P: float = 0.7):
    """Expected live-OLT occupancy entering each level of an ASK run.

    E_0 = g^2 (all roots live); each live region subdivides with
    probability P into r^2 children (assumption ii of Sec. 4.2.1), so
    E_l = g^2 (r^2 P)^l, clamped to the exhaustive level grid (g r^l)^2.
    Returns a list of length tau+1: entries 0..tau-1 are the exploration
    levels, entry tau the expected leaf-OLT occupancy. This is what sizes
    the bounded ring of the scan engine (``core.ask.scan_capacities``:
    capacity = occupancy x safety factor), replacing the fused engine's
    worst-case per-level buffers.
    """
    levels = num_levels(n, g, r, B)
    out = []
    for lv in range(levels + 1):
        expected = float(g * g) * (r * r * P) ** lv
        worst = float((g * r ** lv) ** 2)
        out.append(min(expected, worst))
    return out


def valid_grb(n, g, r, B):
    """A {g,r,B} triple is admissible when the subdivision tree is non-empty
    and the last-level regions are at least one pixel."""
    t = tau_levels(n, g, r, B)
    g = np.asarray(g, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    n = np.asarray(n, dtype=np.float64)
    return (t >= 2.0) & (g * B <= n) & (g <= n) & (B >= 1)


# ---------------------------------------------------------------------------
# work (Sec. 4.1 / 4.2)
# ---------------------------------------------------------------------------

def w_exhaustive(n, A):
    """Eq. (2): W_E = n^2 * A."""
    n = np.asarray(n, dtype=np.float64)
    return n * n * np.asarray(A, dtype=np.float64)


def w_subdivision_general(
    n: int,
    probabilities: Sequence[float],
    *,
    Q: Sequence[float],
    S: Sequence[float],
    T: Sequence[float],
    A: float,
    G: int,
    R: int,
) -> float:
    """Eq. (16): general subdivision work with per-level quantities.

    ``probabilities[i]``, ``Q[i]``, ``S[i]``, ``T[i]`` are per level
    i = 0..tau-2 (len == tau-1). The last level contributes
    n^2 A prod_{j<=tau-2} P_j.
    """
    tau_m1 = len(probabilities)
    if not (len(Q) == len(S) == len(T) == tau_m1):
        raise ValueError("per-level sequences must share length tau-1")
    total = 0.0
    prob_prefix = 1.0  # prod_{j=0}^{i-1} P_j
    for i in range(tau_m1):
        P_i = probabilities[i]
        U_i = P_i * (Q[i] + S[i]) + (1.0 - P_i) * (Q[i] + T[i])
        total += U_i * G * (R ** i) * prob_prefix  # Eq. (12)
        prob_prefix *= P_i
    total += (n ** 2) * A * prob_prefix  # Eq. (14): prod over j=0..tau-2
    return total


def _level_arrays(n, g, r, B):
    """Shared per-level machinery. Broadcasts g/r/B; returns
    (tau_int [..], i [L, 1..] level indices, mask [L, ..]) where L is the
    max level count across the candidate set."""
    g = np.asarray(g, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    t = np.floor(tau_levels(n, g, r, B))
    t = np.where(np.isfinite(t), t, 0.0)
    t = np.maximum(t, 0.0)
    L = int(np.max(t)) if t.size else 0
    L = max(L - 1, 0)  # interior levels i = 0..tau-2  -> tau-1 of them
    i = np.arange(max(L, 1), dtype=np.float64)
    i = i.reshape((-1,) + (1,) * t.ndim)
    mask = i <= (t - 2.0)  # include level i iff i <= tau-2
    return t, i, mask


def w_ssd_mandelbrot(n, A, P, lam, g, r, B):
    """Eq. (20): W_SSD^M.

    Q_i = 4 n A / (g r^i)      (perimeter dwell at level i)
    S   = lam A                (subdivision overhead, relative to A)
    T_i = n^2 / (G R^i)        (constant write over the region)
    Vectorised over g/r/B arrays (broadcast against each other).
    """
    n_f = float(n)
    A = float(A)
    P = float(P)
    lam = float(lam)
    g = np.asarray(g, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    G = g * g
    R = r * r

    t, i, mask = _level_arrays(n_f, g, r, B)

    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        Q_i = 4.0 * n_f * A / (g * np.power(r, i))
        T_i = (n_f * n_f) / (G * np.power(R, i))
        U_i = Q_i + P * (lam * A) + (1.0 - P) * T_i
        K_i = U_i * G * np.power(R, i) * np.power(P, i)  # Eq. (19) x P^i
        K = np.sum(np.where(mask, K_i, 0.0), axis=0)
        # last level: n^2 A P^(tau-1)
        L_term = (n_f * n_f) * A * np.power(P, np.maximum(t - 1.0, 0.0))
    W = K + L_term
    # Degenerate trees (tau < 2) fall back to exhaustive work.
    return np.where(valid_grb(n_f, g, r, B), W, w_exhaustive(n_f, A))


def omega(n, A, P, lam, g, r, B):
    """Eq. (21): work-reduction factor Omega = W_E / W_SSD^M."""
    return w_exhaustive(n, A) / w_ssd_mandelbrot(n, A, P, lam, g, r, B)


# ---------------------------------------------------------------------------
# parallel time (Sec. 4.3)
# ---------------------------------------------------------------------------

def t_exhaustive(n, A, machine: Machine = Machine()):
    """Eq. (22): T_Ex = ceil(n^2/(q c)) * A."""
    n = np.asarray(n, dtype=np.float64)
    return np.ceil(n * n / (machine.q * machine.c)) * float(A)


def t_sbr(n, A, P, lam, g, r, B, machine: Machine = Machine()):
    """Eq. (23): single-block-per-region parallel time."""
    n_f, A, P, lam = float(n), float(A), float(P), float(lam)
    q, c = float(machine.q), float(machine.c)
    g = np.asarray(g, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    G, R = g * g, r * r
    t, i, mask = _level_arrays(n_f, g, r, B)

    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        q_term = np.ceil(4.0 * n_f / (g * np.power(r, i) * c)) * A
        s_term = P * lam * A
        t_term = (1.0 - P) * np.ceil(n_f * n_f / (G * np.power(R, i) * c))
        blocks = np.ceil(G * np.power(R, i) / q)
        level_t = (q_term + s_term + t_term) * blocks * np.power(P, i)
        T = np.sum(np.where(mask, level_t, 0.0), axis=0)
        # last level
        R_last = G * np.power(R, np.maximum(t - 1.0, 0.0))
        T += (
            A
            * np.ceil(n_f * n_f / (R_last * c))
            * np.ceil(R_last / q)
            * np.power(P, np.maximum(t - 1.0, 0.0))
        )
    return np.where(valid_grb(n_f, g, r, B), T, t_exhaustive(n_f, A, machine))


def t_mbr(n, A, P, lam, g, r, B, machine: Machine = Machine()):
    """Eq. (24): multiple-blocks-per-region parallel time.

    Q_i and the subdivision term keep the SBR mapping (little parallelism);
    T_i and L are spread over all q*c cores.
    """
    n_f, A, P, lam = float(n), float(A), float(P), float(lam)
    q, c = float(machine.q), float(machine.c)
    g = np.asarray(g, dtype=np.float64)
    r = np.asarray(r, dtype=np.float64)
    B = np.asarray(B, dtype=np.float64)
    G, R = g * g, r * r
    S = lam * A
    t, i, mask = _level_arrays(n_f, g, r, B)

    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        blocks = np.ceil(G * np.power(R, i) / q)
        term_q = np.ceil(4.0 * n_f / (g * np.power(r, i) * c)) * blocks * A * np.power(P, i)
        term_s = blocks * S * np.power(P, i + 1.0)
        term_t = np.ceil(n_f * n_f * np.power(P, i) * (1.0 - P) / (q * c))
        level_t = term_q + term_s + term_t
        T = np.sum(np.where(mask, level_t, 0.0), axis=0)
        T += A * np.ceil(n_f * n_f / (q * c)) * np.power(P, np.maximum(t - 1.0, 0.0))
    return np.where(valid_grb(n_f, g, r, B), T, t_exhaustive(n_f, A, machine))


def speedup_sbr(n, A, P, lam, g, r, B, machine: Machine = Machine()):
    """Eq. (25): S_SBR = T_Ex / T_SBR."""
    return t_exhaustive(n, A, machine) / t_sbr(n, A, P, lam, g, r, B, machine)


def speedup_mbr(n, A, P, lam, g, r, B, machine: Machine = Machine()):
    """Eq. (25): S_MBR = T_Ex / T_MBR."""
    return t_exhaustive(n, A, machine) / t_mbr(n, A, P, lam, g, r, B, machine)


# ---------------------------------------------------------------------------
# optimal {g, r, B} search (paper: space {2, 4, ..., 1024})
# ---------------------------------------------------------------------------

def grb_space(lo: int = 2, hi: int = 1024) -> np.ndarray:
    """The paper's search space: powers of two in [2, 1024]."""
    return np.array([2 ** k for k in range(int(math.log2(lo)), int(math.log2(hi)) + 1)],
                    dtype=np.int64)


@dataclasses.dataclass(frozen=True)
class GRBResult:
    g: int
    r: int
    B: int
    value: float  # metric at the optimum (work or time)
    metric: str


_METRICS = {
    "work": w_ssd_mandelbrot,
    "sbr": t_sbr,
    "mbr": t_mbr,
}


def search_optimal_grb(
    params: SSDParams,
    metric: str = "work",
    machine: Machine = Machine(),
    space: Iterable[int] | None = None,
) -> GRBResult:
    """Exhaustive search of the {g, r, B} space minimising work or parallel
    time (the paper always reports the per-n optimum; Figs. 3/4)."""
    sp = np.asarray(list(space) if space is not None else grb_space())
    gg, rr, bb = np.meshgrid(sp, sp, sp, indexing="ij")
    fn = _METRICS[metric]
    if metric == "work":
        vals = fn(params.n, params.A, params.P, params.lam, gg, rr, bb)
    else:
        vals = fn(params.n, params.A, params.P, params.lam, gg, rr, bb, machine)
    ok = valid_grb(params.n, gg, rr, bb)
    vals = np.where(ok, vals, np.inf)
    if not np.isfinite(vals).any():
        # No admissible subdivision: report the degenerate exhaustive point.
        return GRBResult(int(sp[0]), int(sp[0]), int(sp[0]),
                         float(w_exhaustive(params.n, params.A)), metric)
    flat = int(np.argmin(vals))
    idx = np.unravel_index(flat, vals.shape)
    return GRBResult(
        g=int(gg[idx]), r=int(rr[idx]), B=int(bb[idx]),
        value=float(vals[idx]), metric=metric,
    )
