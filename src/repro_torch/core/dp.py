"""TeraPipe's dynamic-programming slicing scheduler, the parts serving needs
(reference: ``repro/core/dp.py:25-200``, copied: the port imports nothing
of the JAX package, not even its numpy-only modules).

Algorithm 1 (paper §3.3) with the ε-grid thinning of t_max candidates, and
``plan_prefill``, its re-targeting at serving prefill under an SLO stall
bound.  The joint batch×token optimisation, the schedule post-passes and
the brute-force oracle arrive with the planning slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class DPResult:
    latency: float                 # T* (Eq. 5)
    slices: List[int]              # l_1..l_M (sum = L)
    t_max: float                   # the enumerated bound achieving T*
    n_tmax_evaluated: int = 0


def _cost_matrix(t_fwd: Callable[[int, int], float], L: int, g: int) -> np.ndarray:
    """T[a, b] = t_fwd(a*g, b*g) for a in 1..n, b in 0..n-1 (units of g).

    Vectorized when ``t_fwd`` accepts array arguments (every CostModel here
    does — they are closed-form ufunc expressions): one broadcast evaluation
    over the whole (n+1, n) grid instead of O(n²) interpreter-bound Python
    calls (65k+ for L=2048, g=8).  Falls back to the loop for scalar-only
    callables (e.g. table lookups in the tests)."""
    n = L // g
    T = np.full((n + 1, n), np.inf)
    a = np.arange(1, n + 1)[:, None]           # slice length (units)
    b = np.arange(0, n)[None, :]               # context start (units)
    valid = b <= n - a                         # slice must fit in L
    try:
        vals = np.asarray(t_fwd(a * g, b * g), dtype=np.float64)
        if vals.shape != (n, n):
            raise TypeError(f"shape {vals.shape}")
    except Exception:
        for ai in range(1, n + 1):
            for bi in range(0, n - ai + 1):
                T[ai, bi] = t_fwd(ai * g, bi * g)
        return T
    T[1:, :] = np.where(valid, vals, np.inf)
    return T


def _dp_fixed_tmax(T: np.ndarray, n: int, t_max: float
                   ) -> Tuple[float, Optional[List[int]]]:
    """Algorithm 1: min Σ t_i s.t. every t_i ≤ t_max, slices in g-units."""
    S = np.full(n + 1, np.inf)
    S[0] = 0.0
    arg = np.zeros(n + 1, dtype=np.int64)
    ks = np.arange(1, n + 1)
    for i in range(1, n + 1):
        k = ks[:i]                      # slice length candidates (units)
        cand = S[i - k] + np.where(T[k, i - k] <= t_max, T[k, i - k], np.inf)
        j = int(np.argmin(cand))
        S[i] = cand[j]
        arg[i] = j + 1
    if not np.isfinite(S[n]):
        return np.inf, None
    slices, i = [], n
    while i > 0:
        slices.append(int(arg[i]))
        i -= int(arg[i])
    slices.reverse()
    return float(S[n]), slices


def optimal_slicing(t_fwd: Callable[[int, int], float], L: int, K: int, *,
                    granularity: int = 1, eps: float = 1e-4,
                    virtual_stages: int = 1) -> DPResult:
    """Find l_1..l_M minimizing  Σ t_i + w·max_j t_j  with w = (K-1)/V.

    V=1 is the paper's Eq. 5/6.  With V virtual stages per rank (interleaved
    schedule, core/schedules) the effective pipeline is K·V chunk-stages each
    costing t_i/V, so the fill/drain term shrinks to (K-1)·t_max/V while the
    Σ term is unchanged (every rank still does t_i of total work per item).
    The smaller bubble weight shifts the optimum toward fewer, longer slices
    for bubble-dominated shapes (long slices amortize the occupancy floor).
    """
    g = granularity
    assert L % g == 0, (L, g)
    assert virtual_stages >= 1, virtual_stages
    bubble_w = (K - 1) / virtual_stages
    n = L // g
    T = _cost_matrix(t_fwd, L, g)

    # candidate t_max values: all achievable t_fwd(k, i-k), ascending, ε-thinned
    vals = np.unique(T[np.isfinite(T)])
    cands = []
    last = -np.inf
    for v in vals:
        if v >= last + eps:
            cands.append(float(v))
            last = v
    # the largest value must survive thinning: it is always feasible, so the
    # DP cannot come back empty when eps exceeds the whole cost range (e.g.
    # microsecond-scale analytic costs with the default eps)
    if len(vals) and cands[-1] != float(vals[-1]):
        cands.append(float(vals[-1]))
    best = DPResult(np.inf, [], np.inf)
    evaluated = 0
    for t_max in cands:
        # early stop (paper's optimization): latency >= Σt_i + w·t_max
        # >= (1 + w)·t_max  (Σ includes the max slice); (1+w) = K at V=1
        if (1 + bubble_w) * t_max >= best.latency:
            break
        evaluated += 1
        total, slices = _dp_fixed_tmax(T, n, t_max)
        if slices is None:
            continue
        # true max over the chosen slices (≤ t_max, possibly smaller)
        real_tmax = max(T[l, c] for l, c in _iter_lc(slices))
        latency = total + bubble_w * real_tmax
        if latency < best.latency:
            best = DPResult(latency, [l * g for l in slices], real_tmax)
    best.n_tmax_evaluated = evaluated
    return best


def plan_prefill(t_fwd: Callable[[int, int], float], L: int, K: int, *,
                 granularity: int = 1, eps: float = 1e-4,
                 slo_tmax: Optional[float] = None) -> DPResult:
    """Algorithm 1 re-targeted at SERVING prefill (repro.serve).

    Training optimizes one objective: step latency (Eq. 5).  A serving
    engine chunks each request's prefill and interleaves the chunks with
    the decode rounds of already-running requests, so the chunk plan trades
    TWO objectives: Σ t_i (the new request's time-to-first-token — fewer,
    longer chunks amortize per-chunk overhead) against max t_i (the stall a
    chunk inflicts on every in-flight request's inter-token latency — a
    long chunk blocks the next token-synchronous decode round).

    ``slo_tmax`` is the knob: the largest per-chunk stall the running
    requests' latency SLO tolerates (seconds, same unit as ``t_fwd``).
    The DP minimizes Eq. 5's objective over only the t_max candidates
    ≤ ``slo_tmax`` — i.e. best TTFT subject to the stall bound.  With
    ``slo_tmax=None`` (pure-throughput mode) this is exactly
    :func:`optimal_slicing`.  If NO plan satisfies the SLO (even single
    granules stall longer than allowed, or no SLO-feasible bound tiles
    the whole length), the constraint is dropped and the unconstrained
    optimum returned as best effort — the engine cannot refuse to
    prefill.
    """
    if slo_tmax is None:
        return optimal_slicing(t_fwd, L, K, granularity=granularity, eps=eps)
    g = granularity
    assert L % g == 0, (L, g)
    n = L // g
    T = _cost_matrix(t_fwd, L, g)
    vals = np.unique(T[np.isfinite(T)])
    feasible = [float(v) for v in vals if v <= slo_tmax]
    if not feasible:
        # SLO unsatisfiable even by single granules: drop the constraint
        return optimal_slicing(t_fwd, L, K, granularity=g, eps=eps)
    cands, last = [], -np.inf
    for v in feasible:
        if v >= last + eps:
            cands.append(v)
            last = v
    if cands[-1] != feasible[-1]:    # largest must survive thinning
        cands.append(feasible[-1])
    best = DPResult(np.inf, [], np.inf)
    evaluated = 0
    for t_max in cands:
        if K * t_max >= best.latency:    # early stop, as optimal_slicing
            break
        evaluated += 1
        total, slices = _dp_fixed_tmax(T, n, t_max)
        if slices is None:
            continue
        real_tmax = max(T[l, c] for l, c in _iter_lc(slices))
        latency = total + (K - 1) * real_tmax
        if latency < best.latency:
            best = DPResult(latency, [l * g for l in slices], real_tmax)
    if not best.slices:
        # every SLO-feasible t_max admitted no full tiling (late-context
        # granules alone exceed the bound): best effort = minimal stall
        return optimal_slicing(t_fwd, L, K, granularity=g, eps=eps)
    best.n_tmax_evaluated = evaluated
    return best


def _iter_lc(slices_units: Sequence[int]):
    c = 0
    for l in slices_units:
        yield l, c
        c += l
