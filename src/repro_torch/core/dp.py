"""TeraPipe's dynamic-programming slicing scheduler, paper §3.3–3.4
(reference: ``repro/core/dp.py``, copied: the port imports nothing of the
JAX package, not even its numpy-only modules).

Algorithm 1 with the two published optimizations (t_max candidates
ascending with the early stop K·t_max ≥ best T; ε-grid thinning), slice
lengths restricted to multiples of a granularity g, ``plan_prefill`` (the
same DP re-targeted at serving prefill under an SLO stall bound), the
schedule post-passes (``pad_slice_count``, ``ensure_executable``,
``plan_schedule_info``), the brute-force oracle the tests use, and the
joint batch × token optimization (§3.4: token DP per batch size, then an
exact 1-D knapsack over the batch).
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


def pad_slice_count(slices: Sequence[int], multiple_of: int, *,
                    granularity: int = 1) -> List[int]:
    """Split slices until ``len(slices) % multiple_of == 0``.

    Interleaved schedules (core/schedules) need the work-item count divisible
    by the pipe degree, but Algorithm 1 does not track the slice COUNT — so
    executability is restored as a post-pass: repeatedly split the largest
    slice at a granularity-aligned midpoint.  Splitting never raises t_max
    (each part <= the original), keeps Σ l_i = L, and preserves slice order,
    so the plan stays valid; Σ t_i may grow slightly (occupancy floor),
    which is the price of the constraint, not a bug.
    """
    out = list(slices)
    assert multiple_of >= 1
    while len(out) % multiple_of:
        j = max(range(len(out)), key=lambda i: out[i])
        if out[j] < 2 * granularity:
            raise ValueError(
                f"cannot split plan {list(slices)} into a multiple of "
                f"{multiple_of} slices at granularity {granularity}: largest "
                f"remaining slice is {out[j]}")
        a = (out[j] // (2 * granularity)) * granularity
        out[j:j + 1] = [a, out[j] - a]
    return out


def ensure_executable(slices: Sequence[int], *, schedule: str, n_ranks: int,
                      n_microbatches: int = 1,
                      granularity: int = 1) -> List[int]:
    """Post-pass making a planned slice list executable under ``schedule``.

    Algorithm 1 optimizes latency only; each schedule adds its own
    structural constraint on the plan:

    * ``contiguous`` — none; the plan is returned unchanged.
    * ``interleaved`` — work items advance in ring groups of K, so the
      work-item count D·M must divide by the pipe degree:
      :func:`pad_slice_count` splits the largest slices (never raises
      t_max) until ``(D·M) % K == 0``.
    * ``1f1b`` — the fwd+bwd table needs no divisibility (V=1), but every
      microbatch must have the SAME slice count M (the bwd turnaround is a
      single M in the timing) — true by construction here, since one plan
      is replicated across microbatches.  Returned unchanged.
    * ``interleaved-1f1b`` — both of the above: the interleaved group
      structure needs ``(D·M) % K == 0`` (split the largest slices), and
      the uniform slice count holds by construction.
    * ``zb-h1`` — 1f1b's constraints exactly (V=1, uniform M by
      construction); splitting each bwd into B + W units adds no structural
      requirement on the PLAN — the warmup depth and drain switch of its
      tick comb are derived from (K, M), not chosen by the DP.  Returned
      unchanged.

    Which names need the interleaved divisibility is read off the registry
    (``max_virtual is None`` marks the V>1 family), so a newly registered
    schedule states its constraint once.
    """
    from .schedules import REGISTRY
    out = list(slices)
    spec = REGISTRY.get(schedule)
    if spec is None:
        raise ValueError(
            f"unknown schedule {schedule!r}; registered: {list(REGISTRY)}")
    if spec.max_virtual is None and (n_microbatches * len(out)) % n_ranks:
        # D copies of the plan run; M only needs to clear K / gcd(D, K)
        need = n_ranks // np.gcd(n_microbatches, n_ranks)
        out = pad_slice_count(out, need, granularity=granularity)
    return out


def plan_schedule_info(slices: Sequence[int], *, schedule: str, n_ranks: int,
                       virtual_stages: int = 1,
                       n_microbatches: int = 1) -> dict:
    """What executing a planned slice list under ``schedule`` costs beyond
    the Eq. 5 objective — read straight off the schedule IR the executor
    interprets: the bubble weight the DP optimized against ((K-1)/V), and
    the memory geometry (``peak_live_items`` — D·M·V for autodiff-backward
    schedules, flat-in-D for the 1F1B family — plus the explicit-bwd
    residual ring depth).  For split-backward schedules (zb-h1) the peak
    replay honors the typed unit kinds: a residual slot is released by the
    unit's W tick, not its B tick, so ``peak_live_items`` already prices
    the deferred weight-grad window; ``units_per_item`` (3 = F/B/W vs
    2 = fwd + fused bwd vs 1 = fwd-only) names which geometry applies.
    train's ``--dp-plan`` prints it so a plan's memory consequence is
    visible next to its latency."""
    from .schedules import get_schedule
    assign = get_schedule(schedule, n_ranks=n_ranks, n_layers=1,
                          virtual_stages=virtual_stages,
                          n_microbatches=n_microbatches)
    n_items = n_microbatches * len(slices)
    info = {"bubble_weight": (n_ranks - 1) / virtual_stages,
            "peak_live_items": assign.peak_live_items(n_items),
            "units_per_item": assign.n_units(n_items) // max(1, n_items)}
    if assign.has_backward:
        info["residual_spread"] = assign.residual_spread(n_items)
        info["splits_backward"] = assign.splits_backward
    return info


def brute_force_slicing(t_fwd, L: int, K: int, *, granularity: int = 1
                        ) -> DPResult:
    """Exponential oracle for tests (L/g ≤ ~12)."""
    g = granularity
    n = L // g
    best = DPResult(np.inf, [], np.inf)

    def rec(remaining: int, acc: List[int]):
        nonlocal best
        if remaining == 0:
            ts = [t_fwd(l * g, c * g) for l, c in _iter_lc(acc)]
            lat = sum(ts) + (K - 1) * max(ts)
            if lat < best.latency:
                best = DPResult(lat, [l * g for l in acc], max(ts))
            return
        for l in range(1, remaining + 1):
            rec(remaining - l, acc + [l])

    rec(n, [])
    return best


# ---------------------------------------------------------------------------
# Joint batch × token optimization (paper §3.4)
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class JointResult:
    latency: float                          # Σ_d T_{b_d} (paper's objective)
    scheme: List[Tuple[int, List[int]]]     # [(b_d, [l_1..l_M]), ...]


def joint_batch_token(t_fwd_b: Callable[[int], Callable[[int, int], float]],
                      L: int, B: int, K: int, *,
                      granularity: int = 1, eps: float = 1e-4,
                      batch_candidates: Optional[Sequence[int]] = None,
                      objective: str = "pipeline",
                      virtual_stages: int = 1) -> JointResult:
    """Joint batch × token optimization.

    ``virtual_stages`` V scales the bubble term to (K-1)·t_max/V exactly as
    in :func:`optimal_slicing` (interleaved schedule, core/schedules).

    objective="paper": the paper's §3.4 formulation — token DP per batch size
    b giving T_b = S*_b + (K-1)·t_max_b, then a knapsack minimizing Σ_d T_{b_d}.
    This double-counts the pipeline bubble (each split pays its own
    (K-1)·t_max even though consecutive splits fill each other's bubbles).

    objective="pipeline" (default, beyond-paper): the bubble is global —
    the true latency of the concatenated schedule is
        Σ_d Σ_i t_i^{(d)} + (K-1)·max_{d,i} t_i^{(d)},
    so we enumerate the global t_max, run the bounded token DP per batch size
    under it, knapsack the Σ term only, and add (K-1)·t_max once.  Exact for
    the same execution model, strictly ≤ the paper objective's solution.
    """
    bs = list(batch_candidates or range(1, B + 1))
    bubble_w = (K - 1) / virtual_stages

    if objective == "paper":
        per_b = {b: optimal_slicing(t_fwd_b(b), L, K, granularity=granularity,
                                    eps=eps, virtual_stages=virtual_stages)
                 for b in bs}
        W = np.full(B + 1, np.inf)
        W[0] = 0.0
        choice = np.zeros(B + 1, dtype=np.int64)
        for x in range(1, B + 1):
            for b in bs:
                if b <= x and W[x - b] + per_b[b].latency < W[x]:
                    W[x] = W[x - b] + per_b[b].latency
                    choice[x] = b
        scheme, x = [], B
        while x > 0:
            b = int(choice[x])
            scheme.append((b, per_b[b].slices))
            x -= b
        return JointResult(float(W[B]), scheme)

    assert objective == "pipeline", objective
    g = granularity
    n = L // g
    mats = {b: _cost_matrix(t_fwd_b(b), L, g) for b in bs}
    vals = np.unique(np.concatenate(
        [m[np.isfinite(m)].ravel() for m in mats.values()]))
    cands, last = [], -np.inf
    for v in vals:
        if v >= last + eps:
            cands.append(float(v))
            last = v
    if len(vals) and cands[-1] != float(vals[-1]):   # see optimal_slicing
        cands.append(float(vals[-1]))

    best_latency, best_scheme = np.inf, None
    for t_max in cands:
        if bubble_w * t_max >= best_latency:
            break
        sums, slices_b = {}, {}
        for b in bs:
            total, sl = _dp_fixed_tmax(mats[b], n, t_max)
            if sl is not None:
                sums[b] = total
                slices_b[b] = sl
        if not sums:
            continue
        W = np.full(B + 1, np.inf)
        W[0] = 0.0
        choice = np.zeros(B + 1, dtype=np.int64)
        for x in range(1, B + 1):
            for b, s_cost in sums.items():
                if b <= x and W[x - b] + s_cost < W[x]:
                    W[x] = W[x - b] + s_cost
                    choice[x] = b
        if not np.isfinite(W[B]):
            continue
        # true max over chosen splits (≤ t_max)
        scheme, x = [], B
        while x > 0:
            b = int(choice[x])
            scheme.append((b, [l * g for l in slices_b[b]]))
            x -= b
        real_tmax = max(mats[b][l // g, c // g]
                        for b, sl in scheme for l, c in _iter_lc_units(sl, g))
        latency = float(W[B]) + bubble_w * real_tmax
        if latency < best_latency:
            best_latency, best_scheme = latency, scheme
    return JointResult(best_latency, best_scheme)


def _iter_lc_units(slices, g):
    c = 0
    for l in slices:
        yield l, c
        c += l
