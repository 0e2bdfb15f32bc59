"""Event-driven pipeline latency simulator (reference:
``repro/core/simulator.py``, copied whole: the port imports nothing of the
JAX package).

Evaluates a :class:`SlicingScheme` on a K-stage pipeline under a cost model.
Two engines:

* ``async`` — GPU-style (the paper's): each stage starts a work item as soon
  as its input arrives and the stage is free.  Reproduces Eq. 5 exactly for
  a single batch split: T = Σ t_i + (K-1) max t_i.
* **table-driven lockstep** — TPU SPMD-style: all stages advance
  tick-by-tick (ppermute is a global collective), so tick duration = max
  over active ranks of the unit cost.  EVERY lockstep discipline is priced
  from the SAME schedule-IR tick table the executor interprets
  (``core/schedules``): build the discipline's :class:`StageAssignment`,
  read its ``tick_table``, charge ``t_item/V`` per fwd chunk unit and
  ``t_bwd/V`` per bwd unit, and sum per-tick maxima.  Registered lockstep
  disciplines:

  - ``lockstep`` — the contiguous (V=1) fwd table;
  - ``interleaved`` — V virtual stages per rank: fill/drain ticks cost 1/V
    of a full stage, the bubble shrinks ~V×;
  - ``1f1b`` — explicit bwd units (``schedules.OneFOneB``): tick COUNT
    matches the contiguous fwd+bwd program up to a 2(M-1) per-microbatch
    bwd turnaround, but 1F1B mixes fwd and bwd units within every
    steady-state tick (rank parity), so with bwd ≈ 2·fwd every such tick
    costs a bwd — the memory bound is paid with a latency premium the
    simulator reports honestly.  Implies fwd+bwd
    (``include_backward=True`` required); requires uniform splits.
  - ``interleaved-1f1b`` — the skew-buffered interleaved 1F1B table
    (``schedules.InterleavedOneFOneB``): the same parity mix, but
    chunk-sized (1/V) fill/drain — a strictly smaller bubble fraction than
    plain 1f1b on the same scheme.
  - ``streaming`` — the fwd-only serving flow
    (``schedules.StreamingSchedule``): each work item is one queue unit
    (prefill chunk or decode round); :func:`simulate_stream` additionally
    reports TTFT and inter-token latency per request.
  - ``zb-h1`` — the zero-bubble split-backward table
    (``schedules.ZeroBubbleH1``): B (input-grad) and W (weight-grad) units
    priced separately, so no tick pays more than max(fwd, B, W) — the
    2P+3.5A fused-bwd tick ceiling of the 1f1b family drops to P+2A.

  The engine prices units BY KIND (the tick table's typed third column):
  fwd units ``t_item/V``, fused bwd units ``bwd/V``, split B / W units
  ``b/V`` / ``w/V``.  Which explicit-bwd disciplines exist comes from the
  schedule REGISTRY (``has_backward``), not a hard-coded list.

Backward units default to ``BWD_COST_FACTOR ×`` their item's forward
(split B and W to ``BWD_INPUT_COST_FACTOR`` / ``BWD_WEIGHT_COST_FACTOR ×``
forward); pass ``t_bwd_of`` / ``t_bwd_input_of`` / ``t_bwd_weight_of``
(e.g. a measured ``CostModel``) to price them from the fused-kernel cost
model instead.

Supports per-stage slowdown factors (straggler studies / DP-based
re-planning) and fwd+bwd symmetric simulation.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .schedule import SlicingScheme
from .schedules import (KIND_BWD, KIND_BWD_INPUT, KIND_BWD_WEIGHT, KIND_FWD,
                        REGISTRY, StageAssignment, StreamingSchedule,
                        get_schedule)

#: bwd ≈ 2·fwd (two matmuls per fwd matmul), the convention _work_items uses
BWD_COST_FACTOR = 2.0
#: default split of that convention over B / W unit kinds (× the item's
#: forward; they sum to BWD_COST_FACTOR so split schedules pay exactly what
#: fused ones do, rearranged)
BWD_INPUT_COST_FACTOR = 1.0
BWD_WEIGHT_COST_FACTOR = 1.0


def _work_items(scheme: SlicingScheme, t_of, include_backward: bool):
    """Flatten the scheme into per-tick durations (fwd order).

    Returns list of durations t_i; backward is appended reversed with 2x cost
    (symmetric pipeline, bwd ≈ 2·fwd).
    """
    items = []
    for b, ls in scheme.splits:
        ctx = 0
        for l in ls:
            items.append(t_of(b, l, ctx))
            ctx += l
    if include_backward:
        items = items + [2.0 * t for t in reversed(items)]
    return items


def _bwd_work_items(scheme: SlicingScheme, t_bwd_of) -> Optional[list]:
    """Per-item BACKWARD-unit durations in fwd item order (for the explicit
    bwd tables), from a ``t_bwd_of(b, l, ctx)`` callable — e.g. a measured
    ``CostModel.t_bwd`` wrapped per batch; None keeps the
    ``BWD_COST_FACTOR`` convention."""
    if t_bwd_of is None:
        return None
    items = []
    for b, ls in scheme.splits:
        ctx = 0
        for l in ls:
            items.append(t_bwd_of(b, l, ctx))
            ctx += l
    return items


def _async_total(items, K: int, slow) -> float:
    """Async (GPU-style) finish time of the flattened work-item durations."""
    M = len(items)
    finish = np.zeros((K, M))
    for k in range(K):
        for i in range(M):
            prev_same_stage = finish[k, i - 1] if i > 0 else 0.0
            prev_same_item = finish[k - 1, i] if k > 0 else 0.0
            start = max(prev_same_stage, prev_same_item)
            finish[k, i] = start + items[i] * slow[k]
    return float(finish[-1, -1])


def _lockstep_loop(items, K: int, slow) -> float:
    """Scalar-loop reference for the lockstep discipline (pre-vectorization);
    kept for differential testing against the table pricer."""
    M = len(items)
    total = 0.0
    for t in range(M + K - 1):
        active = [items[t - k] * slow[k] for k in range(K) if 0 <= t - k < M]
        total += max(active)
    return float(total)


def _unit_prices(items, bwd_items=None, b_items=None, w_items=None):
    """Per-item durations for each unit kind, with defaults layered so that
    ``B + W == fused`` always holds (split schedules pay exactly the fused
    work, rearranged): fused bwd defaults to ``BWD_COST_FACTOR × fwd``; B
    defaults to an explicit ``b_items``, else half the explicit fused price,
    else ``BWD_INPUT_COST_FACTOR × fwd``; W defaults to the remainder
    ``fused - B``.  Returns ``(f, fused, b, w)`` numpy arrays in fwd item
    order."""
    f = np.asarray(items, np.float64)
    fused = (f * BWD_COST_FACTOR if bwd_items is None
             else np.asarray(bwd_items, np.float64))
    if b_items is not None:
        b = np.asarray(b_items, np.float64)
    elif bwd_items is not None:
        b = fused / 2.0
    else:
        b = f * BWD_INPUT_COST_FACTOR
    w = (fused - b if w_items is None
         else np.asarray(w_items, np.float64))
    return f, fused, b, w


def _table_total(assign: StageAssignment, items, slow, bwd_items=None,
                 b_items=None, w_items=None) -> float:
    """Price ANY lockstep schedule from its tick table — the single engine
    every table discipline goes through (the same
    ``(tick, rank) -> (work_item, chunk, kind)`` surface the executor
    interprets).  Units are priced BY KIND: a fwd unit of item i costs
    ``items[i]/V`` (layer chunks are 1/V of a rank's stack), a fused bwd
    unit ``bwd_items[i]/V``, and the zero-bubble split pair B / W
    ``b_items[i]/V`` / ``w_items[i]/V`` (defaults: see
    :func:`_unit_prices`).  Tick duration = max over active ranks; one
    numpy broadcast over the whole (ticks, K) grid replaces an O(ticks·K)
    interpreter loop (cf. ``dp._cost_matrix``)."""
    f, fused, b, w = _unit_prices(items, bwd_items, b_items, w_items)
    V = assign.virtual_stages
    tab = assign.tick_table(f.size)
    i, kind = tab[..., 0], tab[..., 2]
    ic = np.clip(i, 0, f.size - 1)
    per_kind = np.select(
        [kind == KIND_FWD, kind == KIND_BWD, kind == KIND_BWD_INPUT,
         kind == KIND_BWD_WEIGHT],
        [f[ic], fused[ic], b[ic], w[ic]], default=0.0)
    dur = np.where(i >= 0, per_kind * (np.asarray(slow)[None, :] / V), 0.0)
    return float(dur.max(axis=1).sum())


def _lockstep_total(items, K: int, V: int, slow) -> float:
    """Back-compat shim: the fwd-only (contiguous / interleaved) table."""
    return _table_total(StageAssignment(n_ranks=K, virtual_stages=V,
                                        n_layers=1), items, slow)


def _explicit_bwd(discipline: str) -> bool:
    """True for disciplines whose tick table schedules backward units
    explicitly — read from the schedule REGISTRY (``has_backward``), so a
    newly registered explicit-bwd schedule is a simulator discipline with
    no simulator edits."""
    spec = REGISTRY.get(discipline)
    return spec is not None and spec.has_backward


def _discipline_total(items, K: int, discipline: str, virtual_stages: int,
                      slow, n_microbatches: int = 1, bwd_items=None,
                      b_items=None, w_items=None) -> float:
    """Dispatch flattened work-item durations to one discipline engine —
    the single place a new discipline gets wired in.  Table disciplines
    build their schedule-IR assignment (the registry factories in
    ``core/schedules``) and price its tick table.  For the explicit-bwd
    disciplines, ``items`` must be the fwd-only durations (the bwd table is
    explicit; ``bwd_items``/``b_items``/``w_items`` optionally price the
    fused-bwd / B / W units)."""
    if discipline == "async":
        assert virtual_stages == 1, \
            "async discipline models the contiguous (V=1) schedule only"
        return _async_total(items, K, slow)
    if discipline == "lockstep":
        assert virtual_stages == 1, \
            "use discipline='interleaved' for V>1 lockstep schedules"
        return _lockstep_total(items, K, 1, slow)
    if discipline == "streaming":
        # the serving flow: each flattened work item is one queue unit of
        # the fwd-only streaming table (contiguous V=1 flow, no backward
        # ever) — the lockstep price of pushing the queue through K stages
        assert virtual_stages == 1, \
            "streaming is a V=1 schedule (single-token decode units)"
        return _table_total(StreamingSchedule(n_ranks=K, virtual_stages=1,
                                              n_layers=1), items, slow)
    if discipline == "interleaved":
        return _lockstep_total(items, K, virtual_stages, slow)
    if _explicit_bwd(discipline):
        assign = get_schedule(discipline, n_ranks=K, n_layers=1,
                              virtual_stages=virtual_stages,
                              n_microbatches=n_microbatches)
        return _table_total(assign, items, slow, bwd_items=bwd_items,
                            b_items=b_items, w_items=w_items)
    raise ValueError(discipline)


def _one_f_one_b_groups(scheme: SlicingScheme) -> int:
    """Microbatch count D for the 1F1B tables; requires uniform slice counts
    (the per-microbatch bwd turnaround is a single M in the timing)."""
    counts = [len(ls) for _, ls in scheme.splits]
    assert len(set(counts)) == 1, (
        f"1f1b disciplines need a uniform slice count per split, "
        f"got {counts}")
    return len(counts)


def simulate(scheme: SlicingScheme, K: int, t_of, *,
             discipline: str = "async", include_backward: bool = False,
             stage_slowdown: Optional[Sequence[float]] = None,
             virtual_stages: int = 1, t_bwd_of=None, t_bwd_input_of=None,
             t_bwd_weight_of=None) -> float:
    """t_of(b, l, ctx) -> seconds for one stage.  Returns total latency.
    ``t_bwd_of(b, l, ctx)`` (explicit-bwd disciplines only) prices fused
    backward units from a real cost model (``CostModel.t_bwd``) instead of
    the ``BWD_COST_FACTOR`` convention; ``t_bwd_input_of`` /
    ``t_bwd_weight_of`` likewise price the split B / W units
    (``CostModel.t_bwd_input`` / ``t_bwd_weight``)."""
    slow = np.ones(K) if stage_slowdown is None else np.asarray(stage_slowdown)
    assert len(slow) == K
    if _explicit_bwd(discipline):
        # the explicit-bwd tables ARE the fwd+bwd program; bwd costs are
        # applied per unit inside the engine, not by appending reversed items
        assert include_backward, \
            f"{discipline} is inherently fwd+bwd; pass include_backward=True"
        items = _work_items(scheme, t_of, include_backward=False)
        return _discipline_total(
            items, K, discipline, virtual_stages, slow,
            n_microbatches=_one_f_one_b_groups(scheme),
            bwd_items=_bwd_work_items(scheme, t_bwd_of),
            b_items=_bwd_work_items(scheme, t_bwd_input_of),
            w_items=_bwd_work_items(scheme, t_bwd_weight_of))
    assert t_bwd_of is None and t_bwd_input_of is None \
        and t_bwd_weight_of is None, \
        "t_bwd_of/t_bwd_input_of/t_bwd_weight_of price explicit bwd units; " \
        "only the 1f1b-family disciplines schedule them"
    items = _work_items(scheme, t_of, include_backward)
    return _discipline_total(items, K, discipline, virtual_stages, slow)


def bubble_fraction(scheme: SlicingScheme, K: int, t_of, *,
                    discipline: str = "lockstep", virtual_stages: int = 1,
                    include_backward: bool = False,
                    stage_slowdown: Optional[Sequence[float]] = None,
                    t_bwd_of=None, t_bwd_input_of=None,
                    t_bwd_weight_of=None) -> float:
    """Fraction of the step spent idle in fill/drain: (T - T_work) / T.

    T_work = Σ_i t_i scaled by the slowest rank — the busy time of a rank
    that touches every work item (V chunks of t_i/V each), i.e. the
    zero-bubble floor of the lockstep disciplines.  For split-backward
    disciplines the per-item bwd work is B + W, which equals the fused
    price under every default layering of :func:`_unit_prices` — the floor
    is the same whether a schedule splits its backward or not.
    """
    # flatten once and feed the discipline engine directly — t_of can be a
    # measured cost model; going through simulate() would evaluate it a
    # second time per work item
    slow = np.ones(K) if stage_slowdown is None else np.asarray(stage_slowdown)
    if _explicit_bwd(discipline):
        assert include_backward, \
            f"{discipline} is inherently fwd+bwd; pass include_backward=True"
        items = _work_items(scheme, t_of, include_backward=False)
        bwd_items = _bwd_work_items(scheme, t_bwd_of)
        b_items = _bwd_work_items(scheme, t_bwd_input_of)
        w_items = _bwd_work_items(scheme, t_bwd_weight_of)
        T = _discipline_total(items, K, discipline, virtual_stages, slow,
                              n_microbatches=_one_f_one_b_groups(scheme),
                              bwd_items=bwd_items, b_items=b_items,
                              w_items=w_items)
        f, fused, b, w = _unit_prices(items, bwd_items, b_items, w_items)
        bwd_sum = (float(np.sum(b + w))
                   if REGISTRY[discipline].splits_backward
                   else float(np.sum(fused)))
        work = (float(np.sum(f)) + bwd_sum) * float(np.max(slow))
        return (T - work) / T
    items = _work_items(scheme, t_of, include_backward)
    T = _discipline_total(items, K, discipline, virtual_stages, slow)
    work = float(np.sum(items)) * float(np.max(slow))
    return (T - work) / T


@dataclasses.dataclass(frozen=True)
class StreamReport:
    """What the ``streaming`` discipline prices for a queue snapshot.

    ``ttft``        — request id -> time-to-first-token: the wall-clock at
                      which the request's first generated token is known —
                      its FINAL prefill unit exits rank K-1 (the engine
                      reads the first token off the last chunk's logits),
                      or its first decode unit for requests whose prefill
                      lies outside the snapshot.
    ``finish``      — request id -> exit time of the request's last unit.
    ``round_times`` — exit time of every decode round, in queue order (the
                      diffs are the stream's inter-token latencies).
    ``total``       — wall-clock of the whole snapshot (last tick ends).
    ``tokens``      — total tokens processed (prefill + decode).
    """
    ttft: dict
    finish: dict
    round_times: List[float]
    total: float
    tokens: int

    @property
    def tokens_per_s(self) -> float:
        return self.tokens / self.total if self.total > 0 else 0.0


def simulate_stream(schedule: StreamingSchedule, t_unit, *,
                    stage_slowdown: Optional[Sequence[float]] = None
                    ) -> StreamReport:
    """Price a streaming queue snapshot under the lockstep engine and report
    the SERVING metrics (TTFT, inter-token latency) that ``simulate``'s
    single total hides.

    ``t_unit(u) -> seconds`` prices one :class:`StreamUnit` on one stage
    (e.g. ``lambda u: cost.t_fwd(len(u.rids), u.length, max(u.ctx))``).
    The streaming table is the contiguous V=1 flow — unit ``j`` occupies
    rank ``k`` at tick ``j + k`` — so tick ``t`` costs ``max_k
    t_unit(units[t-k])·slow[k]`` and unit ``j`` exits the pipeline at the
    end of tick ``j + K - 1``.  A request's TTFT is the exit time of its
    final prefill chunk — the engine reads the first generated token off
    that chunk's last-position logits — or of its first decode unit when
    the snapshot starts mid-stream."""
    units = schedule.units
    assert units, "simulate_stream needs a schedule built over a queue " \
        "snapshot (units=...); the anonymous registry factory has none"
    K = schedule.n_ranks
    slow = (np.ones(K) if stage_slowdown is None
            else np.asarray(stage_slowdown, np.float64))
    assert len(slow) == K
    costs = np.asarray([float(t_unit(u)) for u in units], np.float64)
    M = costs.size
    # tick t's active units are t-k for k in [0, K): one vectorized gather
    ticks = np.arange(M + K - 1)[:, None] - np.arange(K)[None, :]
    live = (ticks >= 0) & (ticks < M)
    dur = np.where(live, costs[np.clip(ticks, 0, M - 1)] * slow[None, :], 0.0)
    end = np.cumsum(dur.max(axis=1))          # wall-clock at end of tick t
    exit_t = end[np.arange(M) + K - 1]        # unit j exits at tick j+K-1
    ttft, finish, round_times = {}, {}, []
    for j, u in enumerate(units):
        t = float(exit_t[j])
        if u.kind == "decode":
            round_times.append(t)
        for rid in u.rids:
            if (u.kind == "prefill" and u.final) or u.kind == "decode":
                ttft.setdefault(rid, t)
            finish[rid] = t
    tokens = sum(u.tokens for u in units)
    return StreamReport(ttft=ttft, finish=finish, round_times=round_times,
                        total=float(end[-1]), tokens=tokens)


def eq5_latency(slices: List[int], K: int, t_fwd) -> float:
    """Closed form T = Σ t_i + (K-1)·max t_i (paper Eq. 5), single split."""
    ctx, ts = 0, []
    for l in slices:
        ts.append(t_fwd(l, ctx))
        ctx += l
    return sum(ts) + (K - 1) * max(ts)
