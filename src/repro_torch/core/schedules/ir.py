"""Schedule IR: stage/chunk placement, tick geometry, the comm plan and
its audit (reference: ``repro/core/schedules/ir.py``, copied: the port
imports nothing of the JAX package).

Unit kinds (``KIND_FWD``, fused ``KIND_BWD``, the zero-bubble split pair
``KIND_BWD_INPUT``/``KIND_BWD_WEIGHT``, ``KIND_IDLE``), :class:`CommPlan`,
the base :class:`StageAssignment` with its ``validate()`` audit, and the
explicit-backward tables :class:`OneFOneB`, :class:`InterleavedOneFOneB`
and :class:`ZeroBubbleH1` with their factories.  Every table is the
reference's; only ``contiguous`` runs in the port's executor so far.
:func:`interleave_stacked` / :func:`uninterleave_stacked` act on torch
tensors (reshape + transpose).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# ---- unit kinds (the tick table's third column) --------------------------
KIND_IDLE = -1        # fill/drain cell; work_item is -1 too
KIND_FWD = 0          # forward unit
KIND_BWD = 1          # fused input+weight backward (1F1B family)
KIND_BWD_INPUT = 2    # B: input cotangent only, feeds the reverse ring
KIND_BWD_WEIGHT = 3   # W: parameter grads from the saved residual; no comm

#: Kinds that retire (read for the last time + release) a saved residual.
RETIRING_KINDS = (KIND_BWD, KIND_BWD_WEIGHT)
#: Kinds audited against the reverse cotangent ring.
BWD_RING_KINDS = (KIND_BWD, KIND_BWD_INPUT)

_KIND_NAMES = {KIND_IDLE: "idle", KIND_FWD: "fwd", KIND_BWD: "bwd",
               KIND_BWD_INPUT: "bwd-input", KIND_BWD_WEIGHT: "bwd-weight"}


def kind_name(kind) -> str:
    """Human name of a unit kind (for ScheduleValidationError messages)."""
    return _KIND_NAMES.get(int(kind), f"kind-{int(kind)}")


class ScheduleValidationError(AssertionError):
    """A tick-table audit failure, pinpointing the first offending unit
    (in tick order, named by its kind) and the source rank/tick the comm
    plan expected."""


@dataclasses.dataclass(frozen=True)
class CommPlan:
    """What the executor's per-tick communication must look like.

    ``fwd_hold`` / ``rev_hold``: extra ticks a wrap-around chunk handoff
    (the ``K-1 -> 0`` forward edge / the ``0 -> K-1`` reverse edge) is held
    in a skew ring buffer at the destination before its consumer tick.  A
    value produced at tick ``t`` is consumed at ``t + 1 + hold``; hold 0 is
    the plain one-hop delivery.  The executor sizes its skew buffers
    ``hold + 1`` deep and pushes every received ring value, so slot
    ``t mod (hold+1)`` is overwritten exactly when it can no longer be read.

    ``rev_lag``: extra delivery delay on EVERY reverse edge (not just the
    wrap edges): a cotangent produced at tick ``t`` is consumed at
    ``t + 1 + rev_lag`` by its B unit.  Unlike ``rev_hold`` (which only the
    wrap-edge rank reads late), the lag buffer is read ``rev_lag`` ticks
    late by ALL ranks.  ZB-H1 uses ``rev_lag = 1``: its dilation-3 tick
    numbering puts adjacent ranks' B units 2 ticks apart.  ``rev_lag`` and
    ``rev_hold`` are mutually exclusive (no schedule needs both yet; the
    executor asserts this).
    """
    fwd_ring: bool = True       # activation ring (k -> k+1) fires every tick
    rev_ring: bool = False      # cotangent ring (k -> k-1); explicit-bwd only
    fwd_hold: int = 0
    rev_hold: int = 0
    rev_lag: int = 0


@dataclasses.dataclass(frozen=True)
class StageAssignment:
    """K ranks × V layer chunks: placement + tick table for one schedule.

    ``n_layers`` is the UNPADDED main-stack block count; the assignment pads
    it to ``K·V·blocks_per_chunk`` rows (zero blocks are exact identities in
    a residual stack, so padding is placement-free).
    """
    n_ranks: int          # K
    virtual_stages: int   # V (1 = contiguous TeraPipe schedule)
    n_layers: int

    #: True when the tick table contains explicit bwd units (the executor
    #: must run per-unit vjp instead of whole-program autodiff).
    has_backward = False
    #: True when the backward is split into B (KIND_BWD_INPUT) and W
    #: (KIND_BWD_WEIGHT) units instead of fused KIND_BWD units.
    splits_backward = False

    def __post_init__(self):
        assert self.n_ranks >= 1 and self.virtual_stages >= 1, self
        assert self.n_layers >= 1, self

    # ---- layer-chunk geometry -------------------------------------------
    @property
    def n_stages(self) -> int:
        """Global pipeline depth K·V."""
        return self.n_ranks * self.virtual_stages

    @property
    def blocks_per_chunk(self) -> int:
        return -(-self.n_layers // self.n_stages)

    @property
    def n_padded(self) -> int:
        return self.n_stages * self.blocks_per_chunk

    @property
    def n_pad(self) -> int:
        return self.n_padded - self.n_layers

    def rank_of_stage(self, s: int) -> int:
        return s % self.n_ranks

    def chunk_of_stage(self, s: int) -> int:
        return s // self.n_ranks

    def stage_of(self, rank: int, chunk: int) -> int:
        return chunk * self.n_ranks + rank

    def layer_rows(self, s: int):
        """[lo, hi) rows of the padded stage-major stack owned by stage s."""
        b = self.blocks_per_chunk
        return s * b, (s + 1) * b

    def param_permutation(self) -> np.ndarray:
        """Padded-stack row order making each rank's V chunks contiguous
        (rank-major): row ``k·V·bpc + v·bpc + b`` holds global stage
        ``v·K + k``'s b-th layer.  A plain pipe-sharding of the permuted
        leading axis then gives rank k exactly its chunks."""
        K, V, b = self.n_ranks, self.virtual_stages, self.blocks_per_chunk
        return np.arange(self.n_padded).reshape(V, K, b).swapaxes(0, 1).reshape(-1)

    # ---- tick geometry ---------------------------------------------------
    def n_units(self, n_items: int) -> int:
        """Work units per rank: every rank touches every work item V times."""
        if self.virtual_stages > 1:
            assert n_items % self.n_ranks == 0, (
                f"interleaved schedule (V={self.virtual_stages}) needs the "
                f"work-item count {n_items} divisible by K={self.n_ranks} "
                f"(items advance in ring groups of K)")
        return n_items * self.virtual_stages

    def n_ticks(self, n_items: int) -> int:
        return self.n_units(n_items) + self.n_ranks - 1

    def unit_index(self, u):
        """(work_item, chunk, kind) of a rank's u-th unit.  Pure arithmetic
        in u — evaluates on python ints, numpy arrays, and traced jax scalars
        alike.  Fwd-only schedules always return ``kind == KIND_FWD``."""
        K, V = self.n_ranks, self.virtual_stages
        if V == 1:
            return u, u * 0, u * 0 + KIND_FWD
        KV = K * V
        g, r = u // KV, u % KV
        return g * K + r % K, r // K, u * 0 + KIND_FWD

    def tick_table(self, n_items: int) -> np.ndarray:
        """(n_ticks, K, 3) array; entry (t, k) = (work_item, chunk, kind),
        or (-1, -1, KIND_IDLE) when rank k idles (fill/drain) at tick t.
        THE interface the unified executor interprets: every schedule —
        fwd-only, fused-bwd, or split-bwd — is completely described by this
        table plus :meth:`comm_plan`."""
        T, K = self.n_ticks(n_items), self.n_ranks
        n_units = self.n_units(n_items)
        tab = np.full((T, K, 3), -1, np.int64)
        for k in range(K):
            u = np.arange(T) - k
            ok = (u >= 0) & (u < n_units)
            i, v, _ = self.unit_index(np.clip(u, 0, n_units - 1))
            tab[ok, k, 0] = np.broadcast_to(i, (T,))[ok]
            tab[ok, k, 1] = np.broadcast_to(v, (T,))[ok]
            tab[ok, k, 2] = KIND_FWD
        return tab

    def comm_plan(self) -> CommPlan:
        """Ring/skew description for the executor (see :class:`CommPlan`).
        Fwd-only schedules deliver every dependency — including the
        interleaved wrap-around handoff — exactly one tick after production
        (the group-of-K unit ordering makes the wrap edge line up), so no
        skew buffers and no reverse ring."""
        return CommPlan(fwd_ring=True, rev_ring=self.has_backward,
                        fwd_hold=0, rev_hold=0)

    # ---- audits ----------------------------------------------------------
    def _collect(self, n_items: int):
        """{(item, stage): (tick, rank)} per kind class: fwd units, bwd-ring
        units (fused BWD or split B), and W units — plus the set of kinds
        the table actually uses (to reject fused/split mixing)."""
        tab = self.tick_table(n_items)
        when_f, when_b, when_w = {}, {}, {}
        kinds = set()
        for t in range(tab.shape[0]):
            for k in range(self.n_ranks):
                i, v, kind = (int(x) for x in tab[t, k])
                if i < 0:
                    continue
                kinds.add(kind)
                s = self.stage_of(k, v)
                if kind == KIND_FWD:
                    d = when_f
                elif kind in BWD_RING_KINDS:
                    d = when_b
                elif kind == KIND_BWD_WEIGHT:
                    d = when_w
                else:
                    raise ScheduleValidationError(
                        f"unknown unit kind {kind} (item={i}, stage={s}) at "
                        f"(tick={t}, rank={k})")
                if (i, s) in d:
                    raise ScheduleValidationError(
                        f"{kind_name(kind)} unit (item={i}, "
                        f"stage={s}) scheduled twice: at (tick={d[(i, s)][0]},"
                        f" rank={d[(i, s)][1]}) and (tick={t}, rank={k})")
                d[(i, s)] = (t, k)
        return when_f, when_b, when_w, kinds

    def validate(self, n_items: int) -> bool:
        """Audit the tick table against the comm plan: every
        (work_item, stage) fwd unit runs exactly once, one unit per
        (tick, rank), and each fwd unit's producer (previous global stage of
        the same item) ran on the ring predecessor exactly
        ``1 + fwd_hold``-ticks-for-wrap-edges / 1-tick-otherwise earlier —
        i.e. the per-tick ppermute ring plus the declared skew buffers
        deliver every dependency just in time.  Schedules with bwd units
        additionally audit: item i's bwd at stage s runs exactly once,
        ``1 + rev_lag (+ rev_hold on the reverse wrap edge)`` ticks after
        stage s+1's bwd on the ring *successor* (the reverse ppermute ring),
        strictly after its own fwd at stage s (the saved residuals exist),
        and in an order consistent with any schedule-specific constraint
        (:meth:`_audit_backward_order`).  Split-backward schedules
        (``splits_backward``) further audit the typed-kind invariants:
        every FWD has exactly one matching B and exactly one matching W, W
        runs on the same rank as — and strictly after — its B (W replays
        rank-local saved state), cotangent-ring dependencies attach to B
        units only (W units receive nothing), and fused BWD units never
        appear in a split table (nor split units in a fused one).  Failures
        raise :class:`ScheduleValidationError` naming the first offending
        (tick, rank, unit) by kind and the expected source rank/tick."""
        plan = self.comm_plan()
        K = self.n_ranks
        when_f, when_b, when_w, kinds = self._collect(n_items)
        if len(when_f) != n_items * self.n_stages:
            raise ScheduleValidationError(
                f"expected {n_items}·{self.n_stages} = "
                f"{n_items * self.n_stages} fwd units, table schedules "
                f"{len(when_f)}")
        for (i, s), (t, k) in sorted(when_f.items(), key=lambda kv: kv[1]):
            if s == 0:
                continue
            tp, kp = when_f[(i, s - 1)]
            delay = 1 + (plan.fwd_hold if s % K == 0 else 0)
            want_k = (k - 1) % K
            if tp != t - delay or kp != want_k:
                raise ScheduleValidationError(
                    f"fwd unit (item={i}, stage={s}) at (tick={t}, rank={k})"
                    f": expected its producer (item={i}, stage={s - 1}) on "
                    f"ring predecessor rank {want_k} at tick {t - delay} "
                    f"(delay {delay}"
                    + (f" = 1 hop + {delay - 1}-tick skew hold"
                       if delay > 1 else "")
                    + f"), but it ran at (tick={tp}, rank={kp}); the forward "
                    f"ring cannot deliver it")
        if not self.has_backward:
            if when_b or when_w:
                (i, s), (t, k) = sorted((when_b or when_w).items(),
                                        key=lambda kv: kv[1])[0]
                raise ScheduleValidationError(
                    f"fwd-only schedule emits a backward unit (item={i}, "
                    f"stage={s}) at (tick={t}, rank={k})")
            return True
        b_name = "bwd-input" if self.splits_backward else "bwd"
        if self.splits_backward and KIND_BWD in kinds:
            raise ScheduleValidationError(
                "split-backward schedule emits a fused bwd unit; use "
                "bwd-input/bwd-weight kinds")
        if not self.splits_backward and (KIND_BWD_INPUT in kinds
                                         or KIND_BWD_WEIGHT in kinds):
            raise ScheduleValidationError(
                "fused-backward schedule emits split bwd-input/bwd-weight "
                "units; set splits_backward")
        if len(when_b) != n_items * self.n_stages:
            raise ScheduleValidationError(
                f"expected {n_items}·{self.n_stages} = "
                f"{n_items * self.n_stages} {b_name} units, table schedules "
                f"{len(when_b)}")
        for (i, s), (t, k) in sorted(when_b.items(), key=lambda kv: kv[1]):
            if (i, s) not in when_f:
                raise ScheduleValidationError(
                    f"{b_name} unit (item={i}, stage={s}) at (tick={t}, "
                    f"rank={k}) has no matching fwd unit")
            tf, _ = when_f[(i, s)]
            if tf >= t:
                raise ScheduleValidationError(
                    f"{b_name} unit (item={i}, stage={s}) at (tick={t}, "
                    f"rank={k}) runs before its own fwd at tick {tf}: no "
                    f"residuals to transpose")
            if s == self.n_stages - 1:
                continue           # seeds from the loss, not the ring
            tp, kp = when_b[(i, s + 1)]
            delay = (1 + plan.rev_lag
                     + (plan.rev_hold if (s + 1) % K == 0 else 0))
            want_k = (k + 1) % K
            if tp != t - delay or kp != want_k:
                raise ScheduleValidationError(
                    f"{b_name} unit (item={i}, stage={s}) at (tick={t}, "
                    f"rank={k}): expected its cotangent producer (item={i}, "
                    f"stage={s + 1}) on reverse-ring predecessor rank "
                    f"{want_k} at tick {t - delay} (delay {delay}"
                    + (f" = 1 hop + {delay - 1} extra tick(s) of lag/hold"
                       if delay > 1 else "")
                    + f"), but it ran at (tick={tp}, rank={kp}); the reverse "
                    f"ring cannot deliver it")
        if self.splits_backward:
            if len(when_w) != n_items * self.n_stages:
                raise ScheduleValidationError(
                    f"expected {n_items}·{self.n_stages} = "
                    f"{n_items * self.n_stages} bwd-weight units, table "
                    f"schedules {len(when_w)}: fwd↔B↔W must be a bijection")
            for (i, s), (t, k) in sorted(when_w.items(),
                                         key=lambda kv: kv[1]):
                if (i, s) not in when_b:
                    raise ScheduleValidationError(
                        f"bwd-weight unit (item={i}, stage={s}) at "
                        f"(tick={t}, rank={k}) has no matching bwd-input "
                        f"unit")
                tb, kb = when_b[(i, s)]
                if kb != k:
                    raise ScheduleValidationError(
                        f"bwd-weight unit (item={i}, stage={s}) at "
                        f"(tick={t}, rank={k}) not on its bwd-input unit's "
                        f"rank {kb}: W replays rank-local saved state")
                if t <= tb:
                    raise ScheduleValidationError(
                        f"bwd-weight unit (item={i}, stage={s}) at "
                        f"(tick={t}, rank={k}) does not run strictly after "
                        f"its bwd-input unit at tick {tb}")
        elif when_w:
            (i, s), (t, k) = sorted(when_w.items(), key=lambda kv: kv[1])[0]
            raise ScheduleValidationError(
                f"fused-backward schedule emits a bwd-weight unit (item={i},"
                f" stage={s}) at (tick={t}, rank={k})")
        self._audit_backward_order(when_b)
        return True

    def _audit_backward_order(self, when_b):
        """Hook: schedule-specific bwd ordering constraints (see OneFOneB)."""

    def peak_live_items(self, n_items: int) -> int:
        """Max, over ranks, of simultaneously-live saved residuals (units
        whose fwd has run but whose retiring backward has not yet run),
        summed over the rank's V chunks.

        Fwd-only schedules transpose the whole program at the drain, so every
        unit a rank ran is still live there: peak = ``n_items·V`` (= D·M·V).
        1F1B retires unit residuals at the unit's own bwd tick, bounding the
        peak by the pipeline depth plus the per-microbatch bwd turnaround
        (``min(n_items, K + M - 1)`` at V=1; ~``(V-1)·K`` more per extra
        chunk under interleaved 1F1B) — independent of the microbatch count
        D that the DP planner scales.  Split-backward schedules retire at
        the W tick (B reads the slot but does not release it), adding one
        tick of lifetime per unit — still flat in D."""
        tab = self.tick_table(n_items)
        T = tab.shape[0]
        peak = 0
        for k in range(self.n_ranks):
            delta = np.zeros(T + 1, np.int64)
            birth = {}
            for t in range(T):
                i, v, kind = (int(x) for x in tab[t, k])
                if i < 0:
                    continue
                if kind in RETIRING_KINDS:
                    delta[t + 1] -= 1      # live through its retiring tick
                    assert (i, v) in birth, (i, v, k, kind)
                elif kind == KIND_BWD_INPUT:
                    assert (i, v) in birth, (i, v, k, kind)  # B only reads
                else:
                    delta[t] += 1
                    birth[(i, v)] = t
            if not self.has_backward:
                delta[T] = 0               # live to the drain
            peak = max(peak, int(np.cumsum(delta)[:T].max(initial=0)))
        return peak

    def residual_spread(self, n_items: int) -> int:
        """Ring-buffer depth for an explicit-bwd executor: the max, over
        ranks, ticks and CHUNKS, of ``max(live item idx) - min(live item
        idx) + 1`` among items whose residuals are live at that (rank,
        chunk).  Indexing the per-chunk residual store with ``item %
        residual_spread`` is then collision-free.  Tracked per chunk because
        the executor keys its store ``(chunk, item % spread)`` — items live
        at *different* chunks never collide.  A slot is released by the
        unit's retiring backward: the fused BWD, or — in split-backward
        tables — the W unit (B reads the slot but keeps it live)."""
        tab = self.tick_table(n_items)
        spread = 1
        for k in range(self.n_ranks):
            live = {}
            for t in range(tab.shape[0]):
                i, v, kind = (int(x) for x in tab[t, k])
                if i < 0:
                    continue
                lv = live.setdefault(v, set())
                if kind in RETIRING_KINDS:
                    if lv:
                        spread = max(spread, max(lv) - min(lv) + 1)
                    lv.discard(i)
                elif kind == KIND_BWD_INPUT:
                    pass                   # reads the slot; stays live
                else:
                    lv.add(i)
                    spread = max(spread, max(lv) - min(lv) + 1)
        return spread


@dataclasses.dataclass(frozen=True)
class OneFOneB(StageAssignment):
    """Memory-bounded 1F1B schedule (Narayanan et al. 2021), token-level,
    generalized to V ≥ 1 virtual stages (V ≥ 2 is the *interleaved* 1F1B of
    Megatron-LM; construct it via :class:`InterleavedOneFOneB` / the
    ``interleaved-1f1b`` registry entry).

    Explicit fwd AND bwd units in one lockstep tick table.  Work item
    ``i = d·M + m`` (microbatch d, token slice m).  Fwd units follow the
    interleaved unit ordering (groups of K items, chunk-ascending within a
    group — the fwd-only ``interleaved`` order, 2×-dilated to make room for
    bwd ticks); bwd units mirror it with chunks DESCENDING within a group
    and slices DESCENDING within a microbatch — TeraPipe's attention cache
    makes slice m's kv entries inputs of every later slice m' > m, so their
    cotangents only finish accumulating once all later slices' bwds have run.

    Timing (K ranks, N items, M slices per microbatch, V chunks):

    * fwd unit u on rank k at tick ``2u + k``;
    * bwd unit j on rank k at tick ``2j + C - k``, with the phase
      ``C = 2·max_j(u_f(j) - j) + 2K - 1`` the smallest odd offset putting
      every bwd strictly after its own fwd on every rank (``u_f(j)`` is the
      fwd unit computing what bwd unit j transposes).  V=1 reduces to the
      classic ``C = 2M + 2K - 3``.

    Activations flow down the ``(k -> k+1)`` ring, cotangents down the
    reverse ``(k -> k-1)`` ring; fwd and bwd ticks interleave collision-free
    because their per-rank parities differ (C is odd).  For V ≥ 2 the
    wrap-around chunk handoffs (fwd ``K-1 -> 0``, bwd ``0 -> K-1``) are
    produced 2K units before their consumers in the dilated numbering, so
    they ride their ring one hop and then sit K ticks in a skew buffer
    (``comm_plan().fwd_hold == rev_hold == K``).  Peak live residuals stay
    flat in the microbatch count D (saturating near ``C/2 ≈ (V-1)·K+M+K``),
    where the fwd-only schedules hold all D·M·V.
    """
    n_microbatches: int = 1

    has_backward = True

    def __post_init__(self):
        super().__post_init__()
        assert self.n_microbatches >= 1, self

    def _slices_per_microbatch(self, n_items: int) -> int:
        D = self.n_microbatches
        assert n_items % D == 0, (
            f"1F1B schedule: work-item count {n_items} not divisible by "
            f"n_microbatches={D}")
        return n_items // D

    def n_units(self, n_items: int) -> int:
        """Per-rank units: one fwd AND one bwd per (work item, chunk)."""
        self._slices_per_microbatch(n_items)
        return 2 * super().n_units(n_items)

    def _bwd_unit(self, u, M: int):
        """(work_item, chunk) of a rank's u-th BACKWARD unit: the
        interleaved group order with chunks descending within a group and
        slices descending within a microbatch."""
        K, V = self.n_ranks, self.virtual_stages
        KV = K * V
        g, r = u // KV, u % KV
        i_seq = g * K + r % K
        item = (i_seq // M) * M + (M - 1 - i_seq % M)
        return item, (V - 1) - r // K

    def _bwd_phase(self, n_items: int) -> int:
        """C in ``bwd tick = 2j + C - k`` (see class doc)."""
        K, V = self.n_ranks, self.virtual_stages
        M = self._slices_per_microbatch(n_items)
        u = np.arange(StageAssignment.n_units(self, n_items))
        bi, bv = self._bwd_unit(u, M)
        u_f = (bi // K) * K * V + bv * K + bi % K   # fwd unit of (item, chunk)
        return 2 * int(np.max(u_f - u)) + 2 * K - 1

    def n_ticks(self, n_items: int) -> int:
        return (2 * StageAssignment.n_units(self, n_items)
                + self._bwd_phase(n_items) - 1)

    def unit_index(self, u):
        raise NotImplementedError(
            "1F1B unit timing is rank-dependent (fwd/bwd interleave by rank "
            "parity); the executor consumes tick_table() as a gather table "
            "instead of closed-form unit arithmetic")

    def tick_table(self, n_items: int) -> np.ndarray:
        K = self.n_ranks
        M = self._slices_per_microbatch(n_items)
        NV = StageAssignment.n_units(self, n_items)
        C = self._bwd_phase(n_items)
        tab = np.full((2 * NV + C - 1, K, 3), -1, np.int64)  # = n_ticks(N)
        u = np.arange(NV)
        fi, fv, _ = StageAssignment.unit_index(self, u)
        bi, bv = self._bwd_unit(u, M)
        for k in range(K):
            t_f = 2 * u + k
            tab[t_f, k, 0], tab[t_f, k, 1] = fi, fv
            tab[t_f, k, 2] = KIND_FWD
            t_b = 2 * u + C - k
            assert not np.intersect1d(t_f, t_b).size      # parity-disjoint
            tab[t_b, k, 0], tab[t_b, k, 1] = bi, bv
            tab[t_b, k, 2] = KIND_BWD
        return tab

    def comm_plan(self) -> CommPlan:
        hold = self.n_ranks if self.virtual_stages > 1 else 0
        return CommPlan(fwd_ring=True, rev_ring=True,
                        fwd_hold=hold, rev_hold=hold)

    def _audit_backward_order(self, when_b):
        """Within each microbatch, at every stage, bwd(-input) ticks must
        DESCEND in slice index (the cache-cotangent accumulation order)."""
        items = sorted({i for i, _ in when_b})
        M = self._slices_per_microbatch(len(items))
        for s in {s for _, s in when_b}:
            for d in range(len(items) // M):
                ticks = [when_b[(d * M + m, s)][0] for m in range(M)]
                if ticks != sorted(ticks, reverse=True):
                    raise ScheduleValidationError(
                        f"stage {s} microbatch {d}: bwd ticks {ticks} not "
                        f"slice-descending; cache cotangents incomplete")


@dataclasses.dataclass(frozen=True)
class InterleavedOneFOneB(OneFOneB):
    """Skew-buffered interleaved 1F1B (V ≥ 2): the 1F1B unit ordering over V
    round-robin layer chunks per rank.  Pure IR — the unified executor runs
    it with no schedule-specific code, holding the wrap-around chunk
    handoffs K ticks in the skew buffers its :meth:`comm_plan` declares.
    Combines interleaving's ~V× smaller fill/drain bubble with 1F1B's
    flat-in-D live-activation bound."""

    def __post_init__(self):
        super().__post_init__()
        assert self.virtual_stages >= 2, (
            "interleaved 1F1B needs V >= 2 virtual stages; use OneFOneB "
            "(schedule='1f1b') for the V=1 table")


@dataclasses.dataclass(frozen=True)
class ZeroBubbleH1(OneFOneB):
    """ZB-H1 zero-bubble schedule (Qi et al. 2023), token-level, V=1: the
    1F1B fwd/bwd orderings with each fused bwd split into a B
    (``KIND_BWD_INPUT``) unit and a W (``KIND_BWD_WEIGHT``) unit, so the
    cotangent ring advances at B-cost (≈ fwd-cost) and the deferred W units
    fill what 1F1B spends as drain bubble.

    Timing (K ranks, N items, M slices per microbatch).  Two rigid combs —
    fwd unit u runs on rank k at ``t_f[u] + k`` (fwd-ring delay exactly 1)
    and B unit m (bwd order) at ``t_b[m] + 2(K-1-k)`` (reverse-ring delay
    exactly 2 on every edge), with W one tick after its B on the same rank
    — in three phases:

    * **warmup** — the first ``w = M-1`` fwds run back-to-back
      (``t_f[u] = u``), filling the pipe at 1F1B density;
    * **steady** — fwds stretch to a 3-tick cadence (``t_f[u] = 3u - 2w``)
      and B units march at ``t_b[m] = tS + 3m``, so every rank cycles
      F, B, W with one unit per tick and zero idle on the critical rank.
      Per-rank residues mod 3 are ``w+k`` (fwd), ``w+k+1`` (B), ``w+k+2``
      (W) — pairwise disjoint for EVERY rank simultaneously, which forces
      the B slope to ``-2k``: a 1F1B-style ``-k`` slope shifts fwd and B
      residues in opposite directions and provably collides for K ≥ 3.
      ``tS = max(w+K-1, K+3M-3-2w)`` (warmup clearance / per-microbatch
      causality), rounded up to the collision-free residue class;
    * **drain** — from the first bwd position ``mD`` whose B clears the
      last fwd on rank K-1, B/W tighten to a dense 2-tick cadence
      (``t_b[m] = t_b[mD] + 2(m-mD)``): the W units fill what 1F1B spends
      as drain bubble, and because the ``2(K-1-k)`` comb shift is even,
      every drain tick is all-B or all-W across ranks.

    The ``-2k`` slope means every cotangent rides the reverse ring one hop
    and waits one tick: ``comm_plan().rev_lag == 1`` (W sends nothing —
    cotangent-ring deps attach to B units only).  Residual slots are
    released by W (B still reads them) one tick after B; B→W lifetime is
    O(K + M), so peak live residuals stay flat in the microbatch count D.

    Why it beats 1F1B: with the fused-kernel cost structure (fwd = P + A
    param-matmul + attention work, B = P + 1.5A, W = P + 2A, fused
    bwd = 2P + 3.5A), 1F1B's steady-state tick costs max(fwd, bwd) =
    2P + 3.5A, while ZB-H1's costs max(fwd, B, W) = P + 2A — and the
    critical rank runs gapless from its first fwd to its last W
    (span = K-1 + 3N ticks, the V=1 split-schedule optimum up to the
    reverse-comb tail).
    """
    splits_backward = True

    def __post_init__(self):
        super().__post_init__()
        assert self.virtual_stages == 1, (
            "zb-h1 is defined at V=1 (its 3-cadence tick numbering has no "
            "spare residue for wrap-around skew holds)")

    def n_units(self, n_items: int) -> int:
        """Per-rank units: one fwd, one B AND one W per (work item, chunk)."""
        self._slices_per_microbatch(n_items)
        return 3 * StageAssignment.n_units(self, n_items)

    def _timing(self, n_items: int):
        """Baseline tick of each fwd unit (rank 0: ``t_f[u] + k`` on rank
        k) and each B unit in bwd order (rank K-1: ``t_b[m] + 2(K-1-k)``
        on rank k); W is always ``+1`` after B on the same rank."""
        K = self.n_ranks
        M = self._slices_per_microbatch(n_items)
        N = StageAssignment.n_units(self, n_items)
        w = M - 1
        u = np.arange(N)
        t_f = np.where(u < w, u, 3 * u - 2 * w)
        # first B: past the dense warmup on every rank AND >= K ticks after
        # the last fwd of its microbatch (bwd starts at slice M-1), in the
        # residue class keeping F/B/W disjoint on every rank at once
        t_s = max(w + K - 1, K + 3 * M - 3 - 2 * w)
        while (t_s + 2 * K - 2 - (w + 1)) % 3:
            t_s += 1
        # drain switch: first bwd position whose dense 2-cadence B/W run
        # starts after the last fwd tick of rank K-1 (t_f[-1] + K - 1)
        last_f = int(t_f[-1])
        m_d = min(N, max(0, -((t_s - (last_f + K)) // 3)))
        m = np.arange(N)
        t_b = t_s + 3 * np.minimum(m, m_d) + 2 * np.maximum(m - m_d, 0)
        return t_f, t_b

    def n_ticks(self, n_items: int) -> int:
        _, t_b = self._timing(n_items)
        # rank 0's W of the last bwd unit, +1 for the tick itself
        return int(t_b[-1]) + 2 * (self.n_ranks - 1) + 2

    def tick_table(self, n_items: int) -> np.ndarray:
        K = self.n_ranks
        M = self._slices_per_microbatch(n_items)
        N = StageAssignment.n_units(self, n_items)
        t_f, t_b = self._timing(n_items)
        u = np.arange(N)
        fi, fv, _ = StageAssignment.unit_index(self, u)
        bi, bv = self._bwd_unit(u, M)
        # causality on the tightest rank (K-1): B strictly after its fwd
        assert np.all(t_b >= t_f[bi] + K), (t_f, t_b, bi)
        tab = np.full((self.n_ticks(n_items), K, 3), -1, np.int64)
        for k in range(K):
            tf = t_f + k
            tb = t_b + 2 * (K - 1 - k)
            tw = tb + 1
            # warmup clearance + steady residues + drain switch keep the
            # three streams collision-free on every rank
            assert not np.intersect1d(tf, tb).size
            assert not np.intersect1d(tf, tw).size
            tab[tf, k, 0], tab[tf, k, 1] = fi, fv
            tab[tf, k, 2] = KIND_FWD
            tab[tb, k, 0], tab[tb, k, 1] = bi, bv
            tab[tb, k, 2] = KIND_BWD_INPUT
            tab[tw, k, 0], tab[tw, k, 1] = bi, bv
            tab[tw, k, 2] = KIND_BWD_WEIGHT
        return tab

    def comm_plan(self) -> CommPlan:
        return CommPlan(fwd_ring=True, rev_ring=True,
                        fwd_hold=0, rev_hold=0, rev_lag=1)


def contiguous(n_ranks: int, n_layers: int) -> StageAssignment:
    """The paper's TeraPipe schedule: one contiguous chunk per rank."""
    return StageAssignment(n_ranks, 1, n_layers)


def interleaved(n_ranks: int, virtual_stages: int,
                n_layers: int) -> StageAssignment:
    """Megatron-style interleaved virtual pipeline: V round-robin chunks per
    rank, ring traversed V times per work item."""
    assert virtual_stages >= 2, virtual_stages
    return StageAssignment(n_ranks, virtual_stages, n_layers)


def one_f_one_b(n_ranks: int, n_layers: int,
                n_microbatches: int = 1) -> OneFOneB:
    """Memory-bounded 1F1B schedule (explicit bwd units; V=1)."""
    return OneFOneB(n_ranks, 1, n_layers, n_microbatches)


def interleaved_one_f_one_b(n_ranks: int, virtual_stages: int, n_layers: int,
                            n_microbatches: int = 1) -> InterleavedOneFOneB:
    """Skew-buffered interleaved 1F1B (explicit bwd units; V>=2)."""
    return InterleavedOneFOneB(n_ranks, virtual_stages, n_layers,
                               n_microbatches)


def zb_h1(n_ranks: int, n_layers: int,
          n_microbatches: int = 1) -> ZeroBubbleH1:
    """ZB-H1 zero-bubble schedule (split B/W backward units; V=1)."""
    return ZeroBubbleH1(n_ranks, 1, n_layers, n_microbatches)


def interleave_stacked(a: torch.Tensor, assign: StageAssignment) -> torch.Tensor:
    """Reorder a padded stage-major stacked tensor (leading axis ``n_padded``)
    into rank-major chunk order; equals ``a[assign.param_permutation()]``,
    as a reshape + transpose."""
    K, V, b = assign.n_ranks, assign.virtual_stages, assign.blocks_per_chunk
    s = tuple(a.shape)
    assert s[0] == assign.n_padded, (s, assign)
    return a.reshape((V, K, b) + s[1:]).transpose(0, 1).reshape(s)


def uninterleave_stacked(a: torch.Tensor, assign: StageAssignment) -> torch.Tensor:
    """Inverse of :func:`interleave_stacked`: rank-major chunk order back to
    the stage-major (layer-order) stack."""
    K, V, b = assign.n_ranks, assign.virtual_stages, assign.blocks_per_chunk
    s = tuple(a.shape)
    assert s[0] == assign.n_padded, (s, assign)
    return a.reshape((K, V, b) + s[1:]).transpose(0, 1).reshape(s)
