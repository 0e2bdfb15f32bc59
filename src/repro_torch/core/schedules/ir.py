"""Schedule IR: stage/chunk placement, tick geometry, the comm plan and
its audit (reference: ``repro/core/schedules/ir.py:53-458``, copied: the
port imports nothing of the JAX package).

Unit kinds (``KIND_FWD``, fused ``KIND_BWD``, the zero-bubble split pair
``KIND_BWD_INPUT``/``KIND_BWD_WEIGHT``, ``KIND_IDLE``), :class:`CommPlan`
and the base :class:`StageAssignment` with its ``validate()`` audit — what
the serving engine's ``streaming`` schedule needs.  ``OneFOneB``, its
subclasses and the schedule registry arrive with the planning slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

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
