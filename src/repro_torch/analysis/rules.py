"""The audit rules: registry id -> check over what one run recorded
(reference: ``repro/analysis/rules.py``).

The reference reads a traced jaxpr; the port runs eagerly, so each rule
reads what :mod:`.audit`'s instruments recorded over one loss-and-gradient
step: the ring shifts (``LocalRing.shift``), the tensors autograd saved for
the backward pass (``saved_tensors_hooks``), the dtype conversions
(``aten._to_copy`` under a ``TorchDispatchMode``).  Every rule returns a
list of :class:`~.findings.Finding` and never raises on a violation.

Ids kept from the reference where the guarantee carries over:
``ir.validate``, ``comm.ring-match``, ``buffer.score-matrix``,
``buffer.repeated-kv``, ``dtype.upcast``; ``scale.flat-in-d`` is the torch
form of ``scale.flat-growth`` (bytes saved, not equations traced).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.core.schedules import (KIND_BWD, KIND_BWD_INPUT, KIND_FWD,
                                        ScheduleValidationError, StageAssignment)

from .findings import SEV_ERROR, SEV_INFO, Finding

#: the most error findings of one kind a rule lists one by one
MAX_LISTED = 16


@dataclasses.dataclass(frozen=True)
class Rule:
    rule_id: str
    family: str
    doc: str
    fn: Callable[..., List[Finding]]


RULES: Dict[str, Rule] = {}


def register_rule(rule_id: str, family: str):
    """Register an audit pass under ``family.name`` (CLI listing, docs)."""
    def deco(fn):
        assert rule_id not in RULES, f"duplicate rule {rule_id!r}"
        RULES[rule_id] = Rule(rule_id, family, (fn.__doc__ or "").strip().split("\n")[0], fn)
        return fn
    return deco


def rule_ids() -> Tuple[str, ...]:
    return tuple(RULES)


@dataclasses.dataclass(frozen=True)
class SavedTensor:
    """One tensor autograd saved for the backward pass: its shape, and
    whether its head axis (dim 2 of a 4-D tensor at ``Hq`` heads) holds
    groups of identical heads, as a GQA-repeated K/V does."""
    shape: Tuple[int, ...]
    repeated_heads: bool = False


# ---------------------------------------------------------------------- ir
@register_rule("ir.validate", "ir")
def check_ir(assign: StageAssignment, n_items: int) -> List[Finding]:
    """The schedule's own tick-table audit (``assign.validate``): every unit
    once, one unit per (tick, rank), producers one ring hop (plus the
    declared holds) before their consumers."""
    try:
        assign.validate(n_items)
    except ScheduleValidationError as e:
        return [Finding("ir.validate", SEV_ERROR, str(e))]
    return [Finding("ir.validate", SEV_INFO, f"tick table validates for {n_items} items")]


# -------------------------------------------------------------------- comm
def _ring_errors(sends: List[Tuple[int, ...]], tab, kinds, k: int, t: int, src: int,
                 hold: int, want: Tuple[int, int], ring: str) -> List[str]:
    """Did rank ``src`` send on ``ring`` at tick ``t - 1 - hold`` while its
    tick-table entry there was a unit in ``kinds`` of item/chunk ``want``?"""
    ts = t - 1 - hold
    if not 0 <= ts < len(sends) or src not in sends[ts]:
        return [f"rank {k} at tick {t} reads the {ring} ring value of tick {ts} from rank "
                f"{src}, which sent none"]
    i, v, kind = (int(a) for a in tab[ts, src])
    if (i, v) != want or kind not in kinds:
        return [f"rank {k} at tick {t} reads, from rank {src} at tick {ts}, the output of "
                f"(item {i}, chunk {v}, kind {kind}), not of (item {want[0]}, chunk "
                f"{want[1]})"]
    return []


@register_rule("comm.ring-match", "comm")
def check_ring_match(sends: Sequence[Tuple[int, Tuple[int, ...]]], *,
                     assign: StageAssignment, n_items: int) -> List[Finding]:
    """The rings that fire, with their holds, are ``comm_plan()``'s: the
    forward ring shifts every tick, the reverse ring every tick exactly when
    the plan declares it (explicit-backward schedules), and every unit's
    input left its producer, on the ring predecessor (successor for a
    cotangent), ``1 + hold`` ticks before (``fwd_hold`` / ``rev_hold`` on
    the wrap edges, ``rev_lag`` on every reverse edge).  ``sends`` is
    ``[(step, ranks that sent a value)]`` per ``LocalRing.shift`` call.
    Under the forward-only schedules autograd's transpose of the forward
    ring carries the cotangents, and no reverse shift is issued."""
    K, V = assign.n_ranks, assign.virtual_stages
    plan = assign.comm_plan()
    tab = assign.tick_table(n_items)
    n_ticks = tab.shape[0]
    fwd = [set(s) for step, s in sends if step == 1]
    rev = [set(s) for step, s in sends if step == -1]
    bad: List[str] = []
    other = sorted({step for step, _ in sends if step not in (1, -1)})
    if other:
        bad.append(f"shifts by {other}: neither the forward ring (1) nor the reverse (-1)")
    if plan.fwd_ring and len(fwd) < n_ticks:
        bad.append(f"the forward ring shifted on {len(fwd)} of {n_ticks} ticks")
    if plan.rev_ring and len(rev) < n_ticks:
        bad.append(f"comm_plan() declares the reverse ring; it shifted on {len(rev)} of "
                   f"{n_ticks} ticks")
    if not plan.rev_ring and rev:
        bad.append(f"{len(rev)} reverse-ring shifts, which comm_plan() does not declare")
    for t in range(n_ticks):
        for k in range(K):
            i, v, kind = (int(a) for a in tab[t, k])
            if kind == KIND_FWD and (k, v) != (0, 0):
                hold = plan.fwd_hold if k == 0 else 0
                bad += _ring_errors(fwd, tab, (KIND_FWD,), k, t, (k - 1) % K, hold,
                                    (i, v if k > 0 else v - 1), "forward")
            elif kind in (KIND_BWD, KIND_BWD_INPUT) and (k, v) != (K - 1, V - 1):
                hold = plan.rev_lag or (plan.rev_hold if k == K - 1 else 0)
                bad += _ring_errors(rev, tab, (KIND_BWD, KIND_BWD_INPUT), k, t, (k + 1) % K,
                                    hold, (i, v if k < K - 1 else v + 1), "reverse")
    data = {"ticks": n_ticks, "fwd_shifts": len(fwd), "rev_shifts": len(rev),
            "fwd_hold": plan.fwd_hold, "rev_hold": plan.rev_hold, "rev_lag": plan.rev_lag}
    if bad:
        out = [Finding("comm.ring-match", SEV_ERROR, msg, data) for msg in bad[:MAX_LISTED]]
        if len(bad) > MAX_LISTED:
            out.append(Finding("comm.ring-match", SEV_ERROR,
                               f"... {len(bad) - MAX_LISTED} more ring mismatches", data))
        return out
    rev_msg = (f"{len(rev)} reverse" if plan.rev_ring else
               "no reverse shift (autograd's transpose of the forward ring carries the "
               "cotangents)")
    return [Finding("comm.ring-match", SEV_INFO,
                    f"rings match comm_plan() over {n_ticks} ticks: {len(fwd)} forward, "
                    f"{rev_msg}; holds fwd {plan.fwd_hold}, rev {plan.rev_hold}, lag "
                    f"{plan.rev_lag}", data)]


# ------------------------------------------------------------------ buffer
def _score_layout(shape: Tuple[int, ...], *, mb: int, hq: int, hkv: int, l: int,
                  sk: int) -> bool:
    """``shape`` is the (l, ctx+l) score matrix of ``mb`` sequences at Hq
    heads, with its head axis: ``(mb, Hq, l, sk)``, the grouped ``(mb, Hkv,
    rep, l, sk)``, or a matmul's flattening of either (``(mb·Hq, l, sk)``,
    ``(mb·Hkv, rep·l, sk)``).  The trailing pair alone is not enough: an
    activation ``(mb, l, d)`` at ``sk == d`` has it too."""
    if len(shape) < 3 or shape[-1] != sk:
        return False
    lead = 1
    for n in shape[:-2]:
        lead *= n
    rep = hq // hkv
    return ((shape[-2] == l and lead == mb * hq)
            or (shape[-2] == rep * l and lead == mb * hkv))


@register_rule("buffer.score-matrix", "buffer")
def check_score_matrix(saved: Sequence[SavedTensor], *, mb: int, hq: int, hkv: int,
                       pairs) -> List[Finding]:
    """No tensor saved for the backward pass is an (l, ctx+l) attention
    score matrix at its heads, ``(B, H, l, ctx+l)``: the quadratic buffer
    the flash kernels exist to avoid.  ``pairs`` are the step's (l, ctx+l)."""
    hits = sorted({s.shape for s in saved for l, sk in pairs
                   if _score_layout(s.shape, mb=mb, hq=hq, hkv=hkv, l=l, sk=sk)})
    return [Finding("buffer.score-matrix", SEV_ERROR,
                    f"score-matrix tensor {list(shape)} saved for the backward pass",
                    {"shape": list(shape)}) for shape in hits[:MAX_LISTED]]


@register_rule("buffer.repeated-kv", "buffer")
def check_repeated_kv(saved: Sequence[SavedTensor], *, hq: int, hkv: int,
                      sks) -> List[Finding]:
    """No K/V repeated to the query heads is saved: with Hkv < Hq, no saved
    ``(B, Sk, Hq, hd)`` tensor holds groups of identical heads.  Vacuous
    when Hkv == Hq."""
    if hkv == hq:
        return []
    hits = sorted({s.shape for s in saved
                   if s.repeated_heads and len(s.shape) == 4 and s.shape[1] in sks})
    return [Finding("buffer.repeated-kv", SEV_ERROR,
                    f"GQA-repeated K/V {list(shape)} (Hq {hq}, Hkv {hkv}) saved for the "
                    f"backward pass", {"shape": list(shape)}) for shape in hits[:MAX_LISTED]]


# ------------------------------------------------------------------- scale
@register_rule("scale.flat-in-d", "scale")
def check_flat_in_d(peak_small: int, peak_big: int, *, required: bool,
                    slack: float = 0.10, label: str = "") -> List[Finding]:
    """The peak bytes of live saved tensors at 2D microbatches stay within
    ``slack`` of those at D (the 1F1B family's memory claim).  With
    ``required`` False (the forward-only schedules, whose autograd keeps
    every unit to the drain) the growth is reported as info."""
    grow = peak_big / peak_small - 1 if peak_small else float("inf")
    data = {"small": peak_small, "big": peak_big, "growth": grow, "slack": slack}
    msg = (f"{label}peak saved bytes {peak_small:,} -> {peak_big:,} "
           f"({grow:+.1%}, slack {slack:.0%})")
    if required and grow > slack:
        return [Finding("scale.flat-in-d", SEV_ERROR, msg + ": not flat in D", data)]
    return [Finding("scale.flat-in-d", SEV_INFO, msg, data)]


# ------------------------------------------------------------------- dtype
@register_rule("dtype.upcast", "dtype")
def check_dtype_casts(counts: Dict[str, int]) -> List[Finding]:
    """Census of the dtype conversions of one step (``aten._to_copy`` by
    ``src->dst``), bf16 <-> f32 first: info, the baseline of the cast
    work that a later change may remove."""
    order = ("bfloat16->float32", "float32->bfloat16")
    keys = [k for k in order if k in counts] + sorted(k for k in counts if k not in order)
    text = ", ".join(f"{k} {counts[k]}" for k in keys) or "none"
    return [Finding("dtype.upcast", SEV_INFO, f"dtype conversions per step: {text}",
                    {"counts": {k: counts[k] for k in keys}})]
