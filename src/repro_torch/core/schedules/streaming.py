"""The ``streaming`` schedule (reference: ``repro/core/schedules/streaming.py``,
copied whole): a fwd-only tick table generated from a LIVE request
queue instead of a static D·M work grid (the serving half of the schedule
IR).

Every training schedule in this package enumerates its work items up front:
D microbatches × M token slices, known before the first tick.  Serving
cannot — requests arrive, prefill in DP-planned chunks, then contribute one
1-token decode unit per round until they finish or are evicted.  The
:class:`StreamingSchedule` closes that gap while staying inside the IR
contract the unified executor interprets:

* a **work item** is one :class:`StreamUnit` from the engine's queue — a
  prefill chunk of one request (a TeraPipe token slice at that request's
  context offset, planned by ``dp.plan_prefill``) or a token-synchronous
  decode round (a batch of in-flight requests each advancing one token);
* ``tick_table(n_items)`` is the contiguous V=1 flow over those units —
  unit ``j`` runs on rank ``k`` at tick ``j + k``, so every activation
  rides the forward ring exactly one hop (hold 0) and ``validate()``'s
  ring-delivery audit applies unchanged;
* ``validate()`` ADDITIONALLY audits the queue's serving invariants
  (:meth:`StreamingSchedule._audit_stream`): per-request context offsets
  are contiguous and monotone (prefill chunks tile ``[0, prompt)`` in
  order; each decode advances exactly one token), no request appears twice
  in one unit, and no request decodes before its prefill completes —
  i.e. the dynamic queue can only emit work whose KV-cache prefix already
  exists, the serving analogue of ``_audit_backward_order``.

The schedule is fwd-only (``has_backward = False``) and V=1: decode units
are single tokens, so there is nothing for virtual stages to amortize, and
the backward pass never exists.  Built with no queue attached it
degenerates to the contiguous flow over ``n_items`` anonymous units, which
is exactly what a pure token-synchronous decode stream looks like (the
port's schedule registry arrives with the planning slice).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from .ir import ScheduleValidationError, StageAssignment


@dataclasses.dataclass(frozen=True)
class StreamUnit:
    """One work item of the serving queue.

    ``kind``   — ``"prefill"`` (one request, one DP-planned token slice) or
                 ``"decode"`` (a token-synchronous round: every listed
                 request advances one token).
    ``rids``   — request ids computed by this unit (exactly one for
                 prefill; the round's in-flight batch for decode).
    ``ctx``    — per-request context offset (tokens already processed) at
                 the moment this unit runs, aligned with ``rids``.
    ``length`` — tokens processed per request: the prefill chunk length,
                 or 1 for a decode round.
    ``final``  — for prefill chunks, whether this is the request's LAST
                 chunk (decode may begin after it); always True for decode.
    """
    kind: str
    rids: Tuple[int, ...]
    ctx: Tuple[int, ...]
    length: int
    final: bool = True

    def __post_init__(self):
        assert self.kind in ("prefill", "decode"), self.kind
        assert len(self.rids) == len(self.ctx), self
        assert self.length >= 1, self

    @property
    def tokens(self) -> int:
        """Total tokens this unit pushes through one stage."""
        return self.length * len(self.rids)


@dataclasses.dataclass(frozen=True)
class StreamingSchedule(StageAssignment):
    """Fwd-only contiguous flow over a dynamic work queue (see module doc).

    ``units`` is the queue snapshot the tick table covers: work item ``j``
    IS ``units[j]``.  An empty tuple (the registry factory's product)
    leaves the units anonymous — the table is still the contiguous flow,
    but only the ring audits apply.
    """
    units: Tuple[StreamUnit, ...] = ()

    def __post_init__(self):
        super().__post_init__()
        assert self.virtual_stages == 1, (
            "streaming is a V=1 schedule: decode units are single tokens; "
            "there is no backward and nothing for virtual stages to "
            "amortize")

    def n_units(self, n_items: int) -> int:
        if self.units:
            assert n_items == len(self.units), (
                f"streaming schedule built over {len(self.units)} queue "
                f"units; tick_table/validate called with n_items={n_items}")
        return super().n_units(n_items)

    # tick_table / comm_plan / unit_index: the base fwd-only V=1 table —
    # unit j on rank k at tick j + k, one-hop forward ring, no holds.

    def validate(self, n_items: int) -> bool:
        super().validate(n_items)
        if self.units:
            self._audit_stream()
        return True

    def _audit_stream(self) -> None:
        """Serving invariants of the queue (beyond ring delivery): per
        request, context offsets are contiguous and monotone in queue
        order — chunk j of request r starts exactly where chunk j-1 ended,
        decode rounds advance exactly one token, and no decode precedes
        the end of prefill.  Violations mean the engine scheduled work
        whose KV prefix does not exist yet."""
        seen = {}          # rid -> (tokens processed, prefill_done)
        for j, u in enumerate(self.units):
            if u.kind == "prefill" and len(u.rids) != 1:
                raise ScheduleValidationError(
                    f"stream unit {j}: prefill units carry exactly one "
                    f"request, got {u.rids}")
            if u.kind == "decode" and u.length != 1:
                raise ScheduleValidationError(
                    f"stream unit {j}: decode rounds advance one token per "
                    f"request, got length={u.length}")
            if len(set(u.rids)) != len(u.rids):
                raise ScheduleValidationError(
                    f"stream unit {j}: request listed twice in one unit: "
                    f"{u.rids}")
            for rid, ctx in zip(u.rids, u.ctx):
                done, prefilled = seen.get(rid, (0, False))
                if ctx != done:
                    raise ScheduleValidationError(
                        f"stream unit {j} ({u.kind}): request {rid} at "
                        f"context {ctx} but only {done} tokens of its "
                        f"KV prefix exist — chunks must tile contiguously")
                if u.kind == "decode" and not prefilled:
                    raise ScheduleValidationError(
                        f"stream unit {j}: request {rid} decodes before "
                        f"its prefill completed")
                if u.kind == "prefill" and prefilled:
                    raise ScheduleValidationError(
                        f"stream unit {j}: request {rid} prefills after "
                        f"its prefill already completed")
                if u.kind == "prefill":
                    seen[rid] = (done + u.length, u.final)
                else:
                    seen[rid] = (done + 1, True)


def prefill_unit(rid: int, ctx: int, length: int,
                 final: bool = True) -> StreamUnit:
    """A DP-planned prefill chunk of ``rid`` at context offset ``ctx``.
    ``final=False`` marks an intermediate chunk (more prefill follows), so
    the stream audit rejects any decode of ``rid`` before the last chunk."""
    return StreamUnit("prefill", (rid,), (ctx,), length, final)


def decode_round(rids, ctxs) -> StreamUnit:
    """A token-synchronous decode round: every request in ``rids`` (at
    per-request context ``ctxs``) advances one token."""
    return StreamUnit("decode", tuple(rids), tuple(ctxs), 1)


def streaming(n_ranks: int, n_layers: int,
              units: Tuple[StreamUnit, ...] = ()) -> StreamingSchedule:
    """Build the fwd-only streaming schedule over a queue snapshot."""
    return StreamingSchedule(n_ranks, 1, n_layers, tuple(units))
