"""Pipeline-schedule subsystem: the schedule IR and its registry
(reference: ``repro/core/schedules/__init__.py``, copied: the port imports
nothing of the JAX package).

A schedule is a :class:`StageAssignment`: ``K`` pipeline ranks each holding
``V`` virtual stages (layer chunks).  Its tick table maps ``(tick, rank)``
to ``(work_item, chunk, kind)``, its comm plan says which rings fire and
how long a wrap-around handoff is held, and ``validate()`` audits the two
against each other (see :mod:`.ir`).  :data:`REGISTRY` maps schedule names
to factories and CLI metadata: the train ``--schedule`` choices, the
simulator's lockstep disciplines and the executor's schedule resolution
are all read from it.  The port's executor runs ``contiguous`` so far; the
other training schedules are planned and simulated, and the executor
refuses them (ROADMAP Queue 1 item 6).
"""
import dataclasses
from typing import Callable, Dict, Optional, Tuple

from .ir import (BWD_RING_KINDS, KIND_BWD, KIND_BWD_INPUT,  # noqa: F401
                 KIND_BWD_WEIGHT, KIND_FWD, KIND_IDLE, RETIRING_KINDS,
                 CommPlan, InterleavedOneFOneB, OneFOneB,
                 ScheduleValidationError, StageAssignment, ZeroBubbleH1,
                 contiguous, interleave_stacked, interleaved,
                 interleaved_one_f_one_b, kind_name, one_f_one_b,
                 uninterleave_stacked, zb_h1)
from .streaming import (StreamingSchedule, StreamUnit,  # noqa: F401
                        decode_round, prefill_unit, streaming)


@dataclasses.dataclass(frozen=True)
class ScheduleSpec:
    """Registry entry: how to build a schedule and how the CLIs present it.

    ``factory(n_ranks, virtual_stages, n_layers, n_microbatches)`` must
    return a :class:`StageAssignment`.  ``min_virtual``/``max_virtual``
    bound the legal ``--virtual-stages`` range (None = unbounded)."""
    name: str
    factory: Callable[[int, int, int, int], StageAssignment]
    help: str
    min_virtual: int = 1
    max_virtual: Optional[int] = 1
    has_backward: bool = False
    #: backward split into B/W unit kinds (see ir.ZeroBubbleH1)
    splits_backward: bool = False


REGISTRY: Dict[str, ScheduleSpec] = {}


def register_schedule(spec: ScheduleSpec) -> ScheduleSpec:
    """Add a schedule to the registry (train/dryrun CLI choices, simulator
    discipline dispatch, and executor resolution all read it)."""
    assert spec.name not in REGISTRY, f"duplicate schedule {spec.name!r}"
    REGISTRY[spec.name] = spec
    return spec


def schedule_names() -> Tuple[str, ...]:
    return tuple(REGISTRY)


def schedule_help() -> str:
    """One line per registered schedule, for CLI help text."""
    return "; ".join(f"{n} = {s.help}" for n, s in REGISTRY.items())


def check_virtual_stages(name: str, virtual_stages: int) -> None:
    """Raise ValueError if ``virtual_stages`` is illegal for ``name``."""
    spec = REGISTRY.get(name)
    if spec is None:
        raise ValueError(
            f"unknown schedule {name!r}; registered: {list(REGISTRY)}")
    if virtual_stages < spec.min_virtual:
        raise ValueError(
            f"--schedule {name} needs --virtual-stages >= {spec.min_virtual}"
            f", got {virtual_stages}")
    if spec.max_virtual is not None and virtual_stages > spec.max_virtual:
        raise ValueError(
            f"--schedule {name} is a V={spec.max_virtual} schedule "
            f"(got --virtual-stages {virtual_stages}); see core/schedules")


def get_schedule(name: str, *, n_ranks: int, n_layers: int,
                 virtual_stages: int = 1,
                 n_microbatches: int = 1) -> StageAssignment:
    """Build a registered schedule, validating the V range first."""
    check_virtual_stages(name, virtual_stages)
    return REGISTRY[name].factory(n_ranks, virtual_stages, n_layers,
                                  n_microbatches)


register_schedule(ScheduleSpec(
    name="contiguous",
    factory=lambda K, V, n, D: StageAssignment(K, 1, n),
    help="the paper's TeraPipe table (V=1, autodiff backward)",
))
register_schedule(ScheduleSpec(
    name="interleaved",
    factory=lambda K, V, n, D: StageAssignment(K, V, n),
    help="Megatron virtual stages (set --virtual-stages >= 2; autodiff "
         "backward, ~V× smaller bubble)",
    min_virtual=2, max_virtual=None,
))
register_schedule(ScheduleSpec(
    name="1f1b",
    factory=lambda K, V, n, D: OneFOneB(K, 1, n, D),
    help="memory-bounded explicit-backward table (V=1; live activations "
         "flat in the microbatch count)",
    has_backward=True,
))
register_schedule(ScheduleSpec(
    name="interleaved-1f1b",
    factory=lambda K, V, n, D: InterleavedOneFOneB(K, V, n, D),
    help="skew-buffered interleaved 1F1B (V >= 2): 1F1B's flat-in-D memory "
         "bound with interleaving's ~V× smaller bubble",
    min_virtual=2, max_virtual=None, has_backward=True,
))
register_schedule(ScheduleSpec(
    name="zb-h1",
    factory=lambda K, V, n, D: ZeroBubbleH1(K, 1, n, D),
    help="ZB-H1 zero-bubble (V=1): 1F1B with each bwd split into B "
         "(input-cotangent) and W (weight-grad) units; W fills the drain",
    has_backward=True, splits_backward=True,
))
register_schedule(ScheduleSpec(
    name="streaming",
    factory=lambda K, V, n, D: StreamingSchedule(K, 1, n),
    help="fwd-only serving flow (V=1): the tick table is generated from a "
         "live request queue (prefill chunks + token-synchronous decode "
         "rounds; see core/schedules/streaming.py and repro.serve)",
))


__all__ = ["BWD_RING_KINDS", "CommPlan", "InterleavedOneFOneB", "KIND_BWD",
           "KIND_BWD_INPUT", "KIND_BWD_WEIGHT", "KIND_FWD", "KIND_IDLE",
           "OneFOneB", "REGISTRY", "RETIRING_KINDS", "ScheduleSpec",
           "ScheduleValidationError", "StageAssignment", "StreamUnit",
           "StreamingSchedule", "ZeroBubbleH1", "check_virtual_stages",
           "contiguous", "decode_round", "get_schedule",
           "interleave_stacked", "interleaved", "interleaved_one_f_one_b",
           "kind_name", "one_f_one_b", "prefill_unit", "register_schedule",
           "schedule_help", "schedule_names", "streaming",
           "uninterleave_stacked", "zb_h1"]
