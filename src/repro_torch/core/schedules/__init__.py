"""Schedule IR, the parts serving needs (reference:
``repro/core/schedules/__init__.py``): the unit kinds, ``CommPlan``, the
base ``StageAssignment`` and the ``streaming`` schedule.  The training
schedules and the registry arrive with the planning slice."""
from .ir import (BWD_RING_KINDS, KIND_BWD, KIND_BWD_INPUT, KIND_BWD_WEIGHT,
                 KIND_FWD, KIND_IDLE, RETIRING_KINDS, CommPlan,
                 ScheduleValidationError, StageAssignment, kind_name)
from .streaming import (StreamingSchedule, StreamUnit, decode_round,
                        prefill_unit, streaming)

__all__ = ["BWD_RING_KINDS", "CommPlan", "KIND_BWD", "KIND_BWD_INPUT",
           "KIND_BWD_WEIGHT", "KIND_FWD", "KIND_IDLE", "RETIRING_KINDS",
           "ScheduleValidationError", "StageAssignment", "StreamUnit",
           "StreamingSchedule", "decode_round", "kind_name", "prefill_unit",
           "streaming"]
