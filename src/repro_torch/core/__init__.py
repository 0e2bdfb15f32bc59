"""Planning layer and pipeline executor: the schedule IR (``schedules``),
slicing schemes (``schedule``), the DP slice planner (``dp``), the pipeline
simulator (``simulator``), the cost models (``cost_model``) and the
token-slice pipeline (``pipeline``)."""
