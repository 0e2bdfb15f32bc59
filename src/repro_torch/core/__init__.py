"""Planning layer: DP slicing (``dp``) and the schedule IR (``schedules``)."""
