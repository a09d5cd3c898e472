"""Seconds of the timing replays, the enqueue probe and the cost count in the set-up of the window's last run_dataset pass (its summary's setup_parts_s)."""

from benchmark import program_trace

read = program_trace.setup_part("timing_replays", "enqueue_probe", "cost_count")
