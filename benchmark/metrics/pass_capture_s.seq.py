"""Seconds of the graph's warm-up steps, capture and instantiation in the set-up of the window's last run_dataset pass (its summary's setup_parts_s)."""

from benchmark import program_trace

read = program_trace.setup_part("capture")
