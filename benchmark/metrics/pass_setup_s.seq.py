"""Seconds of set-up inside each run_dataset pass (runner, graph capture, first-chunk timing), the mean of the passes' summaries."""

from benchmark import readers

read = readers.host("pass_setup_s")
