"""The share of an instrumented pass's stretch (its frames after the first chunk, first begin to last end) in which no frame step ran on the device, in %, from the program's stamps with no profiler running."""

from benchmark import program_trace

read = program_trace.reader("step_idle_share")
