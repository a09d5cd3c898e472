"""Device ms a frame of the frame step, from the program's own stamps: frame end less frame begin, the mean over an instrumented pass's frames after its first chunk."""

from benchmark import program_trace

read = program_trace.reader("step_ms_per_frame")
