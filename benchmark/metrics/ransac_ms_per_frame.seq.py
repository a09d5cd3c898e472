"""Device ms a frame of the tracker's RANSAC and median-flow gates: gate begin to gate end, from the program's stamps over an instrumented pass's frames after its first chunk."""

from benchmark import program_trace

read = program_trace.reader("ransac_ms_per_frame")
