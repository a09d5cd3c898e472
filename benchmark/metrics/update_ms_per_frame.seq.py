"""Device ms a frame of the vision step (landmark lifecycle, update, output row): propagation end to frame end, from the program's stamps over an instrumented pass's frames after its first chunk."""

from benchmark import program_trace

read = program_trace.reader("update_ms_per_frame")
