"""Device ms a frame of the tracker without its gates (prediction, pyramid, KLT, detector, refill): frame begin to gate begin plus gate end to tracker end, from the program's stamps over an instrumented pass's frames after its first chunk."""

from benchmark import program_trace

read = program_trace.reader("frontend_ms_per_frame")
