"""Device ms a frame of the IMU-window propagation: tracker end to propagation end, from the program's stamps over an instrumented pass's frames after its first chunk."""

from benchmark import program_trace

read = program_trace.reader("propagation_ms_per_frame")
