"""Host ms a frame on the fused path's main thread (iter_wait, IMU window assembly, chunk packing, upload, dispatch), from each pass's summary, weighted over the passes."""

from benchmark import readers

read = readers.host("host_ms_per_frame")
