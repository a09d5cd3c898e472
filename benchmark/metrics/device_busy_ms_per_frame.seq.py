"""Device busy ms a frame (a batched frame in the batch cell): the union of device intervals over the traced steady stretch, over its graph launches."""

from benchmark import readers

read = readers.busy_ms_per_frame
