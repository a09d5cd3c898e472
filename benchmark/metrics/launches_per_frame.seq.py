"""Kernels a frame in the traced steady stretch: the kernels the frames' graph launches ran, over the launches."""

from benchmark import readers

read = readers.kernels_per_frame
