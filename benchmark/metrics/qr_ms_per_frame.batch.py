"""Device ms a batched frame in cuSOLVER's and cuBLAS's Householder QR kernels (found by name) in the traced stretch."""

from benchmark import readers

read = readers.qr_ms_per_frame
