"""The CUDA KLT kernel's share of its roofline: the frozen bound_ms at the cell's shapes over the kernel's mean device time per launch in the traced stretch, in %."""

from benchmark import readers

read = readers.klt_roofline
