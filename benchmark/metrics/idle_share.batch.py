"""The share of the traced steady stretch in which no kernel, copy or fill ran on the device, in %."""

from benchmark import readers

read = readers.idle_share
