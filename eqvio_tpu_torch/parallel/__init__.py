"""Batched filter instances over a leading lane axis (one device, no mesh)."""

from .batch import batch_sim_step, make_batched_states

__all__ = ["batch_sim_step", "make_batched_states"]
