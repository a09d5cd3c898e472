"""Moving values between the program's types and the frozen copy's.

:mod:`benchmark.frozen` mirrors ``eqvio_tpu_torch`` module by module, so a
named tuple of one (``EqFState``, ``SE3``, ``TrackerState``, a camera) has a
class of the same name in the same module of the other.  The program gets
its inputs in its own types; the reference reads the program's state in
the frozen types.
"""

from __future__ import annotations

import importlib

import torch

PROGRAM = "eqvio_tpu_torch"
FROZEN = __package__ + ".frozen"


def _counterpart(cls, src: str, dst: str):
    mod = cls.__module__
    if not mod.startswith(src):
        raise TypeError(f"{cls.__qualname__} of {mod} has no counterpart in {dst}")
    return getattr(importlib.import_module(dst + mod[len(src):]), cls.__qualname__)


def _move(obj, src: str, dst: str, tensor):
    if isinstance(obj, torch.Tensor):
        return tensor(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        cls = _counterpart(type(obj), src, dst)
        return cls(*(_move(v, src, dst, tensor) for v in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_move(v, src, dst, tensor) for v in obj)
    return obj


def to_program(obj, tensor=lambda t: t):
    """``obj`` (frozen types) rebuilt in the program's types, each tensor
    passed through ``tensor``."""
    return _move(obj, FROZEN, PROGRAM, tensor)


def to_frozen(obj, tensor=lambda t: t):
    """``obj`` (the program's types) rebuilt in the frozen types."""
    return _move(obj, PROGRAM, FROZEN, tensor)


def cast(dtype: torch.dtype, device):
    """A ``tensor`` function for the two above: floating tensors to
    ``dtype`` on ``device``, the others to ``device``."""
    def f(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=device, dtype=dtype) if t.is_floating_point() else t.to(device)
    return f
