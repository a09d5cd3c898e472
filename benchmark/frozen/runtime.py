"""Runtime numeric configuration shared by the CLI entry points.

Counterpart of ``eqvio_tpu/app/_env.py``.  The filter's Riccati and update
math needs full float32 products on the GPU: TF32 (on by default for cuDNN
convolutions) keeps about three decimal digits, the Hopper analogue of the
TPU's bfloat16 default that was fatal for the filter.  So both TF32 switches
are turned off and float32 matmul precision is pinned to ``highest``.

Device policy: the card by default, the CPU only when the caller asks for
it; a run on CUDA, asked for or by default, on a machine without a card
raises instead of dropping to the CPU.  Filter math runs in
float64 on the CPU and float32 on CUDA (square-root covariance keeps f32
finite); the image front end is float32 everywhere.
"""

from __future__ import annotations

import functools
import os

import torch


def configure_runtime(device: str = "cuda") -> tuple[torch.device, torch.dtype]:
    """Set the global precision knobs; returns ``(device, filter dtype)``.

    ``EQVIO_DEBUG_NANS=1`` turns on autograd anomaly detection, and
    :func:`check_finite` calls in the run loop raise on the first non-finite
    state (the runtime analogue of ``jax_debug_nans``).
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch.cuda.is_available() is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r} (use cpu or cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    if debug_nans():
        torch.autograd.set_detect_anomaly(True)
    return dev, (torch.float64 if dev.type == "cpu" else torch.float32)


@functools.cache
def const(values, dtype: torch.dtype, device) -> torch.Tensor:
    """The tensor of ``values`` (a number or a nested tuple) on ``device``,
    built once per ``(values, dtype, device)``.

    A frame step that builds a tensor from Python data makes a host-to-device
    copy each time, which a CUDA graph cannot capture; the step takes its
    constants from here instead, so only the first (warm-up) call copies.
    Callers never write to the result.
    """
    return torch.tensor(values, dtype=dtype, device=device)


def debug_nans() -> bool:
    return bool(os.environ.get("EQVIO_DEBUG_NANS"))


def check_finite(name: str, *tensors: torch.Tensor) -> None:
    """Raise if any tensor holds a NaN or Inf (only called under EQVIO_DEBUG_NANS)."""
    for t in tensors:
        if not bool(torch.isfinite(t).all()):
            raise FloatingPointError(f"non-finite values in {name}")
