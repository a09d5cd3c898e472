"""Hand state across between ``eqvio_tpu`` and this package.

The ``*_from_numpy`` functions take the JAX package's ``EqFState``,
``TrackerState`` and ``Settings`` (or any objects with the same field names
whose leaves ``np.asarray`` accepts) and build the port's types on a given
device and dtype; :func:`eqf_state_to_numpy` goes the other way.  Nothing
here imports ``jax``: the JAX objects are read by attribute.  Leaves keep
their shapes, so a JAX batch's states and trackers (a leading lane axis,
as ``_make_batch_chunk_runner`` carries them) become the port's batched
carry for ``app.run_opt.BatchChunkRunner`` as they are.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .filter import EqFState, Settings
from .frontend.tracker import TrackerState
from .group import VIOGroup
from .lie import SE3, SOT3
from .states import VIOSensorState, VIOState


def _f(x, dtype, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float64), dtype=dtype, device=device)


def _i(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.int64), device=device)


def _b(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=bool), device=device)


def _se3(src, dtype, device) -> SE3:
    return SE3(_f(src.R, dtype, device), _f(src.x, dtype, device))


def vio_state_from_numpy(src, dtype: torch.dtype, device) -> VIOState:
    s = src.sensor
    return VIOState(
        sensor=VIOSensorState(
            bias=_f(s.bias, dtype, device),
            pose=_se3(s.pose, dtype, device),
            velocity=_f(s.velocity, dtype, device),
            camera_offset=_se3(s.camera_offset, dtype, device),
        ),
        landmarks=_f(src.landmarks, dtype, device),
        ids=_i(src.ids, device),
        mask=_b(src.mask, device),
    )


def group_from_numpy(src, dtype: torch.dtype, device) -> VIOGroup:
    return VIOGroup(
        beta=_f(src.beta, dtype, device),
        A=_se3(src.A, dtype, device),
        w=_f(src.w, dtype, device),
        B=_se3(src.B, dtype, device),
        Q=SOT3(_f(src.Q.R, dtype, device), _f(src.Q.a, dtype, device)),
    )


def eqf_state_from_numpy(src, dtype: torch.dtype, device) -> EqFState:
    return EqFState(
        xi0=vio_state_from_numpy(src.xi0, dtype, device),
        X=group_from_numpy(src.X, dtype, device),
        Sigma=_f(src.Sigma, dtype, device),
        t=_f(src.t, dtype, device),
    )


def tracker_state_from_numpy(src, device) -> TrackerState:
    """Tracker state on ``device``; positions and pyramid stay float32."""
    f32 = torch.float32
    return TrackerState(
        positions=_f(src.positions, f32, device),
        ids=_i(src.ids, device),
        mask=_b(src.mask, device),
        next_id=_i(src.next_id, device),
        pyramid=tuple(_f(level, f32, device) for level in src.pyramid),
        searched=_b(src.searched, device),
    )


def settings_from_jax_settings(src) -> Settings:
    return Settings(**{f.name: getattr(src, f.name) for f in dataclasses.fields(Settings)})


def _to_numpy(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_to_numpy(v) for v in obj))
    return obj


def eqf_state_to_numpy(state: EqFState) -> EqFState:
    """The same nested NamedTuples with numpy leaves."""
    return _to_numpy(state)
