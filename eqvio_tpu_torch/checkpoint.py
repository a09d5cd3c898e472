"""Checkpoint and resume of the whole pipeline state (counterpart of
``eqvio_tpu/checkpoint.py``).

The filter state, the tracker state and the stream cursor go into one
``.npz`` under the JAX package's keys and dtypes (``xi0.*``, ``X.*``,
``Sigma``, ``t``, ``trk.*``, ``cursor_json``; ids int32), so either package
loads the other's file.  The tracker's ``searched`` flag is not saved: the
next step does not read it.  :func:`state_to_csv_line` and
:func:`state_from_csv_line` serialise the filter state in the reference's
one-line ``[xi0, X, Sigma]`` CSV form.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from . import filter as F
from .convert import eqf_state_from_numpy, tracker_state_from_numpy
from .frontend.tracker import TrackerState
from .group import VIOGroup
from .lie import SE3, SOT3
from .states import DUMMY_POINT, VIOSensorState, VIOState

_STATE_KEYS = [
    "xi0.bias", "xi0.pose.R", "xi0.pose.x", "xi0.velocity",
    "xi0.camoff.R", "xi0.camoff.x", "xi0.landmarks", "xi0.ids", "xi0.mask",
    "X.beta", "X.A.R", "X.A.x", "X.w", "X.B.R", "X.B.x", "X.Q.R", "X.Q.a",
    "Sigma", "t",
]
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _ids32(x: torch.Tensor) -> np.ndarray:
    """Ids in the JAX package's int32."""
    a = _np(x)
    if a.size and (a.max() > np.iinfo(np.int32).max or a.min() < -1):
        raise ValueError(f"ids outside int32: {a.min()}..{a.max()}")
    return a.astype(np.int32)


def _flatten_state(state: F.EqFState) -> dict:
    xi0, X = state.xi0, state.X
    s = xi0.sensor
    vals = [s.bias, s.pose.R, s.pose.x, s.velocity, s.camera_offset.R, s.camera_offset.x,
            xi0.landmarks, None, xi0.mask, X.beta, X.A.R, X.A.x, X.w, X.B.R, X.B.x, X.Q.R, X.Q.a,
            state.Sigma, state.t]
    out = {k: _np(v) for k, v in zip(_STATE_KEYS, vals) if v is not None}
    out["xi0.ids"] = _ids32(xi0.ids)
    return out


def _unflatten_state(d: dict, dtype: torch.dtype | None, device) -> F.EqFState:
    sensor = VIOSensorState(d["xi0.bias"], SE3(d["xi0.pose.R"], d["xi0.pose.x"]), d["xi0.velocity"],
                            SE3(d["xi0.camoff.R"], d["xi0.camoff.x"]))
    state = F.EqFState(
        xi0=VIOState(sensor, d["xi0.landmarks"], d["xi0.ids"], d["xi0.mask"]),
        X=VIOGroup(d["X.beta"], SE3(d["X.A.R"], d["X.A.x"]), d["X.w"], SE3(d["X.B.R"], d["X.B.x"]),
                   SOT3(d["X.Q.R"], d["X.Q.a"])),
        Sigma=d["Sigma"], t=d["t"],
    )
    return eqf_state_from_numpy(state, dtype or _TORCH_DTYPES[d["Sigma"].dtype], device)


def save_checkpoint(path: str, state: F.EqFState, tracker: TrackerState | None = None,
                    cursor: dict | None = None, rng_key=None) -> None:
    """Save the filter state (and the tracker state, a JSON-able stream
    cursor and an RNG key, if given) to ``path``.  ``rng_key`` is raw key
    data (an integer array or tensor of uint32 values), stored as uint32
    under the JAX package's ``rng_key``, where ``jax.random.wrap_key_data``
    reads it back.  Reads the tensors to the host, so on the card it waits
    for the work that writes them."""
    out = _flatten_state(state)
    if tracker is not None:
        out["trk.positions"] = _np(tracker.positions)
        out["trk.ids"] = _ids32(tracker.ids)
        out["trk.mask"] = _np(tracker.mask)
        out["trk.next_id"] = _ids32(tracker.next_id)
        for level, img in enumerate(tracker.pyramid):
            out[f"trk.pyr{level}"] = _np(img)
    if rng_key is not None:
        key = np.asarray(_np(rng_key) if isinstance(rng_key, torch.Tensor) else rng_key)
        if key.dtype.kind not in "iu" or (key.size and (key.min() < 0 or key.max() > np.iinfo(np.uint32).max)):
            raise ValueError(f"rng_key is not uint32 key data: {key.dtype} {key.ravel()[:4]}")
        out["rng_key"] = key.astype(np.uint32)
    out["cursor_json"] = np.frombuffer(json.dumps(cursor or {}).encode(), dtype=np.uint8)
    np.savez(path, **out)


def load_checkpoint(path: str, dtype: torch.dtype | None = None, device="cuda"):
    """``(state, tracker or None, cursor, rng key data or None)`` on
    ``device``; the filter in ``dtype`` (default: the saved one), ids int64,
    the tracker's ``searched`` True.  A JAX package's ``rng_key`` comes back
    as its raw key data (uint32, on the host)."""
    d = dict(np.load(path, allow_pickle=False))
    state = _unflatten_state(d, dtype, device)
    tracker = None
    if "trk.positions" in d:
        levels = sorted(int(k[len("trk.pyr"):]) for k in d if k.startswith("trk.pyr"))
        tracker = tracker_state_from_numpy(TrackerState(
            positions=d["trk.positions"], ids=d["trk.ids"], mask=d["trk.mask"], next_id=d["trk.next_id"],
            pyramid=tuple(d[f"trk.pyr{level}"] for level in levels), searched=np.asarray(True)), device)
    cursor = json.loads(bytes(d["cursor_json"].tobytes()).decode() or "{}")
    return state, tracker, cursor, d.get("rng_key")


def state_to_csv_line(state: F.EqFState, settings: F.Settings) -> str:
    """The filter state as one CSV line ``[xi0, X, Sigma]`` in the
    reference's layout (``VIO_eqf.cpp:247``): ``xi0`` = pose (x, quaternion
    wxyz), velocity, camera offset (x, quaternion), bias, N, then ``id, p``
    per landmark; ``X`` = beta, A (x, quaternion), w, B (x, quaternion), N,
    then ``id, Q.a, Q.quaternion`` per landmark; ``Sigma`` = the dense
    (21+3N)^2 covariance row-major.  Only active slots are written, in slot
    order.  ``settings`` is required: in square-root mode the state holds
    the factor, and the line holds the covariance."""
    from .io.writer import rotation_to_quaternion as r2q

    xi0, X = state.xi0, state.X
    mask = _np(xi0.mask)
    sl = np.flatnonzero(mask)
    n = len(sl)
    vals: list = []

    def se3(R, x):
        vals.extend(_np(x).ravel())
        vals.extend(r2q(_np(R)))

    s = xi0.sensor
    se3(s.pose.R, s.pose.x)
    vals.extend(_np(s.velocity))
    se3(s.camera_offset.R, s.camera_offset.x)
    vals.extend(_np(s.bias))
    vals.append(n)
    lms, ids = _np(xi0.landmarks), _np(xi0.ids)
    for i in sl:
        vals.append(int(ids[i]))
        vals.extend(lms[i])
    vals.extend(_np(X.beta))
    se3(X.A.R, X.A.x)
    vals.extend(_np(X.w))
    se3(X.B.R, X.B.x)
    vals.append(n)
    Qa, QR = _np(X.Q.a), _np(X.Q.R)
    for i in sl:
        vals.append(int(ids[i]))
        vals.append(Qa[i])
        vals.extend(r2q(QR[i]))
    keep = np.concatenate([np.arange(21), (21 + 3 * sl[:, None] + np.arange(3)).ravel()]) if n else np.arange(21)
    Sigma = _np(F.dense_sigma(state, settings))[np.ix_(keep, keep)]
    vals.extend(Sigma.ravel())
    return ", ".join(str(v) if isinstance(v, int) else f"{float(v):.17g}" for v in vals)


def state_from_csv_line(line: str, capacity: int, settings: F.Settings, dtype: torch.dtype = torch.float64,
                        t: float = 0.0, device="cuda") -> F.EqFState:
    """Parse a :func:`state_to_csv_line` line into a ``capacity``-slot state
    stamped ``t``: landmarks in slots ``0..N-1``, the inactive rest of Sigma
    identity (its factor in square-root mode)."""
    from .analysis import quat_to_rot

    tok = [x.strip() for x in line.split(",")]
    pos = [0]

    def take(k):
        out = np.array([float(x) for x in tok[pos[0]:pos[0] + k]])
        pos[0] += k
        return out

    def se3():
        x = take(3)
        return SE3(quat_to_rot(take(4)), x)

    pose = se3()
    vel = take(3)
    camoff = se3()
    bias = take(6)
    n = int(take(1)[0])
    if n > capacity:
        raise ValueError(f"{n} landmarks > capacity {capacity}")
    ids = np.full(capacity, -1, np.int64)
    lms = np.tile(np.asarray(DUMMY_POINT, float), (capacity, 1))
    for i in range(n):
        ids[i] = int(take(1)[0])
        lms[i] = take(3)
    beta = take(6)
    A = se3()
    w = take(3)
    B = se3()
    n2 = int(take(1)[0])
    if n2 != n:
        raise ValueError(f"malformed state line: X has {n2} landmarks, xi0 has {n}")
    Qa = np.ones(capacity)
    QR = np.tile(np.eye(3), (capacity, 1, 1))
    for i in range(n):
        take(1)  # the id, recorded from xi0
        Qa[i] = take(1)[0]
        QR[i] = quat_to_rot(take(4))
    d = 21 + 3 * n
    Sigma = np.eye(21 + 3 * capacity)
    Sigma[:d, :d] = take(d * d).reshape(d, d)
    if settings.sqrt_covariance:
        Sigma = np.linalg.cholesky(Sigma)
    state = F.EqFState(
        xi0=VIOState(VIOSensorState(bias, pose, vel, camoff), lms, ids, np.arange(capacity) < n),
        X=VIOGroup(beta, A, w, B, SOT3(QR, Qa)), Sigma=Sigma, t=np.asarray(t),
    )
    return eqf_state_from_numpy(state, dtype, device)
