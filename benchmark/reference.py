"""The plain reference: the frame steps of the benchmark's entries, run
eagerly on :mod:`benchmark.frozen`, one sequence at a time.

:func:`frame_feed`, :func:`initial_state` and :class:`FrameStep` redo what
``run_dataset``'s fused path does for a reader (settings, IMU windows,
attitude initialisation; tracker, propagation and vision update per frame)
from the scene itself.

``precision`` picks the arithmetic: ``"f64"`` (the reference: the filter in
float64 on the host, the front end in float32 as the configuration states,
the plain KLT) or ``"control"`` (the control: the filter in float32 with
TF32 matmuls on the card and the front end's pyramid held in bfloat16), the
step below the configuration's float32 that a later change might take.  The
front end runs on the device the program ran it on (``front``): the image
convolutions of the pyramid and the detector round otherwise on the host
than on the card, and a fast track's solve can carry that to a tenth of a
pixel.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from .frozen import filter as F
from .frozen.camera import EquidistantCamera, PinholeCamera, RadTanCamera
from .frozen.frontend.detector import equalize_histogram
from .frozen.frontend.pyramid import build_pyramid
from .frozen.frontend.tracker import tracker_init, tracker_step
from .frozen.io.config import safe_get, settings_from_config, tracker_config_from_config
from .frozen.states import IMU


def filter_dtype(precision: str) -> torch.dtype:
    return torch.float64 if precision == "f64" else torch.float32


@contextlib.contextmanager
def arithmetic(precision: str):
    """TF32 matmuls on for the control, off (float32 in full) otherwise."""
    keep = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    on = precision == "control"
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def _rotation_to_quaternion(M: np.ndarray) -> np.ndarray:
    t = np.trace(M)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (M[2, 1] - M[1, 2]) / s, (M[0, 2] - M[2, 0]) / s, (M[1, 0] - M[0, 1]) / s])
    k = int(np.argmax(np.diag(M)))
    i1, i2 = (k + 1) % 3, (k + 2) % 3
    s = np.sqrt(1.0 + M[k, k] - M[i1, i1] - M[i2, i2]) * 2
    q = np.zeros(4)
    q[1 + k] = 0.25 * s
    q[0] = (M[i2, i1] - M[i1, i2]) / s
    q[1 + i1] = (M[i1, k] + M[k, i1]) / s
    q[1 + i2] = (M[i2, k] + M[k, i2]) / s
    return q


def camera_of(info, dtype, device):
    fx, fy, cx, cy = info.intrinsics
    w, h = info.resolution
    if info.model == "equidistant":
        return EquidistantCamera.create(fx, fy, cx, cy, info.distortion, w, h, dtype=dtype, device=device)
    if np.allclose(info.distortion, 0.0):
        return PinholeCamera.create(fx, fy, cx, cy, w, h, dtype=dtype, device=device)
    return RadTanCamera.create(fx, fy, cx, cy, info.distortion, w, h, dtype=dtype, device=device)


def camera_lag(config: dict) -> float:
    """The configuration's ``main:cameraLag``: how far the camera's stamps
    lag the IMU's, in seconds."""
    return float((config.get("main", {}) or {}).get("cameraLag", 0.0) or 0.0)


def imu_window_size(scene) -> int:
    """The IMU samples per frame window ``run_dataset`` takes: the median
    ratio of the rates with margin, in fours."""
    ratio = float(np.median(np.diff(scene.images.stamps)) / np.median(np.diff(scene.imu.stamps)))
    return max(8, (int(np.ceil(ratio * 1.25)) + 6) // 4 * 4)


def settings_for(config: dict, scene, program_dtype: torch.dtype):
    """The filter settings a run of ``program_dtype`` uses: the config's,
    with the camera offset from the scene's extrinsics, and the
    square-root covariance that float32 turns on unless the config says."""
    settings = settings_from_config(config)
    T_BS = scene.camera.T_BS
    settings = dataclasses.replace(settings, camera_offset_quat=tuple(_rotation_to_quaternion(T_BS[:3, :3]).tolist()),
                                   camera_offset_pos=tuple(T_BS[:3, 3].tolist()))
    explicit = safe_get(config.get("eqf", {}) or {}, "settings:useSqrtCovariance", None, warn=False)
    if program_dtype == torch.float32 and not settings.sqrt_covariance and explicit is None:
        settings = dataclasses.replace(settings, sqrt_covariance=True)
    return settings


def _imu_window(imu_buf, t_prev, stamp, K):
    """The zero-dt-padded window over ``[t_prev, stamp]`` and the trimmed
    buffer (``run_opt._build_imu_window``)."""
    kept = []
    for j, (ts, gyr, acc) in enumerate(imu_buf):
        t1 = imu_buf[j + 1][0] if j + 1 < len(imu_buf) else stamp
        dt = max(min(t1, stamp) - max(ts, t_prev), 0.0)
        if dt > 0 or not kept:
            kept.append((ts, gyr, acc, dt))
    kept = kept[-K:]
    st = np.full(K, stamp, dtype=np.float64)
    gy, ac, dts = np.zeros((K, 3)), np.zeros((K, 3)), np.zeros(K)
    for j, (ts, g, a, dt) in enumerate(kept):
        st[j], gy[j], ac[j], dts[j] = ts, g, a, dt
    gy[len(kept):] = kept[-1][1]
    ac[len(kept):] = kept[-1][2]
    trimmed = [e for j, e in enumerate(imu_buf) if j + 1 >= len(imu_buf) or imu_buf[j + 1][0] > stamp]
    return (st, gy, ac, dts), trimmed


def frame_feed(scene, frames: int, K: int, lag: float = 0.0):
    """The first IMU sample ``(stamp, gyr, acc)`` and, for the first
    ``frames`` frames, ``(frame index, stamp, IMU window)``: the merged
    stream of ``DataServer`` and the windows of ``FrameFeed``, the image
    stamps moved ``lag`` seconds earlier as the readers do."""
    imu, images = scene.imu, scene.images
    stamps = images.stamps - lag if lag else images.stamps
    first, out, buf = None, [], []
    t_prev, k = -1.0, 0
    for i, stamp in enumerate(stamps):
        while k < len(imu.stamps) and imu.stamps[k] <= stamp:
            if first is None:
                first = (float(imu.stamps[k]), imu.gyr[k], imu.acc[k])
                t_prev = float(imu.stamps[k])
            buf.append((float(imu.stamps[k]), imu.gyr[k], imu.acc[k]))
            k += 1
        if first is None:
            continue
        window, buf = _imu_window(buf, t_prev, float(stamp), K)
        t_prev = float(stamp)
        out.append((i, float(stamp), window))
        if len(out) >= frames:
            break
    return first, out


def initial_state(settings, tcfg, first, shape, dtype, device, front):
    """The filter state on ``device`` after the first IMU sample and the
    empty tracker on ``front``."""
    state = F.init_state(settings, tcfg.max_features, dtype, device)
    stamp, gyr, acc = first
    state = F.initialize_attitude_from_imu(state, IMU.create(stamp, gyr, acc, dtype=dtype, device=device))
    return state, tracker_init(tcfg, shape, front)


def pyramid_of(img_u8: torch.Tensor, tcfg) -> tuple:
    """The tracker's pyramid of a uint8 frame, as its carry holds it."""
    img = img_u8.to(torch.float32) * (1.0 / 255.0)
    if tcfg.equalize_histogram:
        img = equalize_histogram(img)
    return tuple(build_pyramid(img, tcfg.max_level + 1))


def _bf16_pyramid(tracker):
    return tracker._replace(pyramid=tuple(p.to(torch.bfloat16).to(torch.float32) for p in tracker.pyramid))


class FrameStep:
    """One sequence's fused frame step, eager: ``step(state, tracker,
    uint8 image, (stamps, gyr, acc, dts), stamp) -> (state, tracker,
    outputs)`` with ``outputs`` the estimate's position ``[3]``, the
    landmarks ``[N, 3]``, their ids and mask, and the tracker's pixels
    ``[N, 2]``, ids and visibility (``run_opt._make_frame_fn``).  The
    filter runs on ``device``, the tracker on ``front``, the device the
    program ran its tracker on."""

    def __init__(self, config: dict, scene, program_dtype: torch.dtype, precision: str, device, front):
        self.precision, self.device, self.front = precision, device, torch.device(front)
        self.dtype = filter_dtype(precision)
        self.settings = settings_for(config, scene, program_dtype)
        self.tcfg = tracker_config_from_config(config)
        self.suite = self.settings.suite
        self.camera = camera_of(scene.camera, self.dtype, device)
        self.K = imu_window_size(scene)

    def __call__(self, state, tracker, img_u8, window, stamp):
        dt, dev = self.dtype, self.device
        st, gy, ac, dts = (torch.as_tensor(a, dtype=dt, device=dev) for a in window)
        zeros = torch.zeros_like(gy)
        imu = IMU(st, gy, ac, zeros, zeros)
        img = img_u8.to(device=self.front, dtype=torch.float32) * (1.0 / 255.0)
        if self.precision == "control":
            tracker = _bf16_pyramid(tracker)
        if self.settings.use_feature_predictions:
            xi = F.predict_state(state, imu, dts)
            predicted = self.camera.project(xi.landmarks).to(device=self.front, dtype=torch.float32)
            predicted = torch.where(xi.mask.to(self.front)[:, None], predicted, tracker.positions)
            tracker = tracker_step(tracker, img, self.tcfg, predicted=predicted)
        else:
            tracker = tracker_step(tracker, img, self.tcfg)
        pixels = tracker.positions.to(device=dev, dtype=dt)
        state = F.propagate_window(state, imu, dts, self.settings, self.suite, wide_factor=True)
        state = F.process_vision(state, pixels, tracker.mask.to(dev), tracker.ids.to(dev), self.camera,
                                 self.settings, self.suite)
        state = state._replace(t=torch.as_tensor(stamp, dtype=dt, device=dev))
        est = F.state_estimate(state)
        return state, tracker, {
            "position": est.sensor.pose.x, "landmarks": est.landmarks, "lm_ids": est.ids, "lm_mask": est.mask,
            "pixels": tracker.positions, "ids": tracker.ids, "vis": tracker.mask,
        }

    def run(self, state, tracker, frames: torch.Tensor, feed) -> list[dict]:
        """Frames ``feed`` (``(frame index, stamp, window)``, indices into
        ``frames``) from ``(state, tracker)``: each frame's outputs as
        numpy arrays."""
        rows = []
        with arithmetic(self.precision), torch.no_grad():
            for i, stamp, window in feed:
                state, tracker, out = self(state, tracker, frames[i], window, stamp)
                rows.append({k: v.detach().cpu().numpy() for k, v in out.items()})
        return rows
