"""VIO state space with fixed-capacity masked landmarks (counterpart of
``eqvio_tpu/states.py``).

Landmarks live in a fixed-capacity ``[N, 3]`` tensor with an activity mask
and id slots; add/remove are mask flips, never reshapes.  State-vector layout:
bias [0, 6), pose [6, 12), body velocity [12, 15), camera offset [15, 21),
landmark i at [21 + 3i, 24 + 3i).  Inactive slots hold the dummy point
``(0, 0, 1)`` so every chart stays finite.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .lie import SE3, mv, se3_identity, se3_inv, se3_mul, so3_exp

GRAVITY = 9.80665
SENSOR_DIM = 21
DUMMY_POINT = (0.0, 0.0, 1.0)


class IMU(NamedTuple):
    stamp: torch.Tensor  # [...]
    gyr: torch.Tensor  # [..., 3]
    acc: torch.Tensor  # [..., 3]
    gyr_bias_vel: torch.Tensor  # [..., 3]
    acc_bias_vel: torch.Tensor  # [..., 3]

    @staticmethod
    def create(stamp, gyr, acc, dtype: torch.dtype, device, gyr_bias_vel=None, acc_bias_vel=None) -> "IMU":
        """An IMU reading; the bias velocities are zero unless given."""
        gyr = torch.as_tensor(gyr, dtype=dtype, device=device)
        acc = torch.as_tensor(acc, dtype=dtype, device=device)
        t = lambda a: torch.zeros_like(gyr) if a is None else torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
        return IMU(torch.as_tensor(stamp, dtype=dtype, device=device), gyr, acc, t(gyr_bias_vel), t(acc_bias_vel))


class VIOSensorState(NamedTuple):
    bias: torch.Tensor  # [..., 6] gyr then acc
    pose: SE3
    velocity: torch.Tensor  # [..., 3] body-fixed
    camera_offset: SE3

    def gravity_dir(self) -> torch.Tensor:
        """R^T e3."""
        return self.pose.R[..., 2, :]


class VIOState(NamedTuple):
    sensor: VIOSensorState
    landmarks: torch.Tensor  # [..., N, 3] camera-frame points
    ids: torch.Tensor  # [..., N] int64, -1 when inactive
    mask: torch.Tensor  # [..., N] bool

    @property
    def capacity(self) -> int:
        return self.landmarks.shape[-2]

    def dim(self) -> int:
        return SENSOR_DIM + 3 * self.capacity


def sensor_identity(dtype: torch.dtype, device, batch_shape=()) -> VIOSensorState:
    batch_shape = tuple(batch_shape)
    return VIOSensorState(
        bias=torch.zeros(*batch_shape, 6, dtype=dtype, device=device),
        pose=se3_identity(dtype, device, batch_shape),
        velocity=torch.zeros(*batch_shape, 3, dtype=dtype, device=device),
        camera_offset=se3_identity(dtype, device, batch_shape),
    )


def state_identity(capacity: int, dtype: torch.dtype, device, batch_shape=()) -> VIOState:
    batch_shape = tuple(batch_shape)
    return VIOState(
        sensor=sensor_identity(dtype, device, batch_shape),
        landmarks=torch.tensor(DUMMY_POINT, dtype=dtype, device=device).repeat(*batch_shape, capacity, 1),
        ids=torch.full((*batch_shape, capacity), -1, dtype=torch.int64, device=device),
        mask=torch.zeros(*batch_shape, capacity, dtype=torch.bool, device=device),
    )


def imu_minus_bias(imu: IMU, bias: torch.Tensor):
    return imu.gyr - bias[..., 0:3], imu.acc - bias[..., 3:6]


def _gravity_vec(like: torch.Tensor) -> torch.Tensor:
    g = torch.zeros_like(like)
    g[..., 2].fill_(-GRAVITY)
    return g


def integrate_system(state: VIOState, imu: IMU, dt: torch.Tensor) -> VIOState:
    """Discrete IMU integration: second-order position update and exact
    body-frame landmark advection.  ``dt == 0`` is an exact no-op."""
    sensor = state.sensor
    gyr_est, acc_est = imu_minus_bias(imu, sensor.bias)
    dt_ = torch.as_tensor(dt, dtype=sensor.velocity.dtype, device=sensor.velocity.device)[..., None]

    new_bias = sensor.bias + dt_ * torch.cat([imu.gyr_bias_vel, imu.acc_bias_vel], dim=-1)

    R = sensor.pose.R
    Rt = R.transpose(-1, -2)
    grav = _gravity_vec(sensor.velocity)

    change_R = so3_exp(dt_ * gyr_est)
    inertial_disp = dt_ * mv(R, sensor.velocity) + (0.5 * dt_ * dt_) * (mv(R, acc_est) + grav)
    change = SE3(change_R, mv(Rt, inertial_disp))

    new_pose = se3_mul(sensor.pose, change)

    inertial_vel_diff = mv(R, acc_est) + grav
    new_velocity = mv(
        new_pose.R.transpose(-1, -2), mv(R, sensor.velocity) + dt_ * inertial_vel_diff
    )

    cam_change_inv = se3_mul(
        se3_inv(sensor.camera_offset), se3_mul(se3_inv(change), sensor.camera_offset)
    )
    # every landmark through one pose: p R^T + x, a plain product (a matvec
    # broadcast over the landmarks copies the rotation per landmark under vmap)
    new_landmarks = state.landmarks @ cam_change_inv.R.transpose(-1, -2) + cam_change_inv.x[..., None, :]
    return VIOState(
        sensor=VIOSensorState(new_bias, new_pose, new_velocity, sensor.camera_offset),
        landmarks=new_landmarks,
        ids=state.ids,
        mask=state.mask,
    )


def measure_system(state: VIOState, camera) -> tuple[torch.Tensor, torch.Tensor]:
    """Project all landmark slots: ``(pixels [..., N, 2], valid [..., N])``."""
    pixels = camera.project(state.landmarks)
    valid = state.mask & camera.is_in_domain(state.landmarks)
    return pixels, valid


def state_coords_vector(eps_sensor: torch.Tensor, eps_points: torch.Tensor) -> torch.Tensor:
    flat = eps_points.reshape(*eps_points.shape[:-2], -1)
    return torch.cat([eps_sensor, flat], dim=-1)


def split_coords_vector(eps: torch.Tensor, capacity: int):
    sensor = eps[..., :SENSOR_DIM]
    points = eps[..., SENSOR_DIM:].reshape(*eps.shape[:-1], capacity, 3)
    return sensor, points
