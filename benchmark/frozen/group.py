"""The VIO symmetry group, its actions and velocity lifts (counterpart of
``eqvio_tpu/group.py``).

Group element ``X = (beta, A in SE(3), w, B in SE(3), Q in SOT(3)^N)`` with
``Q`` batched over landmark slots: ``Q[i]`` always acts on slot ``i``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .lie import (
    SE3,
    SOT3,
    cross,
    mv,
    se3_Adjoint,
    se3_apply,
    se3_exp,
    se3_identity,
    se3_inv,
    se3_mul,
    se23_exp,
    so3_exp,
    so3_from_vectors,
    so3_project,
    sot3_exp,
    sot3_identity,
    sot3_inv,
    sot3_mul,
)
from .states import GRAVITY, IMU, VIOSensorState, VIOState, _gravity_vec, imu_minus_bias


class VIOGroup(NamedTuple):
    beta: torch.Tensor  # [6]
    A: SE3
    w: torch.Tensor  # [3]
    B: SE3
    Q: SOT3  # R [N, 3, 3], a [N]


class VIOAlgebra(NamedTuple):
    u_beta: torch.Tensor  # [6]
    U_A: torch.Tensor  # [6]
    u_w: torch.Tensor  # [3]
    U_B: torch.Tensor  # [6]
    W: torch.Tensor  # [N, 4]


def group_identity(capacity: int, dtype: torch.dtype, device, batch_shape=()) -> VIOGroup:
    batch_shape = tuple(batch_shape)
    return VIOGroup(
        beta=torch.zeros(*batch_shape, 6, dtype=dtype, device=device),
        A=se3_identity(dtype, device, batch_shape),
        w=torch.zeros(*batch_shape, 3, dtype=dtype, device=device),
        B=se3_identity(dtype, device, batch_shape),
        Q=sot3_identity(dtype, device, batch_shape + (capacity,)),
    )


def group_mul(x: VIOGroup, y: VIOGroup) -> VIOGroup:
    return VIOGroup(
        beta=x.beta + y.beta,
        A=se3_mul(x.A, y.A),
        w=x.w + mv(x.A.R, y.w),
        B=se3_mul(x.B, y.B),
        Q=sot3_mul(x.Q, y.Q),
    )


def group_inv(x: VIOGroup) -> VIOGroup:
    return VIOGroup(
        beta=-x.beta,
        A=se3_inv(x.A),
        w=-mv(x.A.R.transpose(-1, -2), x.w),
        B=se3_inv(x.B),
        Q=sot3_inv(x.Q),
    )


def algebra_scale(lam: VIOAlgebra, c) -> VIOAlgebra:
    return VIOAlgebra(lam.u_beta * c, lam.U_A * c, lam.u_w * c, lam.U_B * c, lam.W * c)


def algebra_add(a: VIOAlgebra, b: VIOAlgebra) -> VIOAlgebra:
    return VIOAlgebra(a.u_beta + b.u_beta, a.U_A + b.U_A, a.u_w + b.u_w, a.U_B + b.U_B, a.W + b.W)


def algebra_sub(a: VIOAlgebra, b: VIOAlgebra) -> VIOAlgebra:
    return algebra_add(a, algebra_scale(b, -1.0))


def group_exp(lam: VIOAlgebra) -> VIOGroup:
    """(A, w) through the SE_2(3) exponential."""
    ext = se23_exp(torch.cat([lam.U_A[..., 0:3], lam.U_A[..., 3:6], lam.u_w], dim=-1))
    return VIOGroup(
        beta=lam.u_beta,
        A=SE3(ext.R, ext.x1),
        w=ext.x2,
        B=se3_exp(lam.U_B),
        Q=sot3_exp(lam.W),
    )


def sensor_action(x: VIOGroup, sensor: VIOSensorState) -> VIOSensorState:
    return VIOSensorState(
        bias=sensor.bias + x.beta,
        pose=se3_mul(sensor.pose, x.A),
        velocity=mv(x.A.R.transpose(-1, -2), sensor.velocity - x.w),
        camera_offset=se3_mul(se3_inv(x.A), se3_mul(sensor.camera_offset, x.B)),
    )


def state_action(x: VIOGroup, state: VIOState) -> VIOState:
    """Right action; landmark slot i transforms by ``Q_i^{-1} . p_i``."""
    Qinv = sot3_inv(x.Q)
    return VIOState(
        sensor=sensor_action(x, state.sensor),
        landmarks=Qinv.a[..., None] * mv(Qinv.R, state.landmarks),
        ids=state.ids,
        mask=state.mask,
    )


def output_action(x: VIOGroup, pixels: torch.Tensor, camera) -> torch.Tensor:
    bearings = camera.undistort(pixels)
    return camera.project(mv(x.Q.R.transpose(-1, -2), bearings))


def lift_velocity(state: VIOState, imu: IMU) -> VIOAlgebra:
    """Continuous lift ``Lambda(xi, u)``: the algebra element whose flow
    moves the state as the IMU input does."""
    sensor = state.sensor
    gyr_est, acc_est = imu_minus_bias(imu, sensor.bias)
    U_A = torch.cat([gyr_est, sensor.velocity], dim=-1)
    U_B = mv(se3_Adjoint(se3_inv(sensor.camera_offset)), U_A)
    u_w = -acc_est + sensor.gravity_dir() * GRAVITY
    omega_C, v_C = U_B[..., 0:3], U_B[..., 3:6]
    p = state.landmarks
    p_sq = torch.clamp(torch.sum(p * p, dim=-1), min=1e-12)
    w_rot = omega_C[..., None, :] + cross(p, v_C[..., None, :]) / p_sq[..., None]
    w_scale = torch.sum(p * v_C[..., None, :], dim=-1) / p_sq
    return VIOAlgebra(torch.cat([imu.gyr_bias_vel, imu.acc_bias_vel], dim=-1), U_A, u_w, U_B,
                      torch.cat([w_rot, w_scale[..., None]], dim=-1))


def lift_velocity_discrete(state: VIOState, imu: IMU, dt) -> VIOGroup:
    """Exact group element for one IMU step: its action on the state
    reproduces :func:`eqvio_tpu_torch.states.integrate_system`."""
    sensor = state.sensor
    gyr_est, acc_est = imu_minus_bias(imu, sensor.bias)
    dt_ = torch.as_tensor(dt, dtype=sensor.velocity.dtype, device=sensor.velocity.device)[..., None]

    beta = dt_ * torch.cat([imu.gyr_bias_vel, imu.acc_bias_vel], dim=-1)
    R = sensor.pose.R
    Rt = R.transpose(-1, -2)
    grav = _gravity_vec(sensor.velocity)
    A_R = so3_exp(dt_ * gyr_est)
    inertial_disp = dt_ * mv(R, sensor.velocity) + (0.5 * dt_ * dt_) * (mv(R, acc_est) + grav)
    A = SE3(A_R, mv(Rt, inertial_disp))
    B = se3_mul(se3_inv(sensor.camera_offset), se3_mul(A, sensor.camera_offset))
    w = -dt_ * (acc_est - sensor.gravity_dir() * GRAVITY)

    cam_change_inv = se3_mul(se3_inv(sensor.camera_offset), se3_mul(se3_inv(A), sensor.camera_offset))
    p0 = state.landmarks
    p1 = se3_apply(SE3(cam_change_inv.R[..., None, :, :], cam_change_inv.x[..., None, :]), p0)
    n0 = torch.linalg.norm(p0, dim=-1)
    n1 = torch.linalg.norm(p1, dim=-1)
    Q_R = so3_from_vectors(p1 / torch.clamp(n1, min=1e-30)[..., None],
                           p0 / torch.clamp(n0, min=1e-30)[..., None])
    Q_a = n0 / torch.clamp(n1, min=1e-30)
    return VIOGroup(beta=beta, A=A, w=w, B=B, Q=SOT3(Q_R, Q_a))


def group_element_between(xi0: VIOState, xi1: VIOState) -> VIOGroup:
    """The element L with ``phi_L(xi0) = xi1``: one exact element for a whole
    IMU window (identical to chaining per-sample discrete lifts)."""
    beta = xi1.sensor.bias - xi0.sensor.bias
    A = se3_mul(se3_inv(xi0.sensor.pose), xi1.sensor.pose)
    w = xi0.sensor.velocity - mv(A.R, xi1.sensor.velocity)
    B = se3_mul(se3_inv(xi0.sensor.camera_offset), se3_mul(A, xi1.sensor.camera_offset))
    p0, p1 = xi0.landmarks, xi1.landmarks
    n0 = torch.clamp(torch.linalg.norm(p0, dim=-1), min=1e-30)
    n1 = torch.clamp(torch.linalg.norm(p1, dim=-1), min=1e-30)
    Q_R = so3_from_vectors(p1 / n1[..., None], p0 / n0[..., None])
    return VIOGroup(beta, A, w, B, SOT3(Q_R, n0 / n1))


def group_normalize(x: VIOGroup) -> VIOGroup:
    """Project every rotation block back onto SO(3) (see ``lie.so3_project``)."""
    return VIOGroup(
        beta=x.beta,
        A=SE3(so3_project(x.A.R), x.A.x),
        w=x.w,
        B=SE3(so3_project(x.B.R), x.B.x),
        Q=SOT3(so3_project(x.Q.R), x.Q.a),
    )


def group_has_nan(x: VIOGroup) -> torch.Tensor:
    parts = (x.beta, x.A.R, x.A.x, x.w, x.B.R, x.B.x, x.Q.R, x.Q.a)
    return torch.stack([torch.isnan(p).any() for p in parts]).any()


__all__ = [
    "VIOAlgebra",
    "VIOGroup",
    "algebra_add",
    "algebra_scale",
    "algebra_sub",
    "group_element_between",
    "group_exp",
    "group_has_nan",
    "group_identity",
    "group_inv",
    "group_mul",
    "group_normalize",
    "lift_velocity",
    "lift_velocity_discrete",
    "output_action",
    "sensor_action",
    "state_action",
]
