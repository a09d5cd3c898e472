"""EqF linearisation matrices A, B, C and innovation lifts (counterpart of
``eqvio_tpu/matrices.py``), for the inverse-depth coordinate suite.

The euclid helpers below are the shared building blocks the InvDepth suite
conjugates; the Euclidean and Normal suites themselves wait for the
"other filter modes" slice (``ROADMAP.md`` queue 1), and :func:`get_suite`
raises for them.

Layout: bias 6 | pose 6 | velocity 3 | camera offset 6 | landmarks 3N.
Inactive slots have their rows and columns masked to zero.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .charts import (
    StateChart,
    euclid_invdepth_block,
    invdepth_euclid_block,
    point_chart_invdepth_inv,
    state_chart_invdepth,
)
from .group import VIOAlgebra, VIOGroup, state_action
from .lie import SOT3, cross, mv, se3_Adjoint, se3_adjoint, se3_exp, se3_inv, se3_mul, skew, so3_from_vectors
from .states import GRAVITY, IMU, SENSOR_DIM, VIOState, split_coords_vector


def _mask_f(xi0: VIOState) -> torch.Tensor:
    return xi0.mask.to(xi0.landmarks.dtype)


def _landmark_common(X: VIOGroup):
    Qhat = X.Q.R * X.Q.a[..., None, None]
    Qhat_inv = X.Q.R.transpose(-1, -2) / X.Q.a[..., None, None]
    return Qhat, Qhat_inv


def input_matrix_B_euclid(X: VIOGroup, xi0: VIOState) -> torch.Tensor:
    """Input matrix ``B [D, 12]`` in euclid landmark coordinates, masked."""
    N = xi0.capacity
    D = SENSOR_DIM + 3 * N
    dtype, device = xi0.landmarks.dtype, xi0.landmarks.device
    xi_hat = state_action(X, xi0)
    R_A = X.A.R

    B = torch.zeros(D, 12, dtype=dtype, device=device)
    B[0:6, 6:12] = torch.eye(6, dtype=dtype, device=device)
    B[6:9, 0:3] = R_A
    B[9:12, 0:3] = skew(X.A.x) @ R_A
    B[12:15, 0:3] = R_A @ skew(xi_hat.sensor.velocity)
    B[12:15, 3:6] = R_A

    Qhat, _ = _landmark_common(X)
    RT_IC = xi_hat.sensor.camera_offset.R.transpose(-1, -2)
    x_IC = xi_hat.sensor.camera_offset.x
    lm_gyr = Qhat @ (skew(xi_hat.landmarks) @ RT_IC + RT_IC @ skew(x_IC))
    lm_gyr = lm_gyr * _mask_f(xi0)[..., None, None]
    B[SENSOR_DIM:, 0:3] = lm_gyr.reshape(3 * N, 3)
    return B


def _A_sensor_and_terms(X: VIOGroup, xi0: VIOState, imu: IMU):
    xi_hat = state_action(X, xi0)
    gyr_est = imu.gyr - xi_hat.sensor.bias[..., 0:3]
    U_I = torch.cat([gyr_est, xi_hat.sensor.velocity], dim=-1)
    AdT0inv = se3_Adjoint(se3_inv(xi0.sensor.camera_offset))
    AdA = se3_Adjoint(X.A)
    ad_term = se3_adjoint(mv(AdT0inv, mv(AdA, U_I)))
    common = se3_Adjoint(se3_inv(X.B)) @ ad_term
    U_C = mv(se3_Adjoint(se3_inv(xi_hat.sensor.camera_offset)), U_I)
    return xi_hat, ad_term, common, U_C[..., 3:6]


def _A_landmark_blocks_euclid(X: VIOGroup, xi0: VIOState, xi_hat, common, v_C):
    Qhat, Qhat_inv = _landmark_common(X)
    R_IC = xi_hat.sensor.camera_offset.R
    lm_vel = -(Qhat @ R_IC.transpose(-1, -2) @ X.A.R.transpose(-1, -2))
    q0 = xi0.landmarks
    temp = torch.cat([skew(q0) @ X.Q.R, -X.Q.a[..., None, None] * X.Q.R], dim=-1)
    lm_cam = temp @ common
    qhat = xi_hat.landmarks
    qhat_sq = torch.clamp(torch.sum(qhat * qhat, dim=-1), min=1e-12)
    vC = v_C.expand_as(qhat)
    inner = (
        skew(qhat) @ skew(vC)
        - 2.0 * vC[..., :, None] * qhat[..., None, :]
        + qhat[..., :, None] * vC[..., None, :]
    )
    lm_diag = -(Qhat @ inner @ Qhat_inv) / qhat_sq[..., None, None]
    return lm_vel, lm_cam, lm_diag


def _assemble_A(xi0: VIOState, B_full, ad_term, lm_vel, lm_cam, lm_diag):
    """Scatter the blocks into the dense ``[D, D]`` matrix, masking inactive slots."""
    N = xi0.capacity
    D = SENSOR_DIM + 3 * N
    dtype, device = xi0.landmarks.dtype, xi0.landmarks.device

    A = torch.zeros(D, D, dtype=dtype, device=device)
    A[:, 0:6] = -B_full[:, 0:6]
    A[9:12, 12:15] = torch.eye(3, dtype=dtype, device=device)
    A[12:15, 6:9] = -GRAVITY * skew(xi0.sensor.gravity_dir())
    A[15:21, 15:21] = ad_term

    lm_rows = torch.zeros(N, 3, D, dtype=dtype, device=device)
    lm_rows[:, :, 0:6] = A[SENSOR_DIM:, 0:6].reshape(N, 3, 6)
    lm_rows[:, :, 12:15] = lm_vel
    lm_rows[:, :, 15:21] = lm_cam
    diag = torch.zeros(N, 3, N, 3, dtype=dtype, device=device)
    idx = torch.arange(N, device=device)
    diag[idx, :, idx, :] = lm_diag
    lm_rows[:, :, SENSOR_DIM:] = diag.reshape(N, 3, 3 * N)
    lm_rows = lm_rows * _mask_f(xi0)[:, None, None]
    A[SENSOR_DIM:, :] = lm_rows.reshape(3 * N, D)
    return A


def _DRho(y_bearing: torch.Tensor, camera) -> torch.Tensor:
    """``projJac(y) @ [skew(y) | 0]``: ``[..., 2, 4]``."""
    zero = torch.zeros(*y_bearing.shape[:-1], 3, 1, dtype=y_bearing.dtype, device=y_bearing.device)
    return camera.projection_jacobian(y_bearing) @ torch.cat([skew(y_bearing), zero], dim=-1)


def output_matrix_Ci_star_euclid(q0, Q: SOT3, camera, y_pixels) -> torch.Tensor:
    """Equivariant output matrix ``C*_i [..., 2, 3]``."""
    q_sq = torch.clamp(torch.sum(q0 * q0, dim=-1), min=1e-12)
    m2g = torch.cat([-skew(q0), -q0[..., None, :]], dim=-2) / q_sq[..., None, None]
    Qinv_R = Q.R.transpose(-1, -2)
    q_hat = mv(Qinv_R, q0) / Q.a[..., None]
    y_hat = q_hat / torch.clamp(torch.linalg.norm(q_hat, dim=-1, keepdim=True), min=1e-12)
    y_tru = camera.undistort(y_pixels)
    AdQinv = torch.zeros(*Q.R.shape[:-2], 4, 4, dtype=Q.R.dtype, device=Q.R.device)
    AdQinv[..., 0:3, 0:3] = Qinv_R
    AdQinv[..., 3, 3].fill_(1.0)
    return 0.5 * (_DRho(y_tru, camera) + _DRho(y_hat, camera)) @ AdQinv @ m2g


def output_matrix_Ci_euclid(q0, Q: SOT3, camera) -> torch.Tensor:
    """Non-equivariant ``C_i``: ``C*_i`` at the estimated output."""
    q_hat = mv(Q.R.transpose(-1, -2), q0) / Q.a[..., None]
    return output_matrix_Ci_star_euclid(q0, Q, camera, camera.project(q_hat))


def lift_innovation_euclid(Gamma: torch.Tensor, xi0: VIOState) -> VIOAlgebra:
    u_beta = Gamma[..., 0:6]
    U_A = Gamma[..., 6:12]
    u_w = -Gamma[..., 12:15] - cross(U_A[..., 0:3], xi0.sensor.velocity)
    U_B = Gamma[..., 15:21] + mv(se3_Adjoint(se3_inv(xi0.sensor.camera_offset)), U_A)
    _, gamma_q = split_coords_vector(Gamma, xi0.capacity)
    q0 = xi0.landmarks
    q_sq = torch.clamp(torch.sum(q0 * q0, dim=-1), min=1e-12)
    w_rot = -cross(q0, gamma_q) / q_sq[..., None]
    w_scale = -torch.sum(q0 * gamma_q, dim=-1) / q_sq
    return VIOAlgebra(u_beta, U_A, u_w, U_B, torch.cat([w_rot, w_scale[..., None]], dim=-1))


# ---------------------------------------------------------------------------
# Inverse-depth suite: the euclid blocks conjugated landmark-wise
# ---------------------------------------------------------------------------


def input_matrix_B_invdepth(X: VIOGroup, xi0: VIOState) -> torch.Tensor:
    B = input_matrix_B_euclid(X, xi0)
    N = xi0.capacity
    conv = invdepth_euclid_block(xi0.landmarks)
    lm = B[SENSOR_DIM:, :].reshape(N, 3, 12)
    B[SENSOR_DIM:, :] = (conv @ lm).reshape(3 * N, 12)
    return B


def state_matrix_A_invdepth(X: VIOGroup, xi0: VIOState, imu: IMU) -> torch.Tensor:
    B_full = input_matrix_B_invdepth(X, xi0)
    xi_hat, ad_term, common, v_C = _A_sensor_and_terms(X, xi0, imu)
    lm_vel, lm_cam, lm_diag = _A_landmark_blocks_euclid(X, xi0, xi_hat, common, v_C)
    e2i = invdepth_euclid_block(xi0.landmarks)
    i2e = euclid_invdepth_block(xi0.landmarks)
    return _assemble_A(xi0, B_full, ad_term, e2i @ lm_vel, e2i @ lm_cam, e2i @ lm_diag @ i2e)


def output_matrix_Ci_star_invdepth(q0, Q, camera, y_pixels) -> torch.Tensor:
    return output_matrix_Ci_star_euclid(q0, Q, camera, y_pixels) @ euclid_invdepth_block(q0)


def output_matrix_Ci_invdepth(q0, Q, camera) -> torch.Tensor:
    return output_matrix_Ci_euclid(q0, Q, camera) @ euclid_invdepth_block(q0)


def lift_innovation_invdepth(Gamma: torch.Tensor, xi0: VIOState) -> VIOAlgebra:
    eps_sensor, gamma_ind = split_coords_vector(Gamma, xi0.capacity)
    gamma_euc = mv(euclid_invdepth_block(xi0.landmarks), gamma_ind)
    Gamma_euc = torch.cat([eps_sensor, gamma_euc.reshape(*gamma_euc.shape[:-2], -1)], dim=-1)
    return lift_innovation_euclid(Gamma_euc, xi0)


def lift_innovation_discrete_invdepth(Gamma: torch.Tensor, xi0: VIOState) -> VIOGroup:
    beta = Gamma[..., 0:6]
    A = se3_exp(Gamma[..., 6:12])
    w = xi0.sensor.velocity - mv(A.R, xi0.sensor.velocity + Gamma[..., 12:15])
    T0 = xi0.sensor.camera_offset
    B = se3_mul(se3_inv(T0), se3_mul(A, se3_mul(T0, se3_exp(Gamma[..., 15:21]))))
    _, gamma_q = split_coords_vector(Gamma, xi0.capacity)
    q0 = xi0.landmarks
    q1 = point_chart_invdepth_inv(gamma_q, q0)
    n0 = torch.clamp(torch.linalg.norm(q0, dim=-1), min=1e-12)
    n1 = torch.clamp(torch.linalg.norm(q1, dim=-1), min=1e-12)
    Q_R = so3_from_vectors(q1 / n1[..., None], q0 / n0[..., None])
    return VIOGroup(beta, A, w, B, SOT3(Q_R, n0 / n1))


class CoordinateSuite(NamedTuple):
    name: str
    chart: StateChart
    state_matrix_A: Callable  # (X, xi0, imu) -> [D, D]
    input_matrix_B: Callable  # (X, xi0) -> [D, 12]
    output_Ci_star: Callable  # (q0, Q, camera, y_px) -> [..., 2, 3]
    output_Ci: Callable  # (q0, Q, camera) -> [..., 2, 3]
    lift_innovation: Callable  # (Gamma, xi0) -> VIOAlgebra
    lift_innovation_discrete: Callable  # (Gamma, xi0) -> VIOGroup


SUITES = {
    "invdepth": CoordinateSuite(
        "invdepth",
        state_chart_invdepth,
        state_matrix_A_invdepth,
        input_matrix_B_invdepth,
        output_matrix_Ci_star_invdepth,
        output_matrix_Ci_invdepth,
        lift_innovation_invdepth,
        lift_innovation_discrete_invdepth,
    ),
}


def get_suite(name: str) -> CoordinateSuite:
    """Map a config coordinate choice onto its suite."""
    alias = {"euclidean": "euclid", "invdepth": "invdepth", "normal": "normal"}
    key = alias.get(name.lower(), name.lower())
    if key not in SUITES:
        raise NotImplementedError(
            f"coordinate suite {key!r} is not ported yet (ROADMAP.md queue 1, "
            "'other filter modes': the Euclidean and Normal suites); use InvDepth"
        )
    return SUITES[key]
