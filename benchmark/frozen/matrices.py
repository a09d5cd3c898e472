"""EqF linearisation matrices A, B, C and innovation lifts (counterpart of
``eqvio_tpu/matrices.py``) for the Euclidean, inverse-depth and normal
coordinate suites, and the discrete state matrix of any suite.

The InvDepth and Normal suites conjugate the Euclidean blocks landmark by
landmark; the Normal suite's 21x21 sensor transition and the discrete state
matrix are exact forward-mode derivatives (``torch.func.jacfwd``).

Layout: bias 6 | pose 6 | velocity 3 | camera offset 6 | landmarks 3N.
Inactive slots have their rows and columns masked to zero.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .charts import (
    STATE_CHARTS,
    StateChart,
    euclid_invdepth_block,
    invdepth_euclid_block,
    point_chart_invdepth_inv,
    sensor_chart_normal,
    sensor_chart_normal_inv,
    sensor_chart_std,
    sensor_chart_std_inv,
    sphere_chart_normal,
)
from .group import VIOAlgebra, VIOGroup, group_inv, group_mul, lift_velocity_discrete, state_action
from .lie import SOT3, cross, jacfwd, mv, se3_Adjoint, se3_adjoint, se3_exp, se3_inv, se3_mul, skew, so3_from_vectors
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

    B = R_A.new_zeros(D, 12)  # from a state tensor, so a vmap over lanes batches it
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

    A = B_full.new_zeros(D, D)
    A[:, 0:6] = -B_full[:, 0:6]
    A[9:12, 12:15] = torch.eye(3, dtype=dtype, device=device)
    A[12:15, 6:9] = -GRAVITY * skew(xi0.sensor.gravity_dir())
    A[15:21, 15:21] = ad_term

    lm_rows = lm_vel.new_zeros(N, 3, D)
    lm_rows[:, :, 0:6] = A[SENSOR_DIM:, 0:6].reshape(N, 3, 6)
    lm_rows[:, :, 12:15] = lm_vel
    lm_rows[:, :, 15:21] = lm_cam
    same_slot = torch.eye(N, dtype=torch.bool, device=device)
    diag = torch.where(same_slot[:, None, :, None], lm_diag[:, :, None, :], 0.0)  # block diagonal
    lm_rows[:, :, SENSOR_DIM:] = diag.reshape(N, 3, 3 * N)
    lm_rows = lm_rows * _mask_f(xi0)[:, None, None]
    A[SENSOR_DIM:, :] = lm_rows.reshape(3 * N, D)
    return A


def state_matrix_A_euclid(X: VIOGroup, xi0: VIOState, imu: IMU) -> torch.Tensor:
    """State matrix ``A0_t [D, D]`` in euclid landmark coordinates."""
    B_full = input_matrix_B_euclid(X, xi0)
    xi_hat, ad_term, common, v_C = _A_sensor_and_terms(X, xi0, imu)
    lm_vel, lm_cam, lm_diag = _A_landmark_blocks_euclid(X, xi0, xi_hat, common, v_C)
    return _assemble_A(xi0, B_full, ad_term, lm_vel, lm_cam, lm_diag)


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
    AdQinv = Q.R.new_zeros(*Q.R.shape[:-2], 4, 4)
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


def _lift_discrete_sensor(Gamma: torch.Tensor, xi0: VIOState):
    beta = Gamma[..., 0:6]
    A = se3_exp(Gamma[..., 6:12])
    w = xi0.sensor.velocity - mv(A.R, xi0.sensor.velocity + Gamma[..., 12:15])
    T0 = xi0.sensor.camera_offset
    B = se3_mul(se3_inv(T0), se3_mul(A, se3_mul(T0, se3_exp(Gamma[..., 15:21]))))
    return beta, A, w, B


def _landmark_sot3(q0: torch.Tensor, q1: torch.Tensor) -> SOT3:
    """The SOT(3) element taking ``q1`` to ``q0``: rotation of the
    directions and the ratio of the norms."""
    n0 = torch.clamp(torch.linalg.norm(q0, dim=-1), min=1e-12)
    n1 = torch.clamp(torch.linalg.norm(q1, dim=-1), min=1e-12)
    return SOT3(so3_from_vectors(q1 / n1[..., None], q0 / n0[..., None]), n0 / n1)


def lift_innovation_discrete_euclid(Gamma: torch.Tensor, xi0: VIOState) -> VIOGroup:
    beta, A, w, B = _lift_discrete_sensor(Gamma, xi0)
    _, gamma_q = split_coords_vector(Gamma, xi0.capacity)
    return VIOGroup(beta, A, w, B, _landmark_sot3(xi0.landmarks, xi0.landmarks + gamma_q))


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
    beta, A, w, B = _lift_discrete_sensor(Gamma, xi0)
    _, gamma_q = split_coords_vector(Gamma, xi0.capacity)
    q0 = xi0.landmarks
    return VIOGroup(beta, A, w, B, _landmark_sot3(q0, point_chart_invdepth_inv(gamma_q, q0)))


# ---------------------------------------------------------------------------
# Normal suite: the euclid blocks conjugated by the chart transition, whose
# sensor block is a forward-mode derivative and landmark blocks analytic
# ---------------------------------------------------------------------------


def _jacobian_at_zero(fn, n: int, like: torch.Tensor, *args) -> torch.Tensor:
    """``d fn(eps, *args) / d eps`` at ``eps = 0 [n]`` in ``like``'s dtype
    (:func:`lie.jacfwd`: ``fn`` sees ``eps`` as ``[1, n]``)."""
    zero = torch.zeros(n, dtype=like.dtype, device=like.device)
    return jacfwd(lambda e: fn(e, *args), zero)


def normal_euclid_sensor_differential(xi0: VIOState) -> torch.Tensor:
    """Sensor block ``[21, 21]`` of d(normal o euclid^-1) at 0, by forward AD
    (the transition is block diagonal: the sensor charts touch only sensor
    components, the landmark charts act slot by slot)."""
    return _jacobian_at_zero(lambda e, s0: sensor_chart_normal(sensor_chart_std_inv(e, s0), s0),
                             SENSOR_DIM, xi0.landmarks, xi0.sensor)


def euclid_normal_sensor_differential(xi0: VIOState) -> torch.Tensor:
    """The inverse transition's sensor block, d(euclid o normal^-1) at 0."""
    return _jacobian_at_zero(lambda e, s0: sensor_chart_std(sensor_chart_normal_inv(e, s0), s0),
                             SENSOR_DIM, xi0.landmarks, xi0.sensor)


def normal_euclid_point_blocks(p0: torch.Tensor) -> torch.Tensor:
    """Per-landmark ``[N, 3, 3]`` blocks of d(normal o euclid^-1) at 0: the
    sphere chart's differential of the bearing, then d log(rho) / d p."""
    r0 = torch.clamp(torch.linalg.norm(p0, dim=-1), min=1e-12)
    y0 = p0 / r0[..., None]
    eye = torch.eye(3, dtype=p0.dtype, device=p0.device)
    P = (eye - y0[..., :, None] * y0[..., None, :]) / r0[..., None, None]
    top = sphere_chart_normal.chart_diff0(y0) @ P
    return torch.cat([top, -(y0 / r0[..., None])[..., None, :]], dim=-2)


def normal_euclid_differential(xi0: VIOState) -> torch.Tensor:
    """d(normal o euclid^-1) at 0 as a dense ``[D, D]`` matrix, assembled
    from the sensor block and the per-landmark blocks (the suite itself
    works block-wise)."""
    N, D = xi0.capacity, xi0.dim()
    M = xi0.landmarks.new_zeros(D, D)
    M[:SENSOR_DIM, :SENSOR_DIM] = normal_euclid_sensor_differential(xi0)
    M[SENSOR_DIM:, SENSOR_DIM:] = torch.block_diag(*normal_euclid_point_blocks(xi0.landmarks).unbind(0))
    return M


def euclid_normal_point_blocks(p0: torch.Tensor) -> torch.Tensor:
    """Per-landmark inverse blocks ``[N, 3, 3]``, analytic."""
    r0 = torch.clamp(torch.linalg.norm(p0, dim=-1), min=1e-12)
    y0 = p0 / r0[..., None]
    left = r0[..., None, None] * sphere_chart_normal.chart_inv_diff0(y0)
    return torch.cat([left, -p0[..., None]], dim=-1)


def _conjugate_rows(M_s: torch.Tensor, M_p: torch.Tensor, rows: torch.Tensor, N: int) -> torch.Tensor:
    """``blockdiag(M_s, M_p[i]) @ rows`` for ``rows [D, k]``."""
    k = rows.shape[-1]
    rest = torch.einsum("nij,njk->nik", M_p, rows[SENSOR_DIM:].reshape(N, 3, k)).reshape(3 * N, k)
    return torch.cat([M_s @ rows[:SENSOR_DIM], rest], dim=0)


def state_matrix_A_normal(X: VIOGroup, xi0: VIOState, imu: IMU) -> torch.Tensor:
    """``M A_euclid M^-1``, block by block, with the analytic inverse blocks."""
    N = xi0.capacity
    A1 = _conjugate_rows(normal_euclid_sensor_differential(xi0), normal_euclid_point_blocks(xi0.landmarks),
                         state_matrix_A_euclid(X, xi0, imu), N)
    D = A1.shape[-1]
    left = A1[:, :SENSOR_DIM] @ euclid_normal_sensor_differential(xi0)
    right = torch.einsum("dni,nij->dnj", A1[:, SENSOR_DIM:].reshape(D, N, 3),
                         euclid_normal_point_blocks(xi0.landmarks)).reshape(D, 3 * N)
    return torch.cat([left, right], dim=1)


def input_matrix_B_normal(X: VIOGroup, xi0: VIOState) -> torch.Tensor:
    return _conjugate_rows(normal_euclid_sensor_differential(xi0), normal_euclid_point_blocks(xi0.landmarks),
                           input_matrix_B_euclid(X, xi0), xi0.capacity)


def output_matrix_Ci_star_normal(q0, Q: SOT3, camera, y_pixels) -> torch.Tensor:
    """Analytic sphere-chart ``C*_i`` (the measured pixels do not enter)."""
    y0 = q0 / torch.clamp(torch.linalg.norm(q0, dim=-1, keepdim=True), min=1e-12)
    Qinv_R = Q.R.transpose(-1, -2)
    block = camera.projection_jacobian(mv(Qinv_R, y0)) @ Qinv_R @ sphere_chart_normal.chart_inv_diff0(q0)
    return torch.cat([block, torch.zeros_like(block[..., :1])], dim=-1)


def output_matrix_Ci_normal(q0, Q: SOT3, camera) -> torch.Tensor:
    return output_matrix_Ci_star_normal(q0, Q, camera, None)


def lift_innovation_normal(Gamma: torch.Tensor, xi0: VIOState) -> VIOAlgebra:
    eps_sensor, gamma_p = split_coords_vector(Gamma, xi0.capacity)
    s = mv(euclid_normal_sensor_differential(xi0), eps_sensor)
    p = mv(euclid_normal_point_blocks(xi0.landmarks), gamma_p)
    return lift_innovation_euclid(torch.cat([s, p.reshape(*p.shape[:-2], -1)], dim=-1), xi0)


def lift_innovation_discrete_normal(Gamma: torch.Tensor, xi0: VIOState) -> VIOGroup:
    Gamma_euc = STATE_CHARTS["euclid"].chart(STATE_CHARTS["normal"].chart_inv(Gamma, xi0), xi0)
    return lift_innovation_discrete_euclid(Gamma_euc, xi0)


# ---------------------------------------------------------------------------
# Discrete state matrix of any suite: the exact derivative of the lift's
# conjugated action in the suite's chart
# ---------------------------------------------------------------------------


def state_matrix_A_discrete(suite: "CoordinateSuite", X: VIOGroup, xi0: VIOState, imu: IMU, dt) -> torch.Tensor:
    """``[D, D]`` by ``torch.func.jacfwd`` over the full chart (see
    :func:`_jacobian_at_zero`), inactive landmark rows and columns masked to
    zero."""
    chart = suite.chart

    def step(eps, X, xi0, imu, dt):
        xi_e = chart.chart_inv(eps, xi0)
        lift_hat_inv = group_inv(lift_velocity_discrete(state_action(X, xi0), imu, dt))
        lam = group_mul(lift_velocity_discrete(state_action(X, xi_e), imu, dt), lift_hat_inv)
        return chart.chart(state_action(group_mul(group_mul(X, lam), group_inv(X)), xi_e), xi0)

    dt = torch.as_tensor(dt, dtype=xi0.landmarks.dtype, device=xi0.landmarks.device)
    A = _jacobian_at_zero(step, xi0.dim(), xi0.landmarks, X, xi0, imu, dt)
    mask_vec = torch.cat([torch.ones(SENSOR_DIM, dtype=A.dtype, device=A.device),
                          _mask_f(xi0).repeat_interleave(3)])
    return A * mask_vec[:, None] * mask_vec[None, :]


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
    "euclid": CoordinateSuite(
        "euclid",
        STATE_CHARTS["euclid"],
        state_matrix_A_euclid,
        input_matrix_B_euclid,
        output_matrix_Ci_star_euclid,
        output_matrix_Ci_euclid,
        lift_innovation_euclid,
        lift_innovation_discrete_euclid,
    ),
    "invdepth": CoordinateSuite(
        "invdepth",
        STATE_CHARTS["invdepth"],
        state_matrix_A_invdepth,
        input_matrix_B_invdepth,
        output_matrix_Ci_star_invdepth,
        output_matrix_Ci_invdepth,
        lift_innovation_invdepth,
        lift_innovation_discrete_invdepth,
    ),
    "normal": CoordinateSuite(
        "normal",
        STATE_CHARTS["normal"],
        state_matrix_A_normal,
        input_matrix_B_normal,
        output_matrix_Ci_star_normal,
        output_matrix_Ci_normal,
        lift_innovation_normal,
        lift_innovation_discrete_normal,
    ),
}


def get_suite(name: str) -> CoordinateSuite:
    """Map a config coordinate choice (Euclidean, InvDepth, Normal) onto its suite."""
    alias = {"euclidean": "euclid", "invdepth": "invdepth", "normal": "normal"}
    return SUITES[alias.get(name.lower(), name.lower())]
