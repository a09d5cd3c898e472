"""The EqF filter core (counterpart of ``eqvio_tpu/filter.py``): settings,
propagation (fast Euler, accurate matrix-exponential and discrete Riccati
steps; fused discrete or per-sample continuous velocity lifts), the vision
update with the landmark-lifecycle surgery folded in, and health checks.

Covariance is dense or square-root (``Settings.sqrt_covariance``).  In
square-root mode ``EqFState.Sigma`` holds a lower factor L with
Sigma = L L^T, maintained by QR re-triangularisation, and with fast Riccati
``propagate_window(wide_factor=True)`` hands the un-triangularised Riccati
stack to the update's pre-array so a frame costs ONE QR.  Every step reads
no host value, so a CUDA graph captures it: the matrix exponential picks its
Pade degree and squaring count on the device (:func:`expm`) and the dense
update factors with ``cholesky_ex``.

Slot protocol: tracker and filter share slot indices; a slot reused under a
different id is lost + new.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from .group import (
    VIOGroup,
    algebra_scale,
    group_element_between,
    group_exp,
    group_has_nan,
    group_identity,
    group_inv,
    group_mul,
    group_normalize,
    lift_velocity,
    lift_velocity_discrete,
    state_action,
)
from .lie import SE3, so3_from_vectors
from .matrices import CoordinateSuite, get_suite, state_matrix_A_discrete
from .runtime import const
from .stamps import LIFECYCLE_END, stamp
from .states import DUMMY_POINT, IMU, SENSOR_DIM, VIOState, integrate_system, measure_system, state_identity


@dataclasses.dataclass(frozen=True)
class Settings:
    """EqF settings; field names and defaults match ``eqvio_tpu.filter.Settings``."""

    bias_omega_process_var: float = 0.001
    bias_accel_process_var: float = 0.001
    attitude_process_var: float = 0.001
    position_process_var: float = 0.001
    velocity_process_var: float = 0.001
    camera_attitude_process_var: float = 0.001
    camera_position_process_var: float = 0.001
    point_process_var: float = 0.001

    vel_gyr_noise: float = 1e-4
    vel_acc_noise: float = 1e-3
    vel_gyr_bias_walk: float = 1e-5
    vel_acc_bias_walk: float = 1e-3

    measurement_noise: float = 2.0
    outlier_threshold_abs: float = 1e8
    outlier_threshold_prob: float = 1e8
    feature_retention: float = 0.3

    initial_attitude_var: float = 1e-4
    initial_position_var: float = 1e-4
    initial_velocity_var: float = 1e-2
    initial_camera_attitude_var: float = 1e-5
    initial_camera_position_var: float = 1e-4
    initial_point_var: float = 1.0
    initial_point_depth_var: float = -1.0
    initial_bias_omega_var: float = 0.1
    initial_bias_accel_var: float = 0.1
    initial_scene_depth: float = 1.0

    use_discrete_innovation_lift: bool = True
    use_discrete_velocity_lift: bool = True
    use_discrete_state_matrix: bool = False
    use_accurate_riccati: bool = False
    fast_riccati: bool = False
    use_median_depth: bool = True
    use_feature_predictions: bool = False
    use_equivariant_output: bool = True
    remove_lost_landmarks: bool = True
    coordinate_choice: str = "euclid"
    sqrt_covariance: bool = False

    camera_offset_quat: tuple = (1.0, 0.0, 0.0, 0.0)  # (w, x, y, z)
    camera_offset_pos: tuple = (0.0, 0.0, 0.0)

    @property
    def suite(self) -> CoordinateSuite:
        return get_suite(self.coordinate_choice)

    def camera_offset_se3(self, dtype: torch.dtype, device) -> SE3:
        w, x, y, z = self.camera_offset_quat
        n = (w * w + x * x + y * y + z * z) ** 0.5
        w, x, y, z = w / n, x / n, y / n, z / n
        R = torch.tensor(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ],
            dtype=dtype,
            device=device,
        )
        return SE3(R, torch.tensor(self.camera_offset_pos, dtype=dtype, device=device))

    def initial_sensor_cov_diag(self, dtype: torch.dtype, device) -> torch.Tensor:
        vals = (
            [self.initial_bias_omega_var] * 3
            + [self.initial_bias_accel_var] * 3
            + [self.initial_attitude_var] * 3
            + [self.initial_position_var] * 3
            + [self.initial_velocity_var] * 3
            + [self.initial_camera_attitude_var] * 3
            + [self.initial_camera_position_var] * 3
        )
        return const(tuple(vals), dtype, device)

    def initial_point_cov_diag(self, dtype: torch.dtype, device) -> torch.Tensor:
        d = [self.initial_point_var] * 3
        if self.initial_point_depth_var > 0:
            d[2] = self.initial_point_depth_var
        return const(tuple(d), dtype, device)

    def state_gain_diag(self, capacity: int, dtype: torch.dtype, device) -> torch.Tensor:
        vals = (
            [self.bias_omega_process_var] * 3
            + [self.bias_accel_process_var] * 3
            + [self.attitude_process_var] * 3
            + [self.position_process_var] * 3
            + [self.velocity_process_var] * 3
            + [self.camera_attitude_process_var] * 3
            + [self.camera_position_process_var] * 3
            + [self.point_process_var] * 3 * capacity
        )
        return const(tuple(vals), dtype, device)

    def input_gain_diag(self, dtype: torch.dtype, device) -> torch.Tensor:
        vals = (
            [self.vel_gyr_noise**2] * 3
            + [self.vel_acc_noise**2] * 3
            + [self.vel_gyr_bias_walk**2] * 3
            + [self.vel_acc_bias_walk**2] * 3
        )
        return const(tuple(vals), dtype, device)


class EqFState(NamedTuple):
    xi0: VIOState  # fixed origin configuration
    X: VIOGroup  # observer group element
    Sigma: torch.Tensor  # [D, D] covariance, or its lower factor (the wide stack [D, W] mid-frame)
    t: torch.Tensor  # filter time, 0-dim


def _mask_vec(xi0: VIOState) -> torch.Tensor:
    """[D]: 1 on sensor and active landmark coordinates, 0 on inactive slots."""
    lm = xi0.mask.to(xi0.landmarks.dtype).repeat_interleave(3)
    return torch.cat([torch.ones(SENSOR_DIM, dtype=lm.dtype, device=lm.device), lm])


def tria(M: torch.Tensor) -> torch.Tensor:
    """Lower-triangularise: L with ``L L^T = M M^T`` and a nonnegative diagonal.

    One QR of ``M^T``; the diagonal sign normalisation makes the factor
    unique, so it does not depend on the QR library's sign convention.
    """
    R = torch.linalg.qr(M.T, mode="r").R
    L = R.T
    sign = torch.sign(torch.diagonal(L))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return L * sign[None, :]


def _sqrt_mask_reset(L: torch.Tensor, keep_vec: torch.Tensor, add_diag: torch.Tensor) -> torch.Tensor:
    """Factor of ``diag(keep) (L L^T) diag(keep) + diag(add_diag)``."""
    return tria(torch.cat([L * keep_vec[:, None], torch.diag(torch.sqrt(add_diag))], dim=1))


def _mask_outer(xi0: VIOState) -> torch.Tensor:
    mv_ = _mask_vec(xi0)
    return mv_[:, None] * mv_[None, :]


def _dense_mask_reset(Sigma: torch.Tensor, keep_vec: torch.Tensor, add_diag: torch.Tensor) -> torch.Tensor:
    """``diag(keep) Sigma diag(keep) + diag(add_diag)``."""
    return Sigma * keep_vec[:, None] * keep_vec[None, :] + torch.diag(add_diag)


def _mask_reset(Sigma, keep_vec, add_diag, settings: Settings) -> torch.Tensor:
    """The covariance surgery in the state's form (factor or dense)."""
    if settings.sqrt_covariance:
        return _sqrt_mask_reset(Sigma, keep_vec, add_diag)
    return _dense_mask_reset(Sigma, keep_vec, add_diag)


def sanitize_sigma(Sigma: torch.Tensor, xi0: VIOState, settings: Settings) -> torch.Tensor:
    """Zero inactive rows/cols and reset their diagonal to the initial point variance."""
    mv_ = _mask_vec(xi0)
    return _mask_reset(Sigma, mv_, (1.0 - mv_) * settings.initial_point_var, settings)


def dense_sigma(state: EqFState, settings: Settings) -> torch.Tensor:
    """The covariance as a dense matrix in either mode."""
    return state.Sigma @ state.Sigma.T if settings.sqrt_covariance else state.Sigma


def init_state(settings: Settings, capacity: int, dtype: torch.dtype, device) -> EqFState:
    xi0 = state_identity(capacity, dtype, device)
    xi0 = xi0._replace(
        sensor=xi0.sensor._replace(camera_offset=settings.camera_offset_se3(dtype, device))
    )
    diag = torch.cat(
        [
            settings.initial_sensor_cov_diag(dtype, device),
            settings.initial_point_cov_diag(dtype, device).repeat(capacity),
        ]
    )
    return EqFState(
        xi0=xi0,
        X=group_identity(capacity, dtype, device),
        Sigma=torch.diag(torch.sqrt(diag) if settings.sqrt_covariance else diag),
        t=torch.tensor(-1.0, dtype=dtype, device=device),
    )


def initialize_attitude_from_imu(state: EqFState, imu: IMU) -> EqFState:
    """Gravity-aligned attitude initialisation from one IMU sample."""
    acc_dir = imu.acc / torch.clamp(torch.linalg.norm(imu.acc, dim=-1, keepdim=True), min=1e-9)
    e3 = torch.zeros_like(acc_dir)
    e3[..., 2].fill_(1.0)
    R0 = so3_from_vectors(acc_dir, e3)
    xi0 = state.xi0._replace(
        sensor=state.xi0.sensor._replace(pose=SE3(R0, state.xi0.sensor.pose.x))
    )
    return state._replace(xi0=xi0, t=imu.stamp.to(state.t.dtype))


def state_estimate(state: EqFState) -> VIOState:
    """phi_X(xi0)."""
    return state_action(state.X, state.xi0)


# ---------------------------------------------------------------------------
# Propagation
# ---------------------------------------------------------------------------


def _sqrt_riccati_stack(state: EqFState, A_exp, noise_cols, dt, settings: Settings) -> torch.Tensor:
    """Wide factor S with ``S S^T = mask (A Sigma A^T + N N^T + dt P) mask + pad``
    for the input-noise columns ``N = noise_cols``.

    Width ``Wc + 12 + D``; the process-noise and pad diagonals share one
    block because their masks are disjoint.
    """
    dtype, device = state.Sigma.dtype, state.Sigma.device
    dt_pos = torch.clamp(torch.as_tensor(dt, dtype=dtype, device=device), min=0.0)
    mv_ = _mask_vec(state.xi0)
    p_diag = settings.state_gain_diag(state.xi0.capacity, dtype, device) * mv_
    pad = (1.0 - mv_) * settings.initial_point_var
    return torch.cat(
        [
            (A_exp @ state.Sigma) * mv_[:, None],
            noise_cols * mv_[:, None],
            torch.diag(torch.sqrt(dt_pos * p_diag + pad)),
        ],
        dim=1,
    )


def _euler_noise_cols(Bt, dt, settings: Settings) -> torch.Tensor:
    """``sqrt(dt) B q^1/2``: the input-noise columns of an Euler step."""
    dt_pos = torch.clamp(torch.as_tensor(dt, dtype=Bt.dtype, device=Bt.device), min=0.0)
    return torch.sqrt(dt_pos) * (Bt * torch.sqrt(settings.input_gain_diag(Bt.dtype, Bt.device))[None, :])


def _dense_riccati(state: EqFState, A_exp, Bt, dt, settings: Settings) -> torch.Tensor:
    """``A Sigma A^T + dt (B q B^T + P)``, symmetrised and sanitized."""
    dtype, device = state.Sigma.dtype, state.Sigma.device
    Q_in = (Bt * settings.input_gain_diag(dtype, device)[None, :]) @ Bt.T
    P = torch.diag(settings.state_gain_diag(state.xi0.capacity, dtype, device)) * _mask_outer(state.xi0)
    Sigma = A_exp @ state.Sigma @ A_exp.T + dt * (Q_in + P)
    return sanitize_sigma(0.5 * (Sigma + Sigma.T), state.xi0, settings)


def _sqrt_step(state: EqFState, A_exp, noise_cols, dt, settings: Settings) -> EqFState:
    """One QR of the stack; zero-dt steps are exact no-ops and keep the factor."""
    dt_t = torch.as_tensor(dt, dtype=state.Sigma.dtype, device=state.Sigma.device)
    stack = _sqrt_riccati_stack(state, A_exp, noise_cols, dt, settings)
    return state._replace(Sigma=torch.where(dt_t > 0, tria(stack), state.Sigma))


def integrate_riccati_fast(
    state: EqFState, imu: IMU, dt, settings: Settings, suite: CoordinateSuite, wide: bool = False
) -> EqFState:
    """Euler Riccati step.

    ``wide=True`` (square-root mode) stores the un-triangularised stack in
    ``Sigma`` (exact: only the factor's Gram matters); the frame's update QR
    squares it again.
    """
    D = state.xi0.dim()
    dtype, device = state.Sigma.dtype, state.Sigma.device
    A0t = suite.state_matrix_A(state.X, state.xi0, imu)
    Bt = suite.input_matrix_B(state.X, state.xi0)
    A_exp = torch.eye(D, dtype=dtype, device=device) + dt * A0t
    if not settings.sqrt_covariance:
        return state._replace(Sigma=_dense_riccati(state, A_exp, Bt, dt, settings))
    noise_cols = _euler_noise_cols(Bt, dt, settings)
    if wide:
        return state._replace(Sigma=_sqrt_riccati_stack(state, A_exp, noise_cols, dt, settings))
    return _sqrt_step(state, A_exp, noise_cols, dt, settings)


# jax.scipy.linalg.expm's Pade coefficients and degree thresholds
_PADE_B = {
    3: (120., 60., 12., 1.),
    5: (30240., 15120., 3360., 420., 30., 1.),
    7: (17297280., 8648640., 1995840., 277200., 25200., 1512., 56., 1.),
    9: (17643225600., 8821612800., 2075673600., 302702400., 30270240., 2162160., 110880., 3960., 90., 1.),
    13: (64764752532480000., 32382376266240000., 7771770303897600., 1187353796428800., 129060195264000.,
         10559470521600., 670442572800., 33522128640., 1323241920., 40840800., 960960., 16380., 182., 1.),
}
_EXPM = {  # dtype -> (max norm before squaring, degrees, norm thresholds between degrees)
    torch.float64: (5.371920351148152, (3, 5, 7, 9, 13),
                    (1.495585217958292e-002, 2.539398330063230e-001, 9.504178996162932e-001,
                     2.097847961257068e+000)),
    torch.float32: (3.925724783138660, (3, 5, 7), (4.258730016922831e-001, 1.880152677804762e+000)),
}
EXPM_MAX_SQUARINGS = 16


def _pade(m: int, A, powers, ident):
    """``(U, V)`` of the degree-``m`` Pade approximant, from the shared powers
    ``A^2, A^4, A^6, A^8``, in ``jax.scipy.linalg.expm``'s operation order."""
    b = _PADE_B[m]
    A2, A4, A6, A8 = powers
    if m == 13:
        U = A @ (A6 @ (b[13] * A6 + b[11] * A4 + b[9] * A2) + b[7] * A6 + b[5] * A4 + b[3] * A2 + b[1] * ident)
        V = A6 @ (b[12] * A6 + b[10] * A4 + b[8] * A2) + b[6] * A6 + b[4] * A4 + b[2] * A2 + b[0] * ident
        return U, V
    evens = [ident, A2, A4, A6, A8][: (m + 1) // 2]
    u_sum = b[m] * evens[-1]
    v_sum = b[m - 1] * evens[-1]
    for k in range(len(evens) - 2, 0, -1):
        u_sum = u_sum + b[2 * k + 1] * evens[k]
        v_sum = v_sum + b[2 * k] * evens[k]
    return A @ (u_sum + b[1] * ident), v_sum + b[0] * ident


def expm(A: torch.Tensor) -> torch.Tensor:
    """Matrix exponential of ``A [n, n]`` by scaling and squaring, as
    ``jax.scipy.linalg.expm`` computes it, with every choice made on the
    device: all Pade degrees are formed and one is selected by the L1 norm,
    then 16 squarings run masked by the squaring count (NaN beyond 16).  No
    host read, so a CUDA graph captures it."""
    maxnorm, degrees, conds = _EXPM[A.dtype]
    norm = torch.linalg.matrix_norm(A, ord=1)
    n_sq = torch.clamp(torch.floor(torch.log2(norm / maxnorm)), min=0.0)
    A = A / torch.pow(2.0, n_sq)
    idx = torch.sum(norm >= const(conds, A.dtype, A.device))
    ident = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    A2 = A @ A
    A4 = A2 @ A2
    A6 = A4 @ A2 if degrees[-1] > 5 else None
    A8 = A6 @ A2 if 9 in degrees else None
    P = Q = None
    for k, m in enumerate(degrees):
        U, V = _pade(m, A, (A2, A4, A6, A8), ident)
        take = idx == k
        P = U + V if P is None else torch.where(take, U + V, P)
        Q = V - U if Q is None else torch.where(take, V - U, Q)
    R = torch.linalg.solve_ex(Q, P)[0]
    for i in range(EXPM_MAX_SQUARINGS):
        R = torch.where(n_sq > i, R @ R, R)
    return torch.where(n_sq > EXPM_MAX_SQUARINGS, torch.full_like(R, float("nan")), R)


def integrate_riccati_accurate(
    state: EqFState, imu: IMU, dt, settings: Settings, suite: CoordinateSuite
) -> EqFState:
    """Matrix-exponential Riccati step: expm of the stacked ``[[A, B], [0, 0]]``
    system; zero-dt steps compute with dt = 1 and keep the incoming Sigma."""
    D = state.xi0.dim()
    dtype, device = state.Sigma.dtype, state.Sigma.device
    dt = torch.as_tensor(dt, dtype=dtype, device=device)
    dt_safe = torch.where(dt > 0, dt, torch.ones_like(dt))
    AB = state.Sigma.new_zeros(D + 12, D + 12)
    AB[:D, :D] = suite.state_matrix_A(state.X, state.xi0, imu)
    AB[:D, D:] = suite.input_matrix_B(state.X, state.xi0)
    ABexp = expm(dt_safe * AB)
    A_exp, B_exp = ABexp[:D, :D], ABexp[:D, D:]
    if settings.sqrt_covariance:
        # Q_in = B_exp diag(q / dt) B_exp^T and P at dt; the one QR also sanitizes
        noise_cols = B_exp * torch.sqrt(settings.input_gain_diag(dtype, device) / dt_safe)[None, :]
        stack = _sqrt_riccati_stack(state, A_exp, noise_cols, dt_safe, settings)
        return state._replace(Sigma=torch.where(dt > 0, tria(stack), state.Sigma))
    Q_in = (B_exp * (settings.input_gain_diag(dtype, device) / dt_safe)[None, :]) @ B_exp.T
    P = torch.diag(settings.state_gain_diag(state.xi0.capacity, dtype, device)) * _mask_outer(state.xi0)
    Sigma = A_exp @ state.Sigma @ A_exp.T + Q_in + dt_safe * P
    Sigma = torch.where(dt > 0, 0.5 * (Sigma + Sigma.T), state.Sigma)
    return state._replace(Sigma=sanitize_sigma(Sigma, state.xi0, settings))


def integrate_riccati_discrete(
    state: EqFState, imu: IMU, dt, settings: Settings, suite: CoordinateSuite
) -> EqFState:
    """Riccati step with the discrete transition of the lift
    (:func:`matrices.state_matrix_A_discrete`)."""
    A_d = state_matrix_A_discrete(suite, state.X, state.xi0, imu, dt)
    Bt = suite.input_matrix_B(state.X, state.xi0)
    if settings.sqrt_covariance:
        return _sqrt_step(state, A_d, _euler_noise_cols(Bt, dt, settings), dt, settings)
    return state._replace(Sigma=_dense_riccati(state, A_d, Bt, dt, settings))


def integrate_observer(state: EqFState, imu: IMU, dt, settings: Settings) -> EqFState:
    """Move the observer by one IMU sample: the discrete lift, or the
    exponential of the continuous lift times ``dt``."""
    xi_hat = state_estimate(state)
    if settings.use_discrete_velocity_lift:
        lifted = lift_velocity_discrete(xi_hat, imu, dt)
    else:
        lifted = group_exp(algebra_scale(lift_velocity(xi_hat, imu), dt))
    return state._replace(X=group_normalize(group_mul(state.X, lifted)))


def propagate(state: EqFState, imu: IMU, dt, settings: Settings, suite: CoordinateSuite | None = None) -> EqFState:
    """One IMU sample: the configured Riccati step, then the observer."""
    if suite is None:
        suite = settings.suite
    if settings.use_discrete_state_matrix:
        state = integrate_riccati_discrete(state, imu, dt, settings, suite)
    elif settings.use_accurate_riccati:
        state = integrate_riccati_accurate(state, imu, dt, settings, suite)
    else:
        state = integrate_riccati_fast(state, imu, dt, settings, suite)
    state = integrate_observer(state, imu, dt, settings)
    return state._replace(t=torch.maximum(state.t, imu.stamp.to(state.t.dtype)))


def _imu_at(imu: IMU, k: int) -> IMU:
    return IMU(imu.stamp[k], imu.gyr[k], imu.acc[k], imu.gyr_bias_vel[k], imu.acc_bias_vel[k])


def predict_state(state: EqFState, imu_window: IMU, dts: torch.Tensor) -> VIOState:
    """The state estimate integrated forward over an IMU window ``[K]`` (a
    Python loop in place of ``lax.scan``); zero-dt entries are no-ops."""
    xi = state_estimate(state)
    for k in range(dts.shape[0]):
        xi = integrate_system(xi, _imu_at(imu_window, k), dts[k])
    return xi


def riccati_steps(settings: Settings, window: int) -> int:
    """The Riccati steps :func:`propagate_window` runs over a window of
    ``window`` entries: one on the mean IMU with fast Riccati, else one per
    entry, zero-dt pads included."""
    return 1 if settings.fast_riccati else window


def propagate_window(
    state: EqFState,
    imu_window: IMU,
    dts: torch.Tensor,
    settings: Settings,
    suite: CoordinateSuite | None = None,
    wide_factor: bool = False,
) -> EqFState:
    """Propagate over a padded IMU window ``[K]`` with per-sample dt; the
    loops over the window are Python loops in place of ``lax.scan``, so a
    captured step holds K copies of their bodies.  Zero-dt pad entries are
    exact no-ops.

    Fast Riccati: one Riccati step on the time-weighted mean IMU, then with
    the discrete velocity lift the fused observer (integrate the estimate
    over the window and apply ONE exact group element), else the per-sample
    continuous lift.  Otherwise :func:`propagate` per sample.
    ``wide_factor=True`` (fast Riccati in square-root mode; a no-op
    otherwise) leaves ``Sigma`` as the wide Riccati stack for the following
    :func:`process_vision`.
    """
    if suite is None:
        suite = settings.suite
    if not settings.fast_riccati:
        for k in range(dts.shape[0]):
            state = propagate(state, _imu_at(imu_window, k), dts[k], settings, suite)
        return state._replace(t=torch.maximum(state.t, torch.max(imu_window.stamp).to(state.t.dtype)))

    total = torch.clamp(torch.sum(dts), min=1e-9)
    weight = (dts / total)[:, None]
    mean_imu = IMU(
        stamp=torch.max(imu_window.stamp),
        gyr=torch.sum(imu_window.gyr * weight, dim=0),
        acc=torch.sum(imu_window.acc * weight, dim=0),
        gyr_bias_vel=torch.sum(imu_window.gyr_bias_vel * weight, dim=0),
        acc_bias_vel=torch.sum(imu_window.acc_bias_vel * weight, dim=0),
    )
    wide = wide_factor and settings.sqrt_covariance
    state = integrate_riccati_fast(state, mean_imu, total, settings, suite, wide=wide)

    if settings.use_discrete_velocity_lift:
        xi_hat0 = state_estimate(state)
        xi = xi_hat0
        for k in range(dts.shape[0]):
            xi = integrate_system(xi, _imu_at(imu_window, k), dts[k])
        L = group_element_between(xi_hat0, xi)
        state = state._replace(X=group_normalize(group_mul(state.X, L)))
    else:
        for k in range(dts.shape[0]):
            state = integrate_observer(state, _imu_at(imu_window, k), dts[k], settings)
    return state._replace(t=torch.maximum(state.t, torch.max(imu_window.stamp).to(state.t.dtype)))


# ---------------------------------------------------------------------------
# Vision update
# ---------------------------------------------------------------------------


def output_terms(state: EqFState, pixels: torch.Tensor, vis_mask: torch.Tensor, camera, settings: Settings,
                 suite: CoordinateSuite) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The update's measurement terms: the output matrix blocks ``C [N, 2,
    3]`` and the residual ``[N, 2]``, both zero on slots that are not active
    and visible, and the measurement variances ``[2N]`` (1 where inactive)."""
    xi0, X = state.xi0, state.X
    active = (xi0.mask & vis_mask).to(state.Sigma.dtype)
    y_hat, _ = measure_system(state_action(X, xi0), camera)
    resid = (pixels - y_hat) * active[:, None]

    if settings.use_equivariant_output:
        C = suite.output_Ci_star(xi0.landmarks, X.Q, camera, pixels)
    else:
        C = suite.output_Ci(xi0.landmarks, X.Q, camera)
    C = C * active[:, None, None]
    act2 = active.repeat_interleave(2) > 0
    r_diag = torch.where(
        act2,
        torch.full_like(active.repeat_interleave(2), settings.measurement_noise**2),
        torch.ones_like(active.repeat_interleave(2)),
    )
    return C, resid, r_diag


def update_vision(
    state: EqFState,
    pixels: torch.Tensor,
    vis_mask: torch.Tensor,
    camera,
    settings: Settings,
    suite: CoordinateSuite | None = None,
    surgery: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> EqFState:
    """Masked EqF update with the block-structured output matrix ``C`` (one
    2x3 block per landmark).

    Square-root mode: one QR of the Kailath pre-array ``[[R^1/2, C W], [0, W]]``.
    ``surgery=(keep_vec, add_diag)`` runs the update against
    ``diag(keep) Sigma diag(keep) + diag(add)`` by widening ``W`` to
    ``[keep o L, diag(sqrt(add))]``; the post-array factor is then already
    the clean factor of the sanitized posterior.  Dense mode: the surgery is
    applied to Sigma, the innovation covariance is factored with
    ``cholesky_ex`` (no host check of its ``info``) and the gain is two
    triangular solves; the posterior is sanitized.
    """
    if suite is None:
        suite = settings.suite
    xi0, X, Sigma = state.xi0, state.X, state.Sigma
    N = xi0.capacity
    D = xi0.dim()
    C, resid, r_diag = output_terms(state, pixels, vis_mask, camera, settings, suite)

    m = 2 * N
    if settings.sqrt_covariance:
        if surgery is not None:
            keep_vec, add_diag = surgery
            W = torch.cat([Sigma * keep_vec[:, None], torch.diag(torch.sqrt(add_diag))], dim=1)
        else:
            W = Sigma
        Wc = W.shape[1]
        CW = torch.einsum("iax,ixd->iad", C, W[SENSOR_DIM:].reshape(N, 3, Wc)).reshape(m, Wc)
        Gamma, Sigma_new = kailath_update(r_diag, CW, W, resid)
    else:
        if surgery is not None:
            Sigma = _dense_mask_reset(Sigma, *surgery)
        Sig_lm = Sigma[SENSOR_DIM:, SENSOR_DIM:].reshape(N, 3, N, 3)
        S = torch.einsum("iax,ixjy,jby->iajb", C, Sig_lm, C).reshape(m, m) + torch.diag(r_diag)
        SigCt = torch.einsum("djy,jby->djb", Sigma[:, SENSOR_DIM:].reshape(D, N, 3), C).reshape(D, m)
        K = kalman_gain(S, SigCt)
        Gamma = K @ resid.reshape(-1)
        Sigma_new = Sigma - K @ SigCt.T
        Sigma_new = 0.5 * (Sigma_new + Sigma_new.T)

    X_new = innovate(X, Gamma, xi0, settings, suite)
    if not (settings.sqrt_covariance and surgery is not None):
        Sigma_new = sanitize_sigma(Sigma_new, xi0, settings)
    return state._replace(X=X_new, Sigma=Sigma_new)


def kailath_update(r_diag: torch.Tensor, CW: torch.Tensor, W: torch.Tensor,
                   resid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The square-root update as one QR of the Kailath pre-array ``[[R^1/2,
    C W], [0, W]]``: returns the innovation ``Gamma [D]`` and the posterior
    factor ``[D, D]``."""
    m, D, Wc = CW.shape[0], W.shape[0], W.shape[1]
    pre = W.new_zeros(m + D, m + Wc)  # from a state tensor, so a vmap over lanes batches it
    pre[:m, :m] = torch.diag(torch.sqrt(r_diag))
    pre[:m, m:] = CW
    pre[m:, m:] = W
    post = tria(pre)
    S_half = post[:m, :m]
    Kbar = post[m:, :m]
    Gamma = Kbar @ torch.linalg.solve_triangular(S_half, resid.reshape(-1, 1), upper=False).squeeze(-1)
    return Gamma, post[m:, m:]


def kalman_gain(S: torch.Tensor, SigCt: torch.Tensor) -> torch.Tensor:
    """``K = SigCt S^-1`` from ``S K^T = SigCt^T`` through the two triangular
    factors of ``S`` (``cholesky_ex``: no host check of its ``info``)."""
    chol = torch.linalg.cholesky_ex(S)[0]
    return torch.linalg.solve_triangular(
        chol.T, torch.linalg.solve_triangular(chol, SigCt.T, upper=False), upper=True).T


def innovate(X: VIOGroup, Gamma: torch.Tensor, xi0: VIOState, settings: Settings,
             suite: CoordinateSuite) -> VIOGroup:
    """The observer corrected by the innovation ``Gamma`` (the update's
    ``K r``), lifted to the group and applied on the left."""
    if settings.use_discrete_innovation_lift:
        Delta = suite.lift_innovation_discrete(Gamma, xi0)
    else:
        Delta = group_exp(suite.lift_innovation(Gamma, xi0))
    return group_normalize(group_mul(Delta, X))


# ---------------------------------------------------------------------------
# Landmark lifecycle
# ---------------------------------------------------------------------------


def _eye_like_Q(state: EqFState) -> torch.Tensor:
    return torch.eye(3, dtype=state.X.Q.R.dtype, device=state.X.Q.R.device).expand_as(state.X.Q.R)


def remove_landmarks(state: EqFState, rm_mask: torch.Tensor, settings: Settings) -> EqFState:
    """Deactivate slots: mask off, identity Q, dummy origin point, reset covariance."""
    keep = state.xi0.mask & ~rm_mask
    dtype, device = state.xi0.landmarks.dtype, state.xi0.landmarks.device
    dummy = const(DUMMY_POINT, dtype, device)
    xi0 = state.xi0._replace(
        landmarks=torch.where(keep[:, None], state.xi0.landmarks, dummy),
        ids=torch.where(keep, state.xi0.ids, torch.full_like(state.xi0.ids, -1)),
        mask=keep,
    )
    Q = state.X.Q._replace(
        R=torch.where(keep[:, None, None], state.X.Q.R, _eye_like_Q(state)),
        a=torch.where(keep, state.X.Q.a, torch.ones_like(state.X.Q.a)),
    )
    return state._replace(
        xi0=xi0, X=state.X._replace(Q=Q), Sigma=sanitize_sigma(state.Sigma, xi0, settings)
    )


def median_scene_depth(state: EqFState, settings: Settings, mask: torch.Tensor | None = None) -> torch.Tensor:
    """Masked median depth of the current estimate."""
    xi_hat = state_estimate(state)
    if mask is None:
        mask = xi_hat.mask
    d2 = torch.sum(xi_hat.landmarks**2, dim=-1)
    d2_sorted = torch.sort(torch.where(mask, d2, torch.full_like(d2, 1e30))).values
    n_active = torch.sum(mask)
    idx = torch.clamp(n_active // 2, 0, xi_hat.capacity - 1)
    med = torch.sqrt(d2_sorted.index_select(0, idx.reshape(1))[0])
    return torch.where(n_active > 0, med, torch.full_like(med, settings.initial_scene_depth))


def add_landmarks(
    state: EqFState,
    pixels: torch.Tensor,
    new_mask: torch.Tensor,
    new_ids: torch.Tensor,
    camera,
    settings: Settings,
) -> EqFState:
    """Initialise new slots from undistorted bearings at the median (or fixed)
    scene depth, with identity Q and the initial point variance."""
    dtype, device = state.xi0.landmarks.dtype, state.xi0.landmarks.device
    if settings.use_median_depth:
        depth = median_scene_depth(state, settings)
    else:
        depth = const(settings.initial_scene_depth, dtype, device)
    q_new = camera.undistort(pixels) * depth
    xi0 = state.xi0._replace(
        landmarks=torch.where(new_mask[:, None], q_new, state.xi0.landmarks),
        ids=torch.where(new_mask, new_ids, state.xi0.ids),
        mask=state.xi0.mask | new_mask,
    )
    Q = state.X.Q._replace(
        R=torch.where(new_mask[:, None, None], _eye_like_Q(state), state.X.Q.R),
        a=torch.where(new_mask, torch.ones_like(state.X.Q.a), state.X.Q.a),
    )
    zeros = torch.zeros(SENSOR_DIM, dtype=dtype, device=device)
    full_new = torch.cat([zeros, new_mask.to(dtype).repeat_interleave(3)])
    pdiag = torch.cat(
        [zeros, settings.initial_point_cov_diag(dtype, device).repeat(state.xi0.capacity)]
    )
    Sigma = _mask_reset(state.Sigma, 1.0 - full_new, full_new * pdiag, settings)
    return state._replace(xi0=xi0, X=state.X._replace(Q=Q), Sigma=Sigma)


def outlier_mask(
    state: EqFState,
    pixels: torch.Tensor,
    vis_mask: torch.Tensor,
    camera,
    settings: Settings,
    suite: CoordinateSuite | None = None,
) -> torch.Tensor:
    """Two-stage ranked outlier rejection: absolute-pixel outliers rank above
    Mahalanobis outliers; at most ``(1 - retention) * M`` are discarded."""
    if suite is None:
        suite = settings.suite
    xi0, X, Sigma = state.xi0, state.X, state.Sigma
    N = xi0.capacity
    dtype = Sigma.dtype
    tracked = xi0.mask & vis_mask

    y_hat, _ = measure_system(state_estimate(state), camera)
    resid = pixels - y_hat
    err_abs = torch.linalg.norm(resid, dim=-1)
    abs_out = tracked & (err_abs > settings.outlier_threshold_abs)

    C0 = suite.output_Ci(xi0.landmarks, X.Q, camera)
    if settings.sqrt_covariance:  # the marginal 3x3 blocks from the factor's landmark rows
        L_lm = Sigma[SENSOR_DIM:].reshape(N, 3, -1)
        lm_diag = torch.einsum("nxd,nyd->nxy", L_lm, L_lm)
    else:
        idx = torch.arange(N, device=Sigma.device)
        lm_diag = Sigma[SENSOR_DIM:, SENSOR_DIM:].reshape(N, 3, N, 3)[idx, :, idx, :]
    out_cov = C0 @ lm_diag @ C0.transpose(-1, -2)
    out_cov = out_cov + torch.eye(2, dtype=dtype, device=Sigma.device) * 1e-12
    a, b = out_cov[:, 0, 0], out_cov[:, 0, 1]
    c, d = out_cov[:, 1, 0], out_cov[:, 1, 1]
    det = a * d - b * c
    sol = torch.stack(
        [d * resid[:, 0] - b * resid[:, 1], -c * resid[:, 0] + a * resid[:, 1]], dim=-1
    ) / det[:, None]
    err_prob = torch.sum(resid * sol, dim=-1)
    prob_out = tracked & ~abs_out & (err_prob > settings.outlier_threshold_prob)

    proposed = abs_out | prob_out
    neg_inf = torch.full_like(err_prob, -float("inf"))
    score = torch.where(abs_out, 1e12 + err_abs, torch.where(prob_out, err_prob, neg_inf))
    order = torch.argsort(-score, stable=True)
    rank = torch.argsort(order, stable=True)
    m_meas = torch.sum(tracked).to(torch.float64)
    max_outliers = torch.floor((1.0 - settings.feature_retention) * m_meas).to(rank.dtype)
    return proposed & (rank < max_outliers)


def process_vision(
    state: EqFState,
    pixels: torch.Tensor,
    vis_mask: torch.Tensor,
    ids: torch.Tensor,
    camera,
    settings: Settings,
    suite: CoordinateSuite | None = None,
    do_update: bool = True,
) -> EqFState:
    """Per-frame vision step: lost, outlier and scale-invalid removal, new
    landmarks, then the update with all covariance surgery folded into its
    pre-array.

    ``do_update=False`` stops after the lifecycle stage and applies its
    covariance surgery alone (no EqF update): the ``--timing`` calibration
    times "preprocessing" with it."""
    if suite is None:
        suite = settings.suite
    xi0, X = state.xi0, state.X
    dtype, device = state.Sigma.dtype, state.Sigma.device
    N = xi0.capacity

    same_id = xi0.ids == ids
    if settings.remove_lost_landmarks:
        vis_tracked = vis_mask & same_id
        lost = xi0.mask & ~vis_tracked
    else:
        vis_tracked = vis_mask
        lost = torch.zeros_like(xi0.mask)
    invalid = ((X.Q.a <= 1e-8) | (X.Q.a > 1e8)) & xi0.mask

    out = outlier_mask(state, pixels, vis_tracked, camera, settings, suite)
    rm = (lost | out | invalid) & xi0.mask
    kept = xi0.mask & ~rm
    new = vis_mask & ~out & ~kept

    if settings.use_median_depth:
        depth = median_scene_depth(state, settings, mask=kept)
    else:
        depth = const(settings.initial_scene_depth, dtype, device)
    q_new = camera.undistort(pixels) * depth
    dummy = const(DUMMY_POINT, dtype, device)
    landmarks = torch.where(new[:, None], q_new, torch.where(kept[:, None], xi0.landmarks, dummy))
    ids_new = torch.where(new, ids, torch.where(kept, xi0.ids, torch.full_like(xi0.ids, -1)))
    xi0_new = xi0._replace(landmarks=landmarks, ids=ids_new, mask=kept | new)
    Q = X.Q._replace(
        R=torch.where(kept[:, None, None], X.Q.R, _eye_like_Q(state)),
        a=torch.where(kept, X.Q.a, torch.ones_like(X.Q.a)),
    )
    state = state._replace(xi0=xi0_new, X=X._replace(Q=Q))

    ones = torch.ones(SENSOR_DIM, dtype=dtype, device=device)
    keep_vec = torch.cat([ones, kept.to(dtype).repeat_interleave(3)])
    pv_init = settings.initial_point_cov_diag(dtype, device).expand(N, 3)
    add_lm = torch.where(
        new[:, None],
        pv_init,
        torch.where(
            kept[:, None],
            torch.zeros_like(pv_init),
            torch.full_like(pv_init, settings.initial_point_var),
        ),
    )
    add_diag = torch.cat([torch.zeros_like(ones), add_lm.reshape(-1)])
    if not do_update:
        return state._replace(Sigma=_mask_reset(state.Sigma, keep_vec, add_diag, settings))
    vis_upd = (vis_tracked & kept) | new
    stamp(LIFECYCLE_END)
    return update_vision(
        state, pixels, vis_upd, camera, settings, suite, surgery=(keep_vec, add_diag)
    )


def health_check(state: EqFState, settings: Settings) -> dict:
    """Failure flags: ``nan``, ``sigma_pd`` (the factor's diagonal > 0, or a
    Cholesky factorisation of the dense Sigma that succeeds) and
    ``scales_valid`` (active landmark scales inside [1e-8, 1e8])."""
    nan = (
        group_has_nan(state.X)
        | torch.isnan(state.Sigma).any()
        | torch.isnan(state.xi0.landmarks).any()
        | torch.isnan(state.xi0.sensor.pose.R).any()
    )
    if settings.sqrt_covariance:
        sigma_pd = torch.all(torch.diagonal(state.Sigma) > 0)
    else:
        sigma_pd = torch.linalg.cholesky_ex(state.Sigma)[1] == 0
    a = state.X.Q.a
    scales_valid = torch.all(torch.where(state.xi0.mask, (a > 1e-8) & (a < 1e8), True))
    return {"nan": nan, "sigma_pd": sigma_pd, "scales_valid": scales_valid}


def remove_invalid_landmarks(state: EqFState, settings: Settings) -> EqFState:
    """Prune the landmarks whose scale left [1e-8, 1e8]."""
    bad = (state.X.Q.a <= 1e-8) | (state.X.Q.a > 1e8)
    return remove_landmarks(state, bad & state.xi0.mask, settings)


# ---------------------------------------------------------------------------
# Simulation support: exact states and landmarks
# ---------------------------------------------------------------------------


def _point_cov_diag(capacity: int, settings: Settings, dtype, device) -> torch.Tensor:
    """``[D]``: zero on the sensor, the initial point variance on every slot."""
    return torch.cat([torch.zeros(SENSOR_DIM, dtype=dtype, device=device),
                      settings.initial_point_cov_diag(dtype, device).repeat(capacity)])


def _reset_points(state: EqFState, xi0: VIOState, slots: torch.Tensor, settings: Settings) -> torch.Tensor:
    """The covariance with the rows and columns of ``slots [N]`` reset to the
    initial point variance, in the state's form."""
    dtype, device = state.Sigma.dtype, state.Sigma.device
    full = torch.cat([torch.zeros(SENSOR_DIM, dtype=dtype, device=device),
                      slots.to(dtype).repeat_interleave(3)])
    pdiag = _point_cov_diag(xi0.capacity, settings, dtype, device)
    return _mask_reset(state.Sigma, 1.0 - full, full * pdiag, settings)


def set_state(state: EqFState, xi: VIOState, settings: Settings) -> EqFState:
    """Reset the filter to the exact state ``xi``: identity observer, the
    initial covariance with inactive slots sanitized."""
    dtype, device = state.Sigma.dtype, state.Sigma.device
    capacity = xi.capacity
    diag = torch.cat([settings.initial_sensor_cov_diag(dtype, device),
                      settings.initial_point_cov_diag(dtype, device).repeat(capacity)])
    Sigma0 = torch.diag(torch.sqrt(diag) if settings.sqrt_covariance else diag)
    return EqFState(xi0=xi, X=group_identity(capacity, dtype, device), Sigma=sanitize_sigma(Sigma0, xi, settings),
                    t=state.t)


def set_landmarks(state: EqFState, landmarks: torch.Tensor, ids: torch.Tensor, mask: torch.Tensor,
                  settings: Settings) -> EqFState:
    """Replace every landmark slot with exact values, identity ``Q``, and
    reset the active slots' covariance."""
    xi0 = state.xi0._replace(landmarks=landmarks, ids=ids, mask=mask)
    X = state.X._replace(Q=state.X.Q._replace(R=_eye_like_Q(state), a=torch.ones_like(state.X.Q.a)))
    Sigma = _reset_points(state, xi0, mask, settings)
    return state._replace(xi0=xi0, X=X, Sigma=sanitize_sigma(Sigma, xi0, settings))


def augment_landmarks(state: EqFState, new_mask: torch.Tensor, ids: torch.Tensor, true_points: torch.Tensor,
                      settings: Settings) -> EqFState:
    """Insert new landmark slots at exact (estimate-frame) positions with
    identity ``Q`` and the initial point variance."""
    xi0 = state.xi0._replace(
        landmarks=torch.where(new_mask[:, None], true_points, state.xi0.landmarks),
        ids=torch.where(new_mask, ids, state.xi0.ids),
        mask=state.xi0.mask | new_mask,
    )
    Q = state.X.Q._replace(
        R=torch.where(new_mask[:, None, None], _eye_like_Q(state), state.X.Q.R),
        a=torch.where(new_mask, torch.ones_like(state.X.Q.a), state.X.Q.a),
    )
    return state._replace(xi0=xi0, X=state.X._replace(Q=Q), Sigma=_reset_points(state, xi0, new_mask, settings))


# ---------------------------------------------------------------------------
# Consistency metrics against a slot-aligned true state
# ---------------------------------------------------------------------------


def _cholesky(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor with no host check; NaN where the factorisation
    fails, as ``jnp.linalg.cholesky``."""
    L, info = torch.linalg.cholesky_ex(M)
    return torch.where(info == 0, L, torch.full_like(L, float("nan")))


def _quad(L: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``v^T (L L^T)^-1 v`` through one triangular solve."""
    w = torch.linalg.solve_triangular(L, v[:, None], upper=False)
    return torch.sum(w * w)


def _error_coords(state: EqFState, true_state: VIOState, suite: CoordinateSuite) -> torch.Tensor:
    """The chart coordinates of the true state seen from the estimate, zero
    on inactive slots."""
    err_state = state_action(group_inv(state.X), true_state)
    return suite.chart.chart(err_state, state.xi0) * _mask_vec(state.xi0)


def compute_nees(state: EqFState, true_state: VIOState, suite: CoordinateSuite | None = None,
                 settings: Settings | None = None) -> torch.Tensor:
    """Normalised estimation error squared per degree of freedom against a
    slot-aligned true state (the simulator provides the alignment)."""
    settings = settings or Settings()
    suite = suite or settings.suite
    eps = _error_coords(state, true_state, suite)
    L = state.Sigma if settings.sqrt_covariance else _cholesky(state.Sigma)
    return _quad(L, eps) / (SENSOR_DIM + 3 * torch.sum(state.xi0.mask))


def compute_nees_breakdown(state: EqFState, true_state: VIOState, suite: CoordinateSuite | None = None,
                           settings: Settings | None = None):
    """``(total, pose, attitude)`` NEES against the marginal Sigma blocks."""
    total, pose, att, *_ = consistency_outputs(state, true_state, suite, settings)
    return total, pose, att


def consistency_outputs(state: EqFState, true_state: VIOState, suite: CoordinateSuite | None = None,
                        settings: Settings | None = None):
    """Everything the simulation's consistency CSVs need, in one pass: total,
    pose and attitude NEES, the sensor error coordinates ``eps [21]``, the
    marginal Sigma diagonal ``[21]`` and each slot's landmark position error
    ``[N]`` (NaN on inactive slots)."""
    settings = settings or Settings()
    suite = suite or settings.suite
    eps = _error_coords(state, true_state, suite)
    Sig = dense_sigma(state, settings)
    total = _quad(_cholesky(Sig), eps) / (SENSOR_DIM + 3 * torch.sum(state.xi0.mask))
    pose = _quad(_cholesky(Sig[6:12, 6:12]), eps[6:12]) / 6.0
    att = _quad(_cholesky(Sig[6:9, 6:9]), eps[6:9]) / 3.0
    lm_err = torch.linalg.norm(state_estimate(state).landmarks - true_state.landmarks, dim=-1)
    lm_err = torch.where(state.xi0.mask, lm_err, torch.full_like(lm_err, float("nan")))
    return total, pose, att, eps[:SENSOR_DIM], torch.diagonal(Sig)[:SENSOR_DIM], lm_err
