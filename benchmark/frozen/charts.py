"""Coordinate charts for the VIO state manifold (counterpart of
``eqvio_tpu/charts.py``): the stereographic and normal sphere charts, the
Euclidean, inverse-depth and normal landmark charts, the standard and
SE_2(3)-coupled normal sensor charts, the assembled state charts and the
invdepth/euclid differentials.

Convention: ``chart(xi, xi0) -> eps`` maps a state to local coordinates
centred at ``xi0``; ``chart_inv(eps, xi0) -> xi`` inverts it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .lie import (
    SE3,
    SE23,
    cross,
    mv,
    se3_exp,
    se3_inv,
    se3_log,
    se3_mul,
    se23_exp,
    se23_log,
    so3_exp,
    so3_from_vectors,
)
from .runtime import const
from .states import VIOSensorState, VIOState, split_coords_vector, state_coords_vector


def _e3_like(v: torch.Tensor) -> torch.Tensor:
    e3 = torch.zeros_like(v)
    e3[..., 2].fill_(1.0)
    return e3


def e3_project_sphere(eta: torch.Tensor) -> torch.Tensor:
    """Stereographic projection of ``eta`` on S^2 about the pole e3."""
    denom = 1.0 - eta[..., 2]
    denom = torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 1e-12), denom)
    return eta[..., 0:2] / denom[..., None]


def e3_project_sphere_inv(y: torch.Tensor) -> torch.Tensor:
    y_sq = torch.sum(y * y, dim=-1)
    factor = 2.0 / (y_sq + 1.0)
    return torch.cat([factor[..., None] * y, (1.0 - factor)[..., None]], dim=-1)


def e3_project_sphere_diff(eta: torch.Tensor) -> torch.Tensor:
    """Differential ``[..., 2, 3]`` of :func:`e3_project_sphere`."""
    e3 = _e3_like(eta)
    eye = torch.eye(3, dtype=eta.dtype, device=eta.device)
    M = eye * (1.0 - eta[..., 2])[..., None, None] + (eta - e3)[..., :, None] * e3[..., None, :]
    denom = 1.0 - eta[..., 2]
    denom = torch.where(torch.abs(denom) < 1e-12, torch.full_like(denom, 1e-12), denom)
    return M[..., 0:2, :] / (denom * denom)[..., None, None]


def e3_project_sphere_inv_diff(y: torch.Tensor) -> torch.Tensor:
    """Differential ``[..., 3, 2]`` of :func:`e3_project_sphere_inv`."""
    y_sq = torch.sum(y * y, dim=-1)
    eye2 = torch.eye(2, dtype=y.dtype, device=y.device)
    top = eye2 * (y_sq + 1.0)[..., None, None] - 2.0 * y[..., :, None] * y[..., None, :]
    D = torch.cat([top, 2.0 * y[..., None, :]], dim=-2)
    return 2.0 * D / ((y_sq + 1.0) ** 2)[..., None, None]


class EmbeddedChart(NamedTuple):
    chart: Callable  # (eta, pole) -> [..., 2]
    chart_inv: Callable  # (y, pole) -> [..., 3]
    chart_diff0: Callable  # (pole) -> [..., 2, 3]
    chart_inv_diff0: Callable  # (pole) -> [..., 3, 2]


def _stereo_rot(pole):
    return so3_from_vectors(-pole, _e3_like(pole))


def _stereo_chart(eta, pole):
    return e3_project_sphere(mv(_stereo_rot(pole), eta))


def _stereo_chart_inv(y, pole):
    return mv(_stereo_rot(pole).transpose(-1, -2), e3_project_sphere_inv(y))


def _stereo_diff0(pole):
    R = _stereo_rot(pole)
    return e3_project_sphere_diff(mv(R, pole)) @ R


def _stereo_inv_diff0(pole):
    R = _stereo_rot(pole)
    zero2 = torch.zeros(*pole.shape[:-1], 2, dtype=pole.dtype, device=pole.device)
    return R.transpose(-1, -2) @ e3_project_sphere_inv_diff(zero2)


sphere_chart_stereo = EmbeddedChart(
    _stereo_chart, _stereo_chart_inv, _stereo_diff0, _stereo_inv_diff0
)


def _normal_rot(pole):
    return so3_from_vectors(pole, _e3_like(pole))


def _normal_chart(eta, pole):
    y = mv(_normal_rot(pole), eta)
    c = cross(y, _e3_like(pole))
    sin_th = torch.linalg.norm(c, dim=-1)
    th = torch.atan2(sin_th, y[..., 2])
    safe = torch.where(sin_th < 1e-30, torch.ones_like(sin_th), sin_th)
    factor = torch.where(torch.abs(th) < 1e-8, torch.ones_like(th), th / safe)
    return (c * factor[..., None])[..., 0:2]


def _normal_chart_inv(eps, pole):
    omega = torch.cat([eps, torch.zeros_like(eps[..., :1])], dim=-1)
    y = mv(so3_exp(-omega), _e3_like(pole))
    return mv(_normal_rot(pole).transpose(-1, -2), y)


def _normal_diff0(pole):
    return const(((0.0, 1.0, 0.0), (-1.0, 0.0, 0.0)), pole.dtype, pole.device) @ _normal_rot(pole)


def _normal_inv_diff0(pole):
    D = const(((0.0, -1.0), (1.0, 0.0), (0.0, 0.0)), pole.dtype, pole.device)
    return _normal_rot(pole).transpose(-1, -2) @ D


sphere_chart_normal = EmbeddedChart(_normal_chart, _normal_chart_inv, _normal_diff0, _normal_inv_diff0)


def point_chart_euclid(p, p0):
    return p - p0


def point_chart_euclid_inv(eps, p0):
    return p0 + eps


def _bearing_invdepth(p):
    r = torch.clamp(torch.linalg.norm(p, dim=-1), min=1e-12)
    return p / r[..., None], 1.0 / r


def point_chart_invdepth(p, p0):
    y, rho = _bearing_invdepth(p)
    y0, rho0 = _bearing_invdepth(p0)
    eps_b = sphere_chart_stereo.chart(y, y0)
    return torch.cat([eps_b, (rho - rho0)[..., None]], dim=-1)


def point_chart_invdepth_inv(eps, p0):
    y0, rho0 = _bearing_invdepth(p0)
    y = sphere_chart_stereo.chart_inv(eps[..., 0:2], y0)
    rho = eps[..., 2] + rho0
    rho = torch.where(rho <= 0.0, torch.full_like(rho, 1e-6), rho)
    return y / rho[..., None]


def point_chart_normal(p, p0):
    y, rho = _bearing_invdepth(p)
    y0, rho0 = _bearing_invdepth(p0)
    eps_b = sphere_chart_normal.chart(y, y0)
    return torch.cat([eps_b, torch.log(rho / rho0)[..., None]], dim=-1)


def point_chart_normal_inv(eps, p0):
    y0, rho0 = _bearing_invdepth(p0)
    y = sphere_chart_normal.chart_inv(eps[..., 0:2], y0)
    return y / (rho0 * torch.exp(eps[..., 2]))[..., None]


def sensor_chart_std(xi: VIOSensorState, xi0: VIOSensorState) -> torch.Tensor:
    return torch.cat(
        [
            xi.bias - xi0.bias,
            se3_log(se3_mul(se3_inv(xi0.pose), xi.pose)),
            xi.velocity - xi0.velocity,
            se3_log(se3_mul(se3_inv(xi0.camera_offset), xi.camera_offset)),
        ],
        dim=-1,
    )


def sensor_chart_std_inv(eps: torch.Tensor, xi0: VIOSensorState) -> VIOSensorState:
    return VIOSensorState(
        bias=xi0.bias + eps[..., 0:6],
        pose=se3_mul(xi0.pose, se3_exp(eps[..., 6:12])),
        velocity=xi0.velocity + eps[..., 12:15],
        camera_offset=se3_mul(xi0.camera_offset, se3_exp(eps[..., 15:21])),
    )


def sensor_chart_normal(xi: VIOSensorState, xi0: VIOSensorState) -> torch.Tensor:
    """Bias difference, the SE_2(3) log of the pose-velocity change and the
    camera-offset change in the moving frame."""
    A = se3_mul(se3_inv(xi0.pose), xi.pose)
    v_xi0 = mv(xi0.pose.R, xi0.velocity)
    v_A = mv(xi0.pose.R.transpose(-1, -2), mv(xi.pose.R, xi.velocity) - v_xi0)
    B = se3_mul(se3_inv(xi0.camera_offset), se3_mul(A, xi.camera_offset))
    return torch.cat([xi.bias - xi0.bias, se23_log(SE23(A.R, A.x, v_A)), se3_log(B)], dim=-1)


def sensor_chart_normal_inv(eps: torch.Tensor, xi0: VIOSensorState) -> VIOSensorState:
    ext = se23_exp(eps[..., 6:15])
    A = SE3(ext.R, ext.x1)
    pose = se3_mul(xi0.pose, A)
    v_xi0 = mv(xi0.pose.R, xi0.velocity)
    velocity = mv(pose.R.transpose(-1, -2), v_xi0 + mv(xi0.pose.R, ext.x2))
    camera_offset = se3_mul(se3_inv(A), se3_mul(xi0.camera_offset, se3_exp(eps[..., 15:21])))
    return VIOSensorState(bias=xi0.bias + eps[..., 0:6], pose=pose, velocity=velocity,
                          camera_offset=camera_offset)


class StateChart(NamedTuple):
    chart: Callable  # (xi, xi0) -> [..., 21 + 3N]
    chart_inv: Callable  # (eps, xi0) -> VIOState


def _make_state_chart(sensor_fwd, sensor_inv, point_fwd, point_inv) -> StateChart:
    def chart(xi: VIOState, xi0: VIOState) -> torch.Tensor:
        return state_coords_vector(
            sensor_fwd(xi.sensor, xi0.sensor), point_fwd(xi.landmarks, xi0.landmarks)
        )

    def chart_inv(eps: torch.Tensor, xi0: VIOState) -> VIOState:
        eps_sensor, eps_points = split_coords_vector(eps, xi0.capacity)
        return VIOState(
            sensor=sensor_inv(eps_sensor, xi0.sensor),
            landmarks=point_inv(eps_points, xi0.landmarks),
            ids=xi0.ids,
            mask=xi0.mask,
        )

    return StateChart(chart, chart_inv)


state_chart_euclid = _make_state_chart(
    sensor_chart_std, sensor_chart_std_inv, point_chart_euclid, point_chart_euclid_inv
)
state_chart_invdepth = _make_state_chart(
    sensor_chart_std, sensor_chart_std_inv, point_chart_invdepth, point_chart_invdepth_inv
)
state_chart_normal = _make_state_chart(
    sensor_chart_normal, sensor_chart_normal_inv, point_chart_normal, point_chart_normal_inv
)

STATE_CHARTS = {
    "euclid": state_chart_euclid,
    "invdepth": state_chart_invdepth,
    "normal": state_chart_normal,
}


def invdepth_euclid_block(p0: torch.Tensor) -> torch.Tensor:
    """Per-landmark 3x3 differential of euclid -> invdepth coords at the origin."""
    y0, rho0 = _bearing_invdepth(p0)
    eye = torch.eye(3, dtype=p0.dtype, device=p0.device)
    proj = eye - y0[..., :, None] * y0[..., None, :]
    top = rho0[..., None, None] * (sphere_chart_stereo.chart_diff0(y0) @ proj)
    bottom = -(rho0 * rho0)[..., None, None] * y0[..., None, :]
    return torch.cat([top, bottom], dim=-2)


def euclid_invdepth_block(p0: torch.Tensor) -> torch.Tensor:
    """Inverse blocks: invdepth -> euclid coords."""
    y0, rho0 = _bearing_invdepth(p0)
    left = sphere_chart_stereo.chart_inv_diff0(y0) / rho0[..., None, None]
    right = -(y0 / (rho0 * rho0)[..., None])[..., None]
    return torch.cat([left, right], dim=-1)
