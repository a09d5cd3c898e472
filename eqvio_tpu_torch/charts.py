"""Coordinate charts for the VIO state manifold (counterpart of
``eqvio_tpu/charts.py``): the stereographic sphere chart, the inverse-depth
landmark chart, the standard sensor chart, and the invdepth/euclid
differentials.  The normal charts wait with the Normal suite (``ROADMAP.md``
queue 1).

Convention: ``chart(xi, xi0) -> eps`` maps a state to local coordinates
centred at ``xi0``; ``chart_inv(eps, xi0) -> xi`` inverts it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .lie import mv, se3_exp, se3_inv, se3_log, se3_mul, so3_from_vectors
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


state_chart_invdepth = _make_state_chart(
    sensor_chart_std, sensor_chart_std_inv, point_chart_invdepth, point_chart_invdepth_inv
)


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
