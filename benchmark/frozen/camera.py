"""Camera models (counterpart of ``eqvio_tpu/camera.py``): pinhole,
radial-tangential and equidistant (Kannala-Brandt fisheye).

Intrinsics are 0-dim tensors on the camera's device and dtype; every map is
batched over leading axes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .lie import jacfwd

_EPS = 1e-9


def _normalize(v):
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True), min=1e-30)


def _safe_z(p):
    return torch.where(torch.abs(p[..., 2]) < _EPS, torch.full_like(p[..., 2], _EPS), p[..., 2])


def _in_image(camera, p, ok):
    if camera.width and camera.height:
        px = camera.project(p)
        ok = (
            ok
            & (px[..., 0] >= 0)
            & (px[..., 0] < camera.width)
            & (px[..., 1] >= 0)
            & (px[..., 1] < camera.height)
        )
    return ok


def _auto_jacobian(project, p: torch.Tensor) -> torch.Tensor:
    """Exact ``d project / d p`` by forward-mode AD (:func:`lie.jacfwd`):
    ``[..., 2, 3]``."""
    J = torch.func.vmap(lambda q: jacfwd(project, q))(p.reshape(-1, 3))
    return J.reshape(*p.shape[:-1], 2, 3)


def _scalar(v, dtype, device):
    return torch.as_tensor(v, dtype=dtype, device=device)


class PinholeCamera(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    width: int = 0  # 0 disables the image-bounds check
    height: int = 0

    @staticmethod
    def create(fx, fy, cx, cy, width, height, dtype: torch.dtype, device) -> "PinholeCamera":
        s = lambda v: _scalar(v, dtype, device)  # noqa: E731
        return PinholeCamera(s(fx), s(fy), s(cx), s(cy), int(width), int(height))

    def project(self, p: torch.Tensor) -> torch.Tensor:
        z = _safe_z(p)
        u = self.fx * p[..., 0] / z + self.cx
        v = self.fy * p[..., 1] / z + self.cy
        return torch.stack([u, v], dim=-1)

    def undistort(self, px: torch.Tensor) -> torch.Tensor:
        """Pixel -> unit bearing."""
        x = (px[..., 0] - self.cx) / self.fx
        y = (px[..., 1] - self.cy) / self.fy
        return _normalize(torch.stack([x, y, torch.ones_like(x)], dim=-1))

    def projection_jacobian(self, p: torch.Tensor) -> torch.Tensor:
        """Analytic ``d project / d p``: ``[..., 2, 3]``."""
        zi = 1.0 / _safe_z(p)
        zero = torch.zeros_like(zi)
        row0 = torch.stack([self.fx * zi, zero, -self.fx * p[..., 0] * zi * zi], dim=-1)
        row1 = torch.stack([zero, self.fy * zi, -self.fy * p[..., 1] * zi * zi], dim=-1)
        return torch.stack([row0, row1], dim=-2)

    def is_in_domain(self, p: torch.Tensor) -> torch.Tensor:
        return _in_image(self, p, p[..., 2] > _EPS)


class RadTanCamera(NamedTuple):
    """Radial-tangential ("plumb bob") camera with (k1, k2, p1, p2)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    p1: torch.Tensor
    p2: torch.Tensor
    width: int = 0
    height: int = 0

    @staticmethod
    def create(fx, fy, cx, cy, dist, width, height, dtype: torch.dtype, device) -> "RadTanCamera":
        s = lambda v: _scalar(v, dtype, device)  # noqa: E731
        k1, k2, p1, p2 = (s(d) for d in dist)
        return RadTanCamera(s(fx), s(fy), s(cx), s(cy), k1, k2, p1, p2, int(width), int(height))

    def _distort(self, m: torch.Tensor) -> torch.Tensor:
        x, y = m[..., 0], m[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + self.k1 * r2 + self.k2 * r2 * r2
        xd = x * radial + 2.0 * self.p1 * x * y + self.p2 * (r2 + 2.0 * x * x)
        yd = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * x * y
        return torch.stack([xd, yd], dim=-1)

    def project(self, p: torch.Tensor) -> torch.Tensor:
        m = p[..., 0:2] / _safe_z(p)[..., None]
        d = self._distort(m)
        return torch.stack([self.fx * d[..., 0] + self.cx, self.fy * d[..., 1] + self.cy], dim=-1)

    def undistort(self, px: torch.Tensor) -> torch.Tensor:
        """Pixel -> unit bearing by a fixed 10-step fixed-point iteration."""
        xd = (px[..., 0] - self.cx) / self.fx
        yd = (px[..., 1] - self.cy) / self.fy
        d = torch.stack([xd, yd], dim=-1)
        m = d
        for _ in range(10):
            m = d - (self._distort(m) - m)
        return _normalize(torch.cat([m, torch.ones_like(m[..., :1])], dim=-1))

    def projection_jacobian(self, p: torch.Tensor) -> torch.Tensor:
        return _auto_jacobian(self.project, p)

    def is_in_domain(self, p: torch.Tensor) -> torch.Tensor:
        return _in_image(self, p, p[..., 2] > _EPS)


class EquidistantCamera(NamedTuple):
    """Kannala-Brandt equidistant fisheye with (k1, k2, k3, k4)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    k1: torch.Tensor
    k2: torch.Tensor
    k3: torch.Tensor
    k4: torch.Tensor
    width: int = 0
    height: int = 0

    @staticmethod
    def create(fx, fy, cx, cy, dist, width, height, dtype: torch.dtype, device) -> "EquidistantCamera":
        s = lambda v: _scalar(v, dtype, device)  # noqa: E731
        k1, k2, k3, k4 = (s(d) for d in dist)
        return EquidistantCamera(s(fx), s(fy), s(cx), s(cy), k1, k2, k3, k4, int(width), int(height))

    def _theta_d(self, theta):
        t2 = theta * theta
        return theta * (1.0 + t2 * (self.k1 + t2 * (self.k2 + t2 * (self.k3 + t2 * self.k4))))

    def project(self, p: torch.Tensor) -> torch.Tensor:
        m = p[..., 0:2] / _safe_z(p)[..., None]
        r = torch.sqrt(torch.clamp(torch.sum(m * m, dim=-1), min=1e-18))
        d = (self._theta_d(torch.atan(r)) / r)[..., None] * m
        return torch.stack([self.fx * d[..., 0] + self.cx, self.fy * d[..., 1] + self.cy], dim=-1)

    def undistort(self, px: torch.Tensor) -> torch.Tensor:
        """Pixel -> unit bearing: 8 Newton steps on ``theta_d(theta) = r_d``."""
        xd = (px[..., 0] - self.cx) / self.fx
        yd = (px[..., 1] - self.cy) / self.fy
        theta_d = torch.sqrt(torch.clamp(xd * xd + yd * yd, min=1e-18))
        theta = theta_d
        for _ in range(8):
            t2 = theta * theta
            f = theta * (1.0 + t2 * (self.k1 + t2 * (self.k2 + t2 * (self.k3 + t2 * self.k4)))) - theta_d
            df = (1.0 + 3.0 * self.k1 * t2 + 5.0 * self.k2 * t2 * t2 + 7.0 * self.k3 * t2 * t2 * t2
                  + 9.0 * self.k4 * t2 * t2 * t2 * t2)
            theta = theta - f / torch.where(torch.abs(df) < 1e-9, torch.full_like(df, 1e-9), df)
        scale = torch.sin(theta) / theta_d
        return _normalize(torch.stack([xd * scale, yd * scale, torch.cos(theta)], dim=-1))

    def projection_jacobian(self, p: torch.Tensor) -> torch.Tensor:
        return _auto_jacobian(self.project, p)

    def is_in_domain(self, p: torch.Tensor) -> torch.Tensor:
        """In front of the lens within its >180 degree field, and in the image."""
        return _in_image(self, p, p[..., 2] > -0.5 * torch.linalg.norm(p, dim=-1))


def default_test_camera(dtype=torch.float64, device="cuda") -> PinholeCamera:
    """A fake 800x480 pinhole camera mirroring the reference test fixture."""
    return PinholeCamera.create(400.0, 400.0, 400.0, 240.0, 800, 480, dtype=dtype, device=device)
