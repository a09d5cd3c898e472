"""Batched Lie-group operations (counterpart of ``eqvio_tpu/lie.py``).

Groups: SO(3) as ``[..., 3, 3]`` matrices, SE(3) ``(R, x)``, SOT(3)
``(R, a)`` acting by ``p -> a R p`` and SE_2(3) ``(R, x1, x2)``.  Every
function is batched over leading axes and guarded near theta = 0 and pi with
the same Taylor branches as the reference, so both packages take the same
branch on the same input.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .runtime import const

_SMALL = 1e-6


def mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``[..., n, m] x [..., m] -> [..., n]``."""
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def jacfwd(fn, x: torch.Tensor) -> torch.Tensor:
    """``d fn(x) / d x`` by ``torch.func.jacfwd``, with ``fn`` evaluated on
    ``x`` under a leading axis of one.

    Forward AD promotes a 0-dim float32 tangent to float64 where it meets a
    Python number (``1.0 + t2 * k1``, the Taylor branches); with the extra
    axis no dual value is 0-dim, so the result keeps ``x``'s dtype."""
    return torch.func.jacfwd(lambda e: fn(e[None])[0])(x)


def eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def skew(w: torch.Tensor) -> torch.Tensor:
    """Hat operator: ``[..., 3] -> [..., 3, 3]``."""
    z = torch.zeros_like(w[..., 0])
    row0 = torch.stack([z, -w[..., 2], w[..., 1]], dim=-1)
    row1 = torch.stack([w[..., 2], z, -w[..., 0]], dim=-1)
    row2 = torch.stack([-w[..., 1], w[..., 0], z], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _safe_norm(w):
    return torch.sqrt(torch.clamp(torch.sum(w * w, dim=-1), min=1e-36))


def _sinc(theta):
    t2 = theta * theta
    small = 1.0 - t2 / 6.0 + t2 * t2 / 120.0
    tiny = torch.abs(theta) < _SMALL
    safe = torch.where(tiny, torch.ones_like(theta), theta)
    return torch.where(tiny, small, torch.sin(safe) / safe)


def _one_minus_cos_over_t2(theta):
    t2 = theta * theta
    small = 0.5 - t2 / 24.0 + t2 * t2 / 720.0
    tiny = t2 < _SMALL * _SMALL
    safe2 = torch.where(tiny, torch.ones_like(t2), t2)
    return torch.where(tiny, small, (1.0 - torch.cos(theta)) / safe2)


def _theta_minus_sin_over_t3(theta):
    t2 = theta * theta
    small = 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0
    tiny = t2 < _SMALL * _SMALL
    safe3 = torch.where(tiny, torch.ones_like(t2), t2 * theta)
    return torch.where(tiny, small, (theta - torch.sin(theta)) / safe3)


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential ``[..., 3] -> [..., 3, 3]``."""
    theta = _safe_norm(w)
    W = skew(w)
    A = _sinc(theta)[..., None, None]
    B = _one_minus_cos_over_t2(theta)[..., None, None]
    return eye3(w) + A * W + B * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm ``[..., 3, 3] -> [..., 3]``, robust near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    v = vee(R - R.transpose(-1, -2)) * 0.5
    sv2 = torch.sum(v * v, dim=-1)
    sv = torch.sqrt(torch.clamp(sv2, min=1e-36))

    near_zero = c > 1.0 - 1e-10
    near_pi = c < -1.0 + 1e-7

    sv_safe = torch.where(near_zero | near_pi, torch.ones_like(sv), sv)
    theta_general = torch.atan2(sv_safe, c)
    w_general = v * (theta_general / sv_safe)[..., None]

    w_small = v * (1.0 + sv2 / 6.0 + 0.3 * sv2 * sv2)[..., None]

    S = R + eye3(R)
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    idx = k[..., None, None].expand(*S.shape[:-1], 1)
    col = torch.gather(S, -1, idx)[..., 0]
    col_norm = torch.linalg.norm(col, dim=-1, keepdim=True)
    axis = col / torch.clamp(col_norm, min=1e-30)
    sv_pi = torch.where(near_pi, torch.clamp(sv, max=1.0), torch.zeros_like(sv))
    theta_pi = math.pi - torch.asin(sv_pi)
    sign = 1.0 - 2.0 * (torch.sum(axis * v, dim=-1, keepdim=True) < 0.0).to(R.dtype)
    w_pi = axis * sign * theta_pi[..., None]

    return torch.where(
        near_zero[..., None], w_small, torch.where(near_pi[..., None], w_pi, w_general)
    )


def so3_project(R: torch.Tensor) -> torch.Tensor:
    """One Newton re-orthogonalisation step ``R (3I - R^T R) / 2``.

    Matrix products accumulate non-orthogonality at machine epsilon per
    composition, and through the camera-offset conjugation feedback the error
    grows geometrically; the filter projects after every group composition.
    """
    RtR = R.transpose(-1, -2) @ R
    return R @ (1.5 * eye3(R) - 0.5 * RtR)


def so3_from_vectors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotation taking the direction of ``a`` to that of ``b``."""
    an = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True), min=1e-30)
    bn = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=1e-30)
    v = cross(an, bn)
    c = torch.sum(an * bn, dim=-1)
    V = skew(v)
    denom = torch.clamp(1.0 + c, min=1e-12)[..., None, None]
    R_general = eye3(a) + V + (V @ V) / denom

    ex = const((1.0, 0.0, 0.0), a.dtype, a.device)
    ey = const((0.0, 1.0, 0.0), a.dtype, a.device)
    helper = torch.where((torch.abs(an[..., 0]) < 0.9)[..., None], ex, ey)
    ortho = cross(an, helper)
    ortho = ortho / torch.clamp(torch.linalg.norm(ortho, dim=-1, keepdim=True), min=1e-30)
    R_pi = so3_exp(math.pi * ortho)

    antiparallel = (c < -1.0 + 1e-9)[..., None, None]
    return torch.where(antiparallel, R_pi, R_general)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


class SE3(NamedTuple):
    R: torch.Tensor  # [..., 3, 3]
    x: torch.Tensor  # [..., 3]

    @property
    def batch_shape(self) -> torch.Size:
        return self.x.shape[:-1]


def se3_identity(dtype: torch.dtype, device, batch_shape=()) -> SE3:
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone()
    return SE3(R, torch.zeros(*batch_shape, 3, dtype=dtype, device=device))


def se3_mul(a: SE3, b: SE3) -> SE3:
    return SE3(a.R @ b.R, mv(a.R, b.x) + a.x)


def se3_inv(a: SE3) -> SE3:
    Rt = a.R.transpose(-1, -2)
    return SE3(Rt, -mv(Rt, a.x))


def se3_apply(a: SE3, p: torch.Tensor) -> torch.Tensor:
    return mv(a.R, p) + a.x


def _left_jacobian(w: torch.Tensor) -> torch.Tensor:
    theta = _safe_norm(w)
    W = skew(w)
    B = _one_minus_cos_over_t2(theta)[..., None, None]
    C = _theta_minus_sin_over_t3(theta)[..., None, None]
    return eye3(w) + B * W + C * (W @ W)


def _left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    theta = _safe_norm(w)
    W = skew(w)
    t2 = theta * theta
    small = 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0
    s = torch.sin(theta)
    safe = torch.abs(s * theta) > _SMALL * _SMALL
    denom_t2 = torch.where(t2 > 0, t2, torch.ones_like(t2))
    denom_st = torch.where(safe, 2.0 * theta * s, torch.ones_like(s))
    general = 1.0 / denom_t2 - (1.0 + torch.cos(theta)) / denom_st
    D = torch.where(safe, general, small)[..., None, None]
    return eye3(w) - 0.5 * W + D * (W @ W)


def se3_exp(u: torch.Tensor) -> SE3:
    """Exponential of ``u = (w, v) [..., 6]`` (angular first)."""
    w, v = u[..., 0:3], u[..., 3:6]
    return SE3(so3_exp(w), mv(_left_jacobian(w), v))


def se3_log(a: SE3) -> torch.Tensor:
    w = so3_log(a.R)
    return torch.cat([w, mv(_left_jacobian_inv(w), a.x)], dim=-1)


def se3_Adjoint(a: SE3) -> torch.Tensor:
    """Big Adjoint ``[..., 6, 6]`` for u = (w, v)."""
    top = torch.cat([a.R, torch.zeros_like(a.R)], dim=-1)
    bottom = torch.cat([skew(a.x) @ a.R, a.R], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_adjoint(u: torch.Tensor) -> torch.Tensor:
    """Little adjoint ``ad_u [..., 6, 6]``."""
    W = skew(u[..., 0:3])
    V = skew(u[..., 3:6])
    top = torch.cat([W, torch.zeros_like(W)], dim=-1)
    bottom = torch.cat([V, W], dim=-1)
    return torch.cat([top, bottom], dim=-2)


# ---------------------------------------------------------------------------
# SOT(3)
# ---------------------------------------------------------------------------


class SOT3(NamedTuple):
    R: torch.Tensor  # [..., 3, 3]
    a: torch.Tensor  # [...]


def sot3_identity(dtype: torch.dtype, device, batch_shape=()) -> SOT3:
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone()
    return SOT3(R, torch.ones(batch_shape, dtype=dtype, device=device))


def sot3_mul(p: SOT3, q: SOT3) -> SOT3:
    return SOT3(p.R @ q.R, p.a * q.a)


def sot3_inv(p: SOT3) -> SOT3:
    return SOT3(p.R.transpose(-1, -2), 1.0 / p.a)


def sot3_apply(p: SOT3, x: torch.Tensor) -> torch.Tensor:
    return p.a[..., None] * mv(p.R, x)


def sot3_exp(u: torch.Tensor) -> SOT3:
    return SOT3(so3_exp(u[..., 0:3]), torch.exp(u[..., 3]))


def sot3_log(p: SOT3) -> torch.Tensor:
    return torch.cat([so3_log(p.R), torch.log(p.a)[..., None]], dim=-1)


def sot3_Adjoint_inv_of(p: SOT3) -> torch.Tensor:
    """Adjoint of p^{-1} as a ``[..., 4, 4]`` matrix: blockdiag(R^T, 1)."""
    out = p.R.new_zeros(p.R.shape[:-2] + (4, 4))
    out[..., 0:3, 0:3] = p.R.transpose(-1, -2)
    out[..., 3, 3] = 1.0
    return out


# ---------------------------------------------------------------------------
# SE_2(3)
# ---------------------------------------------------------------------------


class SE23(NamedTuple):
    R: torch.Tensor
    x1: torch.Tensor
    x2: torch.Tensor


def se23_exp(u: torch.Tensor) -> SE23:
    w = u[..., 0:3]
    V = _left_jacobian(w)
    return SE23(so3_exp(w), mv(V, u[..., 3:6]), mv(V, u[..., 6:9]))


def se23_log(g: SE23) -> torch.Tensor:
    w = so3_log(g.R)
    Vi = _left_jacobian_inv(w)
    return torch.cat([w, mv(Vi, g.x1), mv(Vi, g.x2)], dim=-1)
