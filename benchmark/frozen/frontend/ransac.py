"""Batched fundamental-matrix RANSAC gate (counterpart of
``eqvio_tpu/frontend/ransac.py``).

All K hypotheses are solved at once: K minimal samples of 8 tracks from one
stable sort of threefry uniforms, the normalised 8-point nullspace by
unrolled-Cholesky inverse iteration (no eigendecomposition library call, so
the two packages run the same arithmetic), rank-2 projection, a batched
Sampson score, an MSAC pick and one LO refit.
"""

from __future__ import annotations

import math

import torch

from ..runtime import const
from .prng import uniform


def _norm(v: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=dim, keepdim=keepdim))


def _normalize(pts: torch.Tensor, mask: torch.Tensor):
    """Masked Hartley normalisation; returns points and the isotropic scale."""
    w = mask.to(pts.dtype)
    n = torch.clamp(torch.sum(w), min=1.0)
    c = torch.sum(pts * w[:, None], dim=0) / n
    d = _norm(pts - c)
    mean_d = torch.clamp(torch.sum(d * w) / n, min=1e-9)
    s = const(math.sqrt(2.0), pts.dtype, pts.device) / mean_d
    return (pts - c) * s, s


def _constraint_rows(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = torch.ones_like(x1)
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], dim=-1)


def _cholesky_small(G: torch.Tensor) -> list:
    """Unrolled lower Cholesky of a tiny batched SPD ``[..., n, n]`` as a
    list of lists of batched scalars, in the reference's operation order."""
    n = G.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = G[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def _chol_solve_small(L: list, b: torch.Tensor) -> torch.Tensor:
    """Solve ``L L^T x = b`` with the unrolled factor; ``b: [..., n]``."""
    n = len(L)
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def smallest_eigvec(G: torch.Tensor, iters: int = 6) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of a tiny batched PSD
    ``G [..., n, n]`` by regularised inverse iteration.

    Mirrors the reference exactly, including its behaviour when the two
    smallest eigenvalues are nearly degenerate (then it returns a vector in
    their span, not ``eigh``'s eigenvector).
    """
    n = G.shape[-1]
    tr = torch.diagonal(G, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    eye = torch.eye(n, dtype=G.dtype, device=G.device)
    L = _cholesky_small(G + (1e-7 * tr + 1e-30) * eye)
    v = (1.0 + 0.01 * torch.arange(n, dtype=G.dtype, device=G.device)).expand(G.shape[:-1])
    for _ in range(iters):
        v = _chol_solve_small(L, v)
        v = v / torch.clamp(_norm(v, keepdim=True), min=1e-30)
    return v


def _rank2(F: torch.Tensor) -> torch.Tensor:
    """Rank-2 projection of ``F [K, 3, 3]`` by removing its smallest singular triplet."""
    v3 = smallest_eigvec(torch.einsum("kij,kil->kjl", F, F))
    u3 = smallest_eigvec(torch.einsum("kij,klj->kil", F, F))
    s3 = torch.einsum("ki,kij,kj->k", u3, F, v3)
    return F - s3[:, None, None] * u3[:, :, None] * v3[:, None, :]


def _eight_point(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Batched 8-point fundamental matrices from ``[K, 8, 2]`` correspondences."""
    A = _constraint_rows(p1, p2)
    G = torch.einsum("kri,krj->kij", A, A)
    return _rank2(smallest_eigvec(G).reshape(-1, 3, 3))


def _sampson(F: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Squared Sampson distance ``[K, N]`` of every correspondence under every hypothesis."""
    ones = torch.ones(p1.shape[0], 1, dtype=p1.dtype, device=p1.device)
    x1 = torch.cat([p1, ones], dim=-1)
    x2 = torch.cat([p2, ones], dim=-1)
    Fx1 = torch.einsum("kij,nj->kni", F, x1)
    Ftx2 = torch.einsum("kji,nj->kni", F, x2)
    num = torch.square(torch.einsum("ni,kni->kn", x2, Fx1))
    den = (
        torch.square(Fx1[..., 0])
        + torch.square(Fx1[..., 1])
        + torch.square(Ftx2[..., 0])
        + torch.square(Ftx2[..., 1])
    )
    return num / torch.clamp(den, min=1e-12)


def ransac_epipolar_mask(
    prev: torch.Tensor,
    curr: torch.Tensor,
    mask: torch.Tensor,
    key: torch.Tensor,
    threshold: float = 1.0,
    hypotheses: int = 64,
    min_points: int = 8,
    min_inliers: int = 8,
) -> torch.Tensor:
    """Refine ``mask [N]`` by epipolar-consistency RANSAC between ``prev`` and
    ``curr`` ``[N, 2]`` pixel positions; ``key`` is a threefry key (see
    :mod:`.prng`) and ``threshold`` a Sampson distance in pixels.  Leaves the
    mask unchanged when fewer than ``max(min_points, 8)`` tracks survive or
    the refined consensus is below ``min_inliers``."""
    N = prev.shape[0]
    n_tracked = torch.sum(mask)
    p1n, s1 = _normalize(prev, mask)
    p2n, s2 = _normalize(curr, mask)

    # K samples of 8 distinct tracked slots: ascending stable sort of the
    # draws with masked slots at +inf (ties to the lower index, as top_k)
    scores = uniform(key, (hypotheses, N))
    scores = torch.where(mask[None, :], scores, torch.full_like(scores, float("inf")))
    idx = torch.argsort(scores, dim=1, stable=True)[:, :8]
    F = _eight_point(p1n[idx], p2n[idx])

    d2 = _sampson(F, p1n, p2n)
    thr2 = threshold**2 * s1 * s2
    rho = torch.where(mask[None, :], torch.minimum(d2, thr2), torch.zeros_like(d2))
    best = torch.argmax(-torch.sum(rho, dim=-1))

    w = ((d2.index_select(0, best.reshape(1))[0] < thr2) & mask).to(p1n.dtype)
    A_all = _constraint_rows(p1n, p2n)
    G2 = torch.einsum("ni,nj->ij", A_all * w[:, None], A_all)
    F_lo = _rank2(smallest_eigvec(G2[None]).reshape(1, 3, 3))
    refined = (_sampson(F_lo, p1n, p2n)[0] < thr2) & mask

    usable = (n_tracked >= max(int(min_points), 8)) & (torch.sum(refined) >= min_inliers)
    return torch.where(usable, refined, mask)
