"""A plain reference of the per-IMU-sample propagation of EqVIO's default
filter: the matrix-exponential Riccati step and the discrete velocity lift,
sample by sample, in float64 with dense covariance.

    X, Sigma = propagate(X, xi0, Sigma, samples, q, p, suite)

``samples`` are the live IMU samples only, ``(IMU, dt)`` with ``dt > 0``: no
pad entries and no masks.  The state matrix ``A`` and the input matrix ``B``
come from the frozen coordinate suite (:mod:`benchmark.frozen.matrices`),
the lift and the group product from :mod:`benchmark.frozen.group`; the rest
is written out here.  For each sample:

* ``[[A_exp, B_exp], [0, I]] = matrix_exp([[A dt, B dt], [0, 0]])``, by
  ``torch.linalg.matrix_exp``;
* ``Sigma <- A_exp Sigma A_exp^T + B_exp diag(q / dt) B_exp^T + dt diag(p)``,
  as the program's ``integrate_riccati_accurate`` states it;
* ``X <- X lift(phi_X(xi0), imu, dt)``, the discrete velocity lift, then
  normalised.

Where it departs from the upstream's ``RiccatiAccurate``
(``VIO_eqf.cpp:74-91``, SURVEY.md):

* the exponential is ``torch.linalg.matrix_exp``, not Eigen's
  ``MatrixFunctions`` (or the program's own Pade ``expm``);
* every landmark slot is active: there is no row or column deletion, and no
  masking or resetting of inactive slots, which the program does;
* the covariance is left as the formula gives it, not symmetrised;
* it runs in float64 with TF32 off, whatever the caller's dtype.

It imports nothing of the program and no JAX.
"""

from __future__ import annotations

import torch

from .frozen.group import group_mul, group_normalize, lift_velocity_discrete, state_action


def riccati_step(Sigma: torch.Tensor, A: torch.Tensor, B: torch.Tensor, dt: float, q: torch.Tensor,
                 p: torch.Tensor) -> torch.Tensor:
    """One live sample's covariance: ``Sigma [D, D]``, ``A [D, D]``,
    ``B [D, 12]``, the input gains ``q [12]`` and the state gains ``p [D]``."""
    D, m = A.shape[0], B.shape[1]
    M = torch.zeros(D + m, D + m, dtype=torch.float64)
    M[:D, :D] = A * dt
    M[:D, D:] = B * dt
    E = torch.linalg.matrix_exp(M)
    A_exp, B_exp = E[:D, :D], E[:D, D:]
    return A_exp @ Sigma @ A_exp.T + B_exp @ torch.diag(q / dt) @ B_exp.T + dt * torch.diag(p)


def propagate(X, xi0, Sigma: torch.Tensor, samples, q: torch.Tensor, p: torch.Tensor, suite):
    """``(X, Sigma)`` after the live ``samples`` (``[(IMU, dt)]``), each a
    Riccati step at the observer it starts from, then the observer moved by
    the discrete lift.  Every tensor is taken in float64."""
    f64 = lambda t: t.to(torch.float64) if t.is_floating_point() else t  # noqa: E731
    X, xi0 = _tree(X, f64), _tree(xi0, f64)
    Sigma, q, p = f64(Sigma), f64(q), f64(p)
    keep = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for imu, dt in samples:
            imu, dt = _tree(imu, f64), float(dt)
            Sigma = riccati_step(Sigma, suite.state_matrix_A(X, xi0, imu), suite.input_matrix_B(X, xi0), dt, q, p)
            X = group_normalize(group_mul(X, lift_velocity_discrete(state_action(X, xi0), imu, dt)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = keep
    return X, Sigma


def _tree(obj, f):
    if isinstance(obj, torch.Tensor):
        return f(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_tree(v, f) for v in obj))
    return obj
