"""The EqF vision update with its landmark blocks split over ranks
(counterpart of ``eqvio_tpu/parallel/landmark_shard.py``).

The state is replicated on every rank of the mesh axis; each rank owns the
contiguous block of ``n_loc = N / n`` landmark slots that
``NamedSharding`` would give it, and the collectives are
``torch.distributed``'s over the axis's group (``mesh.get_group(axis)``),
so the axis may be one dimension of a 2-D ``{"seq", "lm"}`` mesh:

- dense: each rank forms its block-columns of ``Sigma C^T`` ``[D, 2 n_loc]``
  and of ``S = C Sigma C^T`` ``[2N, 2 n_loc]``; the columns are gathered,
  every rank factors ``S`` and solves for the gain ``K``, and the
  correction ``K Sigma C^T ^T`` is the sum over ranks of each rank's
  columns of ``K`` times its block of ``Sigma C^T`` (``all_reduce``);
- square root: each rank forms its block-rows of the pre-array's ``C L``
  ``[2 n_loc, D]``; the rows are gathered and every rank runs the Kailath
  QR (``filter.tria``) on the whole pre-array.

Design note: the QR stays replicated.  A QR is a long chain of dependent
Householder reflections that couple every column; at the pre-array's
near-square shape a split into row blocks (TSQR) merges a problem as large
as the one it started from, and ``C`` has no block structure to exploit,
since every landmark couples to the sensor block.  What scales with the map
is distributed: the ``C L`` product, the Gram reduction ``C Sigma C^T`` and
the correction; the sequence batch is the other axis
(``runner.build_sim_runner(mesh=...)``).  At very large N the O(N^3) QR
bounds any covariance-form filter alike (the dense path's Cholesky has the
same exponent); scaling past that would need an information-form redesign
that gives up the constant-time frame update.  The dry run
(``parallel/dryrun.py``) holds this path to the local update at capacity
256 (a 1,301 x 1,301 pre-array).  For the capacities of real sequences
(N <= 128) one device does the whole update faster.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from .. import filter as F
from ..states import SENSOR_DIM
from .mesh import all_gather, block


def sharded_vision_update(mesh, settings: F.Settings, camera, axis: str = "lm"):
    """``update(state, pixels, vis) -> state``: :func:`filter.update_vision`
    with the Gram reduction and the correction (dense) or the ``C L``
    product (square root) split over the ranks of mesh axis ``axis``.

    Every rank of the axis calls ``update`` with the same state and gets the
    same result.  A capacity that the axis does not divide raises
    ``ValueError``.
    """
    suite = settings.suite
    group = mesh.get_group(axis)

    def update(state: F.EqFState, pixels: torch.Tensor, vis_mask: torch.Tensor) -> F.EqFState:
        xi0, Sigma = state.xi0, state.Sigma
        N, D = xi0.capacity, xi0.dim()
        mine = block(N, mesh, axis)  # raises unless the axis divides N
        n_loc = mine.stop - mine.start
        C, resid, r_diag = F.output_terms(state, pixels, vis_mask, camera, settings, suite)
        C_my = C[mine]

        if settings.sqrt_covariance:
            L_my = Sigma[SENSOR_DIM:].reshape(N, 3, D)[mine]
            CL_part = torch.einsum("iax,ixd->iad", C_my, L_my).reshape(2 * n_loc, D)
            Gamma, Sigma_new = F.kailath_update(r_diag, all_gather(CL_part, group, dim=0), Sigma, resid)
        else:
            Sig_my = Sigma[:, SENSOR_DIM:].reshape(D, N, 3)[:, mine]
            SigCt_part = torch.einsum("djy,jby->djb", Sig_my, C_my)  # [D, n_loc, 2]
            S_cols = torch.einsum("iax,ixb->iab", C, SigCt_part[SENSOR_DIM:].reshape(N, 3, 2 * n_loc))
            S = all_gather(S_cols.reshape(2 * N, 2 * n_loc), group, dim=1) + torch.diag(r_diag)
            SigCt_part = SigCt_part.reshape(D, 2 * n_loc)
            K = F.kalman_gain(S, all_gather(SigCt_part, group, dim=1))
            Gamma = K @ resid.reshape(-1)
            M = K[:, 2 * mine.start:2 * mine.stop] @ SigCt_part.T
            dist.all_reduce(M, group=group)  # the sum over the ranks' blocks, the same on every rank
            Sigma_new = Sigma - M
            Sigma_new = 0.5 * (Sigma_new + Sigma_new.T)

        X_new = F.innovate(state.X, Gamma, xi0, settings, suite)
        return state._replace(X=X_new, Sigma=F.sanitize_sigma(Sigma_new, xi0, settings))

    return update
