"""Operations and bytes of one step: the counterpart of XLA's ``cost_analysis``.

The JAX package reads ``flops`` and ``bytes accessed`` from XLA's cost
analysis of its compiled programs (``eqvio_tpu/app/run_opt.py:871-885``,
``eqvio_tpu/runner.py:383-421``).  PyTorch has no compiled program to ask,
so :func:`count` runs the step once, eagerly, under a
``TorchDispatchMode`` and adds up what each ATen op the step issues does:

- operations: the matrix products and convolutions by
  ``torch.utils.flop_counter``'s formulas (``mm``, ``bmm``, ``addmm``,
  ``convolution``, ...) and ``2 m n`` for ``mv``; one per output element
  of an elementwise op (``torch.Tag.pointwise``) and one per input element
  of a reduction; the QR, Cholesky, LU and triangular solves by their
  textbook counts; ``max_pool2d`` one comparison per window element; the
  KLT op (``eqvio_tpu_torch::klt_track_pyramid``) by
  :func:`kernels.klt.klt_work` and the RANSAC gate's op
  (``eqvio_tpu_torch::ransac_epipolar_mask``) by
  :func:`kernels.ransac.ransac_work`, the count of its plain version;
  copies, views, indexing, sorts and the clock stamps
  (``eqvio_tpu_torch::frame_stamp``) none.
- bytes: every op's input and output tensors, each read or written once
  (XLA's "bytes accessed"); views and stamps move none, and a broadcast (stride-0)
  dim is counted once.  On the card each op is a kernel of its own, in the
  graph too, so this is the traffic those kernels do.

Under ``torch.func.vmap`` the mode sees the batched ops, so a B-lane step
counts the B-lane work.
"""

from __future__ import annotations

import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

_REDUCTIONS = {"sum", "mean", "prod", "amax", "amin", "max", "min", "argmax", "argmin", "any", "all",
               "linalg_vector_norm", "norm", "var", "std", "var_mean", "std_mean", "logsumexp", "cumsum",
               "cumprod", "aminmax"}
# allocations, and views whose schema does not say so: no kernel, no traffic; and
# the frame step's clock stamps (kernels/stamp.py), which measure the step and are no part of its work
_NO_BYTES = {"empty", "empty_like", "new_empty", "empty_strided", "new_empty_strided", "_unsafe_view", "lift_fresh",
             "frame_stamp"}


def _numel(t: torch.Tensor) -> int:
    """Elements a tensor holds in memory: a broadcast (stride-0) dim once."""
    return math.prod(s for s, st in zip(t.shape, t.stride()) if st != 0) if t.numel() else 0


def _nbytes(t: torch.Tensor) -> int:
    return _numel(t) * t.element_size()


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write for r in func._schema.returns)


def _qr_flops(a: torch.Tensor, mode: str) -> float:
    """Householder QR of ``[..., m, n]``: ``2 n^2 (m - n / 3)`` for R, as
    many again for the thin Q, ``4 (m^2 n - m n^2 + n^3 / 3)`` for the full one."""
    m, n = a.shape[-2:]
    k = min(m, n)
    batch = a.numel() // max(m * n, 1)
    r = 2.0 * k * k * (max(m, n) - k / 3.0)
    q = {"r": 0.0, "reduced": r, "complete": 4.0 * (m * m * n - m * n * n + n**3 / 3.0)}[mode]
    return batch * (r + q)


def _solve_flops(a: torch.Tensor, b: torch.Tensor, per_rhs: float) -> float:
    """``per_rhs`` x n^2 operations for each right-hand side column of ``b``
    against the n x n factor ``a`` (batched)."""
    n = a.shape[-1]
    return per_rhs * n * n * (b.numel() / n)


def op_flops(func, args, kwargs, out) -> float:
    """Operations of one ATen op call (see the module docstring)."""
    packet = func.overloadpacket
    name = packet.__name__
    if packet in flop_registry:
        return float(flop_registry[packet](*args, **kwargs, out_val=out))
    if name == "klt_track_pyramid":
        from .kernels.klt import klt_work  # a step without the KLT (the simulation's) loads no kernel module

        pyr, positions, win, iters = args[0], args[2], args[4], args[5]
        shapes = [tuple(t.shape[-2:]) for t in pyr]
        lanes = math.prod(positions.shape[:-2])
        return float(klt_work(positions.shape[-2], shapes, win, iters, lanes)[1])
    if name == "ransac_epipolar_mask":
        from .kernels.ransac import ransac_work

        prev, hypotheses = args[0], args[6]
        return float(ransac_work(hypotheses, prev.shape[-2], math.prod(prev.shape[:-2]))[1])
    if name in ("mv", "addmv"):
        mat = args[1] if name == "addmv" else args[0]
        return 2.0 * mat.numel()
    if name == "dot":
        return 2.0 * args[0].numel()
    if name == "linalg_qr":
        return _qr_flops(args[0], args[1] if len(args) > 1 else kwargs.get("mode", "reduced"))
    if name in ("linalg_cholesky_ex", "cholesky"):
        n = args[0].shape[-1]
        return args[0].numel() / (n * n) * n**3 / 3.0
    if name in ("linalg_solve_triangular", "triangular_solve"):
        a, b = (args[0], args[1]) if name == "linalg_solve_triangular" else (args[1], args[0])
        return _solve_flops(a, b, 1.0)
    if name == "cholesky_solve":
        return _solve_flops(args[1], args[0], 2.0)
    if name in ("_linalg_solve_ex", "linalg_solve_ex", "linalg_solve"):
        a, b = args[0], args[1]
        n = a.shape[-1]
        return a.numel() / (n * n) * 2.0 * n**3 / 3.0 + _solve_flops(a, b, 2.0)
    if name in ("linalg_lu_factor_ex", "linalg_lu"):
        n = args[0].shape[-1]
        return args[0].numel() / (n * n) * 2.0 * n**3 / 3.0
    if name == "linalg_inv_ex":
        n = args[0].shape[-1]
        return args[0].numel() / (n * n) * 2.0 * n**3
    if name in ("max_pool2d_with_indices", "max_pool2d"):
        kernel = args[1]
        return float(_tensors(out)[0].numel() * math.prod(kernel if len(kernel) == 2 else (kernel[0], kernel[0])))
    if name in ("scatter_add", "scatter_add_", "index_add", "index_add_"):
        return float(_tensors(args)[-1].numel())
    if name in ("index_put", "index_put_") and (args[3] if len(args) > 3 else kwargs.get("accumulate", False)):
        return float(args[2].numel())
    reduction = getattr(torch.Tag, "reduction", None)
    if name in _REDUCTIONS or (reduction is not None and reduction in func.tags):
        return float(_tensors(args)[0].numel())
    if torch.Tag.pointwise in func.tags:
        return float(sum(t.numel() for t in _tensors(out)))
    return 0.0


def op_bytes(func, args, kwargs, out) -> int:
    """Bytes one ATen op call reads and writes: each input and output once."""
    name = func.overloadpacket.__name__
    if _is_view(func) or name in _NO_BYTES:
        return 0
    return sum(_nbytes(t) for t in _tensors((args, kwargs))) + sum(_nbytes(t) for t in _tensors(out))


class CostMode(TorchDispatchMode):
    """Adds up :func:`op_flops` and :func:`op_bytes` of every op it sees."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.flops += op_flops(func, args, kwargs, out)
        self.bytes += op_bytes(func, args, kwargs, out)
        self.ops += 1
        return out


def count(fn, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once under :class:`CostMode`; returns
    ``{"flops", "bytes accessed", "ops"}`` (the first two under XLA's key
    names; ``ops`` is the number of ATen op calls).  The caller runs it
    outside any CUDA graph capture, on inputs the step may consume."""
    with CostMode() as mode:
        fn(*args, **kwargs)
    return {"flops": mode.flops, "bytes accessed": float(mode.bytes), "ops": mode.ops}
