"""Inputs and the near-tie rule for holding the RANSAC gate kernel to its
plain version on the card.

:func:`gate_inputs` records the gate's inputs frame by frame as the tracker
of a configuration hands them over on a scene; ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` hold the kernel to the plain version on them.  The
two round every operation alike but sum in other orders, so a mask may
differ only at a near tie, which :func:`near_tie` names from the plain
version's intermediates (:func:`gate_parts`).  :func:`kernel_mirror`
repeats the kernel's arithmetic in numpy float32, operation by operation
and in the kernel's order, so the kernel can be held to it bit for bit.
:func:`two_view` is a scene with a real consensus.  Nothing here runs at
import.
"""

from __future__ import annotations

import contextlib
import types
from typing import NamedTuple

import numpy as np
import torch

from ..frontend import prng, tracker
from ..frontend import ransac as P
from ..io import tracker_config_from_config
from . import ransac as RK

PICK_TIE = 1e-5  # relative margin of the best hypothesis's truncated cost over the next
SAMPSON_TIE = 1e-4  # relative distance of a Sampson distance to the threshold


class GateInput(NamedTuple):
    prev: torch.Tensor  # [N, 2]
    curr: torch.Tensor  # [N, 2]
    mask: torch.Tensor  # [N]
    key: torch.Tensor  # [2], before the fold
    next_id: torch.Tensor  # []


def two_view(seed: int, n: int = 30, n_out: int = 5):
    """A two-view scene with a real consensus: ``n`` points 4-8 m out seen
    by a 300 px camera before and after a small motion, 0.2 px of noise,
    the first ``n_out`` moved by up to 15 px (outliers) and the last three
    untracked; ``(prev, curr, mask)`` as numpy float32 / bool."""
    rng = np.random.default_rng(seed)
    P3 = rng.uniform([-2, -1.5, 4], [2, 1.5, 8], size=(n, 3))
    f, c = 300.0, np.array([160.0, 120.0])
    prev = P3[:, :2] / P3[:, 2:] * f + c
    R = np.array([[np.cos(0.05), 0, np.sin(0.05)], [0, 1, 0], [-np.sin(0.05), 0, np.cos(0.05)]])
    P2 = P3 @ R.T + [0.2, 0.05, 0.1]
    curr = P2[:, :2] / P2[:, 2:] * f + c + rng.normal(scale=0.2, size=(n, 2))
    curr[:n_out] += rng.uniform(-15, 15, size=(n_out, 2))
    mask = np.ones(n, bool)
    mask[-3:] = False
    return prev.astype(np.float32), curr.astype(np.float32), mask


@contextlib.contextmanager
def _recording(calls: list):
    """The tracker's gate calls append their inputs and arguments to
    ``calls`` (the tracker's reference to the kernel module is swapped for
    one whose ``ransac_mask`` records, then calls the op)."""
    def record(prev, curr, mask, key, next_id, **kw):
        calls.append((GateInput(prev.clone(), curr.clone(), mask.clone(), key.clone(), next_id.clone()), kw))
        return RK.ransac_mask(prev, curr, mask, key, next_id, **kw)

    real = tracker.ransac_kernel
    tracker.ransac_kernel = types.SimpleNamespace(ransac_mask=record)
    try:
        yield calls
    finally:
        tracker.ransac_kernel = real


def gate_inputs(reader, config: dict, frames: int, device) -> tuple[list[GateInput], dict]:
    """The gate's inputs at each of the first ``frames`` frames of
    ``reader``, tracked eagerly on ``device`` by ``config``'s tracker (its
    gate on), and the gate's keyword arguments (threshold, hypotheses,
    min_inliers)."""
    tcfg = tracker_config_from_config(config)
    if tcfg.ransac_inlier_threshold <= 0:
        raise ValueError("the configuration's RANSAC gate is off")
    image = reader.load_image_u8(0)
    state = tracker.tracker_init(tcfg, image.shape, device)
    calls: list = []
    with _recording(calls):
        for i in range(frames):
            img = torch.tensor(reader.load_image_u8(i), device=device).float() * (1.0 / 255.0)
            state = tracker.tracker_step(state, img, tcfg)
    return [c for c, _ in calls], calls[0][1]


def gate_parts(g: GateInput, threshold: float, hypotheses: int) -> dict:
    """The plain gate's intermediates, step by step as
    :func:`frontend.ransac.ransac_epipolar_mask` computes them: the
    truncated costs, the best hypothesis, ``thr2``, the best hypothesis's
    and the refit's Sampson distances and the refined mask."""
    mask = g.mask
    p1n, s1 = P._normalize(g.prev, mask)
    p2n, s2 = P._normalize(g.curr, mask)
    scores = prng.uniform(prng.fold_in(g.key, g.next_id), (hypotheses, mask.shape[0]))
    scores = torch.where(mask[None, :], scores, torch.full_like(scores, float("inf")))
    idx = torch.argsort(scores, dim=1, stable=True)[:, :8]
    d2 = P._sampson(P._eight_point(p1n[idx], p2n[idx]), p1n, p2n)
    thr2 = threshold**2 * s1 * s2
    cost = torch.where(mask[None, :], torch.minimum(d2, thr2), torch.zeros_like(d2)).sum(-1)
    best = int(torch.argmax(-cost))
    w = ((d2[best] < thr2) & mask).to(p1n.dtype)
    A = P._constraint_rows(p1n, p2n)
    F_lo = P._rank2(P.smallest_eigvec((torch.einsum("ni,nj->ij", A * w[:, None], A))[None]).reshape(1, 3, 3))
    d2_lo = P._sampson(F_lo, p1n, p2n)[0]
    return {"cost": cost, "best": best, "thr2": thr2, "d2_best": d2[best], "d2_lo": d2_lo,
            "refined": (d2_lo < thr2) & mask}


def _nudged(t: torch.Tensor, trials: int, gen: torch.Generator) -> torch.Tensor:
    """``trials`` copies of ``t``, every element moved by -1, 0 or +1 ulp at random."""
    t = t.expand(trials, *t.shape)
    step = torch.randint(-1, 2, t.shape, generator=gen).to(t.device)
    inf = torch.full_like(t, float("inf"))
    return torch.where(step > 0, torch.nextafter(t, inf), torch.where(step < 0, torch.nextafter(t, -inf), t))


def near_tie(got: torch.Tensor, g: GateInput, threshold: float, hypotheses: int, min_inliers: int,
             trials: int = 128) -> str | None:
    """Why the kernel's mask ``got`` may differ from the plain version's on
    ``g`` (on the card), the first that holds of:

    - ``"pick"``: the best hypothesis's truncated cost lies within
      :data:`PICK_TIE` of the next one's, relative;
    - ``"weights"``: a tracked slot's Sampson distance under the best
      hypothesis lies within :data:`SAMPSON_TIE` of ``thr2``, relative, so
      the refit's weights may flip;
    - ``"sampson"``: ``got`` is a refit result, or the mask left as it is
      below ``min_inliers``, that the plain version's refined mask reaches
      by flipping only slots whose refit Sampson distance lies within
      :data:`SAMPSON_TIE` of ``thr2``;
    - ``"host"``: the plain version on the host gives another mask than on
      the card (the two sum in other orders);
    - ``"ulp"``: the plain version gives another mask once every input
      coordinate moves by at most one float32 ulp, in one of ``trials``
      random draws (one call under ``torch.func.vmap``): the decision is
      decided by rounding (an ill-conditioned 8-point or refit solve, as a
      near-planar scene gives);

    None where none holds."""
    parts = gate_parts(g, threshold, hypotheses)
    cost, best, thr2 = parts["cost"], parts["best"], parts["thr2"]
    if cost.numel() > 1:
        rest = torch.cat([cost[:best], cost[best + 1:]])
        if float(rest.min() - cost[best]) <= PICK_TIE * max(float(cost[best]), 1e-30):
            return "pick"
    tie = lambda d2: g.mask & ((d2 - thr2).abs() <= SAMPSON_TIE * thr2)  # noqa: E731
    if bool(tie(parts["d2_best"]).any()):
        return "weights"
    fixed = parts["refined"] & ~tie(parts["d2_lo"])  # refined slots no tie can flip
    if not bool(((got ^ parts["refined"]) & ~tie(parts["d2_lo"])).any()) and int(got.sum()) >= min_inliers:
        return "sampson"
    if torch.equal(got, g.mask) and int(fixed.sum()) < min_inliers:
        return "sampson"
    args = (threshold, hypotheses, 8, min_inliers)
    want = RK.ransac_mask_plain(*g, *args)
    if not torch.equal(RK.ransac_mask_plain(*(t.cpu() for t in g), *args), want.cpu()):
        return "host"
    gen = torch.Generator().manual_seed(int(g.next_id))
    nudged = torch.func.vmap(lambda p, c: RK.ransac_mask_plain(p, c, g.mask, g.key, g.next_id, *args))(
        _nudged(g.prev, trials, gen), _nudged(g.curr, trials, gen))
    return "ulp" if bool((nudged != want).any()) else None


# ---------------------------------------------------------------------------
# The kernel's arithmetic in numpy float32 (csrc/ransac_cuda.cu), one lane,
# vectorised over the hypotheses: numpy rounds each float32 operation
# correctly and contracts none, as the kernel's __f*_rn intrinsics do.
# ---------------------------------------------------------------------------

_F = np.float32
_M32 = 0xFFFFFFFF
_THREADS = 256  # RS_THREADS


def _tri(i: int, j: int) -> int:
    return i * (i + 1) // 2 + j


def _threefry(k1: int, k2: int, x1, x2):
    u = np.uint64
    ks = (u(k1), u(k2), u(k1 ^ k2 ^ 0x1BD11BDA))
    x1 = (np.asarray(x1, u) + ks[0]) & u(_M32)
    x2 = (np.asarray(x2, u) + ks[1]) & u(_M32)
    for i in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[i % 2]:
            x1 = (x1 + x2) & u(_M32)
            x2 = (((x2 << u(r)) | (x2 >> u(32 - r))) & u(_M32)) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & u(_M32)
        x2 = (x2 + ks[(i + 2) % 3] + u(i + 1)) & u(_M32)
    return x1, x2


def _block_sum(vals: np.ndarray) -> np.float32:
    """``block_sum``: each thread's strided values in order, an xor
    butterfly in each warp, the warp sums in order."""
    part = np.zeros(_THREADS, _F)
    for t0 in range(0, len(vals), _THREADS):
        chunk = vals[t0:t0 + _THREADS]
        part[:len(chunk)] = part[:len(chunk)] + chunk
    lanes = np.arange(32)
    total = None
    for w in range(_THREADS // 32):
        x = part[32 * w:32 * w + 32]
        for o in (16, 8, 4, 2, 1):
            x = x + x[lanes ^ o]
        total = x[0] if total is None else _F(total + x[0])
    return total


def _normalise(pts: np.ndarray, w: np.ndarray, count: np.float32):
    cx = _F(_block_sum(pts[:, 0] * w) / count)
    cy = _F(_block_sum(pts[:, 1] * w) / count)
    dx, dy = pts[:, 0] - cx, pts[:, 1] - cy
    mean_d = _F(_block_sum(np.sqrt(dx * dx + dy * dy) * w) / count)
    s = _F(_F(1.41421356237309505) / max(mean_d, _F(1e-9)))
    return dx * s, dy * s, s


def _dot(pairs):
    acc = None
    for a, b in pairs:
        acc = a * b if acc is None else acc + a * b
    return acc


def _smallest_eigvec(G: list, n: int) -> list:
    """``smallest_eigvec<n>`` on the packed lower triangle ``G`` (arrays over hypotheses)."""
    G = list(G)
    tr = G[0]
    for i in range(1, n):
        tr = tr + G[_tri(i, i)]
    reg = _F(1e-7) * tr + _F(1e-30)
    off = reg * _F(0.0)
    for i in range(n):
        for j in range(i + 1):
            G[_tri(i, j)] = G[_tri(i, j)] + (reg if i == j else off)
    for i in range(n):
        for j in range(i + 1):
            acc = G[_tri(i, j)]
            for k in range(j):
                acc = acc - G[_tri(i, k)] * G[_tri(j, k)]
            G[_tri(i, j)] = np.sqrt(np.where(acc < _F(1e-30), _F(1e-30), acc)) if i == j else acc / G[_tri(j, j)]
    v = [np.full_like(G[0], _F(1.0) + _F(0.01) * _F(i)) for i in range(n)]
    for _ in range(6):
        y = []
        for i in range(n):
            acc = v[i]
            for k in range(i):
                acc = acc - G[_tri(i, k)] * y[k]
            y.append(acc / G[_tri(i, i)])
        for i in range(n - 1, -1, -1):
            acc = y[i]
            for k in range(i + 1, n):
                acc = acc - G[_tri(k, i)] * v[k]
            v[i] = acc / G[_tri(i, i)]
        nrm = np.sqrt(_dot((x, x) for x in v))
        nrm = np.where(nrm < _F(1e-30), _F(1e-30), nrm)
        v = [x / nrm for x in v]
    return v


def _rank2(F: list) -> list:
    a = [None] * 6
    b = [None] * 6
    for r in range(3):
        for c in range(r + 1):
            a[_tri(r, c)] = _dot((F[3 * i + r], F[3 * i + c]) for i in range(3))
            b[_tri(r, c)] = _dot((F[3 * r + j], F[3 * c + j]) for j in range(3))
    v3, u3 = _smallest_eigvec(a, 3), _smallest_eigvec(b, 3)
    s3 = _dot((_dot((u3[i], F[3 * i + j]) for i in range(3)), v3[j]) for j in range(3))
    return [F[3 * i + j] - (s3 * u3[i]) * v3[j] for i in range(3) for j in range(3)]


def _rows(x1, y1, x2, y2) -> list:
    return [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, np.ones_like(x1)]


def _sampson(F: list, x1, y1, x2, y2):
    a = [F[3 * i] * x1 + F[3 * i + 1] * y1 + F[3 * i + 2] for i in range(3)]
    b = [F[i] * x2 + F[3 + i] * y2 + F[6 + i] for i in range(2)]
    e = x2 * a[0] + y2 * a[1] + a[2]
    den = a[0] * a[0] + a[1] * a[1] + b[0] * b[0] + b[1] * b[1]
    return (e * e) / np.where(den < _F(1e-12), _F(1e-12), den)


def kernel_mirror(g: GateInput, threshold: float, hypotheses: int, min_points: int = 8,
                  min_inliers: int = 8) -> torch.Tensor:
    """The kernel's mask for one lane, computed in numpy float32 in the
    kernel's operation order (its block reductions included); a CPU bool
    tensor ``[N]``."""
    prev, curr = g.prev.cpu().numpy().astype(_F), g.curr.cpu().numpy().astype(_F)
    mask = g.mask.cpu().numpy().astype(bool)
    n, k = mask.shape[0], int(hypotheses)
    if int(mask.sum()) < max(int(min_points), 8):
        return torch.from_numpy(mask.copy())
    w = mask.astype(_F)
    count = _F(mask.sum())
    x1, y1, s1 = _normalise(prev, w, count)
    x2, y2, s2 = _normalise(curr, w, count)
    key = g.key.cpu().numpy()
    k1, k2 = _threefry(int(key[0]) & _M32, int(key[1]) & _M32, 0, int(g.next_id) & _M32)
    t = np.arange(k * n, dtype=np.uint64)
    h1, h2 = _threefry(int(k1), int(k2), np.zeros_like(t), t)
    u = (((h1 ^ h2) >> np.uint64(9)).astype(_F) * _F(2.0**-23)).reshape(k, n)
    idx = np.argsort(np.where(mask[None, :], u, _F(np.inf)), axis=1, kind="stable")[:, :8]
    A = _rows(x1[idx], y1[idx], x2[idx], y2[idx])  # 9 arrays [K, 8]
    G = [_dot((A[i][:, r], A[j][:, r]) for r in range(8)) for i in range(9) for j in range(i + 1)]
    F = np.stack(_rank2(_smallest_eigvec(G, 9)), -1)  # [K, 9]
    thr2 = _F(_F(_F(float(threshold) ** 2) * s1) * s2)
    d2 = _sampson([F[:, i, None] for i in range(9)], x1, y1, x2, y2)  # [K, N]
    rho = np.where(mask[None, :], np.where(d2 > thr2, thr2, d2), _F(0.0))
    cost = rho[:, 0]
    for i in range(1, n):
        cost = cost + rho[:, i]
    best = int(np.argmax(-cost))  # the first maximum, a NaN the maximum: as the kernel
    wl = ((d2[best] < thr2) & mask).astype(_F)
    rows = _rows(x1, y1, x2, y2)
    ii, jj = zip(*[(i, j) for i in range(9) for j in range(i + 1)])
    ai, aj = np.stack([rows[i] for i in ii]), np.stack([rows[j] for j in jj])  # [45, N]
    G2 = np.zeros(len(ii), _F)
    for i in range(n):
        G2 = G2 + (ai[:, i] * wl[i]) * aj[:, i]
    F_lo = _rank2(_smallest_eigvec([G2[e:e + 1] for e in range(len(ii))], 9))
    refined = (_sampson([f[0] for f in F_lo], x1, y1, x2, y2) < thr2) & mask
    return torch.from_numpy(refined if int(refined.sum()) >= min_inliers else mask.copy())
