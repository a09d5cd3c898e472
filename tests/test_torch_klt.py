"""Parity of the port's plain KLT with ``eqvio_tpu``.

- The plain version (CPU path of ``kernels.klt.klt_track_pyramid``) against
  JAX ``track_features(mode="gather")`` in float32 on the same pyramids:
  <= 1e-4 px and identical tracked masks, interior and within 8 px of the
  borders.
- One level against the Pallas kernel in interpret mode at the tolerances
  of ``tests/test_pallas_klt.py`` (0.1 px interior, 2e-3 px at borders).

The CUDA kernel is held to the plain version on the card in
``tests/test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqvio_tpu.frontend.klt import _bilinear as jax_bilinear
from eqvio_tpu.frontend.klt import track_features as jax_track_features
from eqvio_tpu.frontend.pallas_klt import klt_track_level_pallas
from eqvio_tpu.frontend.pyramid import build_pyramid as jax_build_pyramid
from eqvio_tpu_torch.frontend.klt import track_features
from eqvio_tpu_torch.kernels import klt as K

H, W = 240, 320
WIN, ITERS = 21, 8
SHIFT = (1.3, -0.8)


def _scene(seed=0):
    """A smooth random texture and its copy shifted by SHIFT px, plus
    interior and border feature positions."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0, 1, (H + 20, W + 20)).astype(np.float32)
    for _ in range(2):  # blur: 2x nearest upsample, then blur + decimate
        up = jnp.asarray(np.kron(base, np.ones((2, 2), np.float32)))
        base = np.asarray(jax_build_pyramid(up, 2)[1])
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    img0 = base[10:10 + H, 10:10 + W].copy()
    coords = jnp.stack([jnp.asarray(xx) + 10 - SHIFT[0], jnp.asarray(yy) + 10 - SHIFT[1]], -1)
    img1 = np.asarray(jax_bilinear(jnp.asarray(base), coords))
    interior = rng.uniform([40, 40], [W - 40, H - 40], (20, 2))
    border = [[5, 100], [W - 6, 50], [160, 4], [100, H - 5], [8, 8], [W - 9, H - 9], [2, 2], [W - 3, 120]]
    return img0, img1, np.concatenate([interior, border]).astype(np.float32)


def _pyramids(img0, img1):
    p0 = [np.asarray(a) for a in jax_build_pyramid(jnp.asarray(img0), 4)]
    p1 = [np.asarray(a) for a in jax_build_pyramid(jnp.asarray(img1), 4)]
    return p0, p1


def _torch(arrs, device="cpu"):
    return [torch.tensor(a, device=device) for a in arrs]


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_klt_matches_jax_gather_path(seed):
    img0, img1, pts = _scene(seed)
    p0, p1 = _pyramids(img0, img1)
    mask = np.ones(len(pts), bool)
    mask[3] = False
    guess = pts + np.float32(0.5)
    pos_j, ok_j = jax_track_features(
        [jnp.asarray(a) for a in p0], [jnp.asarray(a) for a in p1], jnp.asarray(pts),
        jnp.asarray(mask), predicted=jnp.asarray(guess), win=WIN, iters=ITERS, max_error=0.08,
        mode="gather",
    )
    pos_t, ok_t = track_features(
        _torch(p0), _torch(p1), torch.tensor(pts), torch.tensor(mask), predicted=torch.tensor(guess),
        win=WIN, iters=ITERS, max_error=0.08,
    )
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t[:20].sum() >= 18  # the interior tracks converge
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), atol=1e-4, rtol=0)
    track_err = np.abs(pos_t.numpy()[:20] - (pts[:20] + SHIFT))[ok_t.numpy()[:20]]
    assert track_err.max() < 0.15


def _pallas_border_scene():
    """The border scene of ``tests/test_pallas_klt.py``: a coarse-level-sized
    image, its bilinear shift, and features within one window of every
    border (where both kernels' edge replication must agree)."""
    rng = np.random.default_rng(0)
    h, w = 60, 80
    img0 = jax_build_pyramid(jnp.asarray(rng.uniform(0, 1, (2 * h, 2 * w)).astype(np.float32)), 2)[1]
    yy, xx = jnp.meshgrid(jnp.arange(h, dtype=jnp.float32), jnp.arange(w, dtype=jnp.float32),
                          indexing="ij")
    img1 = jax_bilinear(img0, jnp.stack([xx - 0.7, yy + 0.4], axis=-1))
    pts = np.asarray([[6.0, 30.0], [74.0, 30.0], [40.0, 5.0], [40.0, 55.0], [7.0, 7.0],
                      [73.0, 53.0], [40.0, 30.0]], np.float32)
    return img0, img1, pts


@pytest.mark.parametrize("where", ["interior", "border"])
def test_plain_level_matches_pallas_interpret(where):
    """One pyramid level, plain port vs the Pallas kernel (interpret mode)."""
    if where == "interior":
        img0, img1, pts = _scene(2)
        lvl0 = jax_build_pyramid(jnp.asarray(img0), 2)[1]
        lvl1 = jax_build_pyramid(jnp.asarray(img1), 2)[1]
        sel = pts[:20] / 2
    else:
        lvl0, lvl1, sel = _pallas_border_scene()
    pal, _ = klt_track_level_pallas(lvl0, lvl1, jnp.asarray(sel), jnp.asarray(sel), win=WIN,
                                    iters=ITERS, interpret=True)
    plain, _ = K.track_level(torch.tensor(np.asarray(lvl0)), torch.tensor(np.asarray(lvl1)),
                             torch.tensor(sel), torch.tensor(sel), WIN, ITERS)
    tol = 0.1 if where == "interior" else 2e-3
    np.testing.assert_allclose(plain.numpy(), np.asarray(pal), atol=tol, rtol=0)


def test_wrapper_rejects_unsupported_inputs():
    """The CUDA path's argument checks (exercised here on CPU tensors)."""
    img0, img1, pts = _scene(0)
    p0, p1 = _torch(_pyramids(img0, img1)[0]), _torch(_pyramids(img0, img1)[1])
    good = torch.tensor(pts)
    with pytest.raises(ValueError, match="float32"):
        K._check_cuda_inputs(p0, p1, good.double(), good)
    with pytest.raises(ValueError, match="shape"):
        K._check_cuda_inputs(p0, p1, good, good[:-1])
    with pytest.raises(ValueError, match="levels"):
        K._check_cuda_inputs(p0, p1[:2], good, good)
    with pytest.raises(ValueError, match="level 1"):
        K._check_cuda_inputs(p0, [p1[0], p1[1].t().contiguous(), *p1[2:]], good, good)
    K._check_cuda_inputs(p0, p1, good, good)
