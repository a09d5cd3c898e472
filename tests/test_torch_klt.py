"""Parity of the port's plain KLT with ``eqvio_tpu``.

- The plain version (CPU path of ``kernels.klt.klt_track_pyramid``) against
  JAX ``track_features(mode="gather")`` in float32 on the same pyramids:
  <= 1e-4 px and identical tracked masks, interior and within 8 px of the
  borders.
- One level against the Pallas kernel in interpret mode at the tolerances
  of ``tests/test_pallas_klt.py`` (0.1 px interior, 2e-3 px at borders).
- The kernel's shared-memory tile geometry, mirrored in Python: sampling
  through "the tile if the footprint lies in it, else the image" equals
  :func:`bilinear` exactly on the four level shapes of 752x480, and float
  rounding that pushes a window past its tile sends it to the image.

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
from eqvio_tpu_torch.kernels.klt_bench import border_features

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


# the border and corner features of the KLT measurements at 752x480 (full resolution)
_FULL_H, _FULL_W = 480, 752
_BORDER = border_features(_FULL_H, _FULL_W)


def _footprints_in(corner, xy, W, H):
    """Per sample: the clamped 2x2 footprint lies in the tile."""
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    ix = torch.floor(x).to(torch.int64) - corner[0]
    iy = torch.floor(y).to(torch.int64) - corner[1]
    return (ix >= 0) & (ix <= corner[2] - 2) & (iy >= 0) & (iy <= corner[3] - 2)


def _template_window(c, win=WIN):
    """The template window at centre ``c`` with its +-1 px gradient samples,
    computed as the kernel does: (c + offset) +- 1 in float32."""
    coords = torch.tensor(c, dtype=torch.float32) + K._window_offsets(win, torch.float32, "cpu")
    ex, ey = torch.tensor([1.0, 0.0]), torch.tensor([0.0, 1.0])
    return torch.stack([coords + ex, coords - ex, coords + ey, coords - ey, coords])


@pytest.mark.parametrize("win", [15, 21, 31])
@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_tile_geometry_samples_equal_bilinear(level, win):
    """Per feature, the prev tile staged around it serves the template
    window (+-1 px gradients included): interior, border and corner
    features, and centres outside the image, for windows of 1, 2 and 4
    samples per lane.  The extreme samples decide exactly when every
    footprint lies in the tile, and every value equals :func:`bilinear` bit
    for bit."""
    rng = np.random.default_rng(10 * level + win)
    H, W = _FULL_H >> level, _FULL_W >> level
    img = torch.tensor(rng.uniform(0, 1, (H, W)).astype(np.float32))
    full = np.concatenate([rng.uniform([30, 30], [_FULL_W - 30, _FULL_H - 30], (6, 2)), _BORDER,
                           [[-40.0, 200.0], [_FULL_W + 25.0, -30.0]]])
    r = (win - 1) / 2
    for c in (full / 2.0**level).astype(np.float32):
        corner = K.tile_corner(c[0], c[1], r + 1, win + 3, W, H)
        tile = K.stage_tile(img, corner, win + 3)
        window = _template_window(c, win)
        assert bool(_footprints_in(corner, window, W, H).all())
        vals, from_tile = K.bilinear_tiled(img, tile, corner, window)
        assert from_tile and torch.equal(vals, K.bilinear(img, window))


def test_tile_geometry_rounding_reads_the_image():
    """At cx = 118 - 2^-17, cx + r = 128 - 2^-17 and adding 1 rounds (a tie,
    to even) up to 129: the window's last footprint column falls one pixel
    past the tile.  The extreme-sample check sees it and the window reads
    the image; one ulp lower, it stays in the tile.  Both equal
    :func:`bilinear` bit for bit."""
    H, W = _FULL_H, _FULL_W
    img = torch.tensor(np.random.default_rng(3).uniform(0, 1, (H, W)).astype(np.float32))
    r = (WIN - 1) / 2
    for ulps, inside in ((1, False), (2, True)):
        c = np.array([118.0 - ulps * 2.0**-17, 200.0], np.float32)
        corner = K.tile_corner(c[0], c[1], r + 1, WIN + 3, W, H)
        window = _template_window(c)
        assert bool(_footprints_in(corner, window, W, H).all()) == inside
        vals, from_tile = K.bilinear_tiled(img, K.stage_tile(img, corner, WIN + 3), corner, window)
        assert from_tile == inside
        assert torch.equal(vals, K.bilinear(img, window))
