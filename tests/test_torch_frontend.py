"""Parity of the port's front end with ``eqvio_tpu``: the threefry stream,
pyramid, Shi-Tomasi score, detection (with planted score ties), the RANSAC
gate's eigenvector solver and mask (the plain function and the tracker's
op), and five tracker frames with the gate on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqvio_tpu.frontend import detector as jdet
from eqvio_tpu.frontend import ransac as jransac
from eqvio_tpu.frontend import tracker as jtracker
from eqvio_tpu.frontend.pyramid import build_pyramid as jax_build_pyramid
from eqvio_tpu_torch import convert
from eqvio_tpu_torch.data import SyntheticASLReader
from eqvio_tpu_torch.frontend import detector as tdet
from eqvio_tpu_torch.frontend import prng
from eqvio_tpu_torch.frontend import ransac as transac
from eqvio_tpu_torch.frontend import tracker as ttracker
from eqvio_tpu_torch.frontend.pyramid import build_pyramid
from eqvio_tpu_torch.kernels import ransac as ransac_kernel
from eqvio_tpu_torch.kernels.ransac_bench import two_view as _two_view

H, W = 120, 160


def _texture(seed, h=H, w=W):
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    for x, y in rng.uniform([10, 10], [w - 10, h - 10], size=(25, 2)):
        img += np.exp(-((xs - x) ** 2 + (ys - y) ** 2) / 4.0).astype(np.float32)
    img += rng.normal(scale=0.02, size=img.shape).astype(np.float32)
    return np.clip(img, 0, 1).astype(np.float32)


@pytest.mark.parametrize("seed,next_id,shape", [
    (7, 0, (64, 30)), (7, 31, (64, 40)), (123, 5, (16, 9)), (2**32 - 1, 99999, (3, 7)),
])
def test_threefry_uniform_matches_jax_bits(seed, next_id, shape):
    key_j = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), np.int32(next_id))
    u_j = np.asarray(jax.random.uniform(key_j, shape, dtype=jnp.float32))
    key_t = prng.fold_in(prng.prng_key(seed, "cpu"), torch.tensor(next_id))
    np.testing.assert_array_equal(key_t.numpy(), np.asarray(key_j).astype(np.int64))
    u_t = prng.uniform(key_t, shape).numpy()
    assert u_t.dtype == np.float32
    np.testing.assert_array_equal(u_t.view(np.uint32), u_j.view(np.uint32))


def test_pyramid_and_harris_match_jax():
    img = _texture(0, 121, 161)  # odd sizes: ceil(n/2) levels
    pj = jax_build_pyramid(jnp.asarray(img), 4)
    pt = build_pyramid(torch.tensor(img), 4)
    for a, b in zip(pj, pt):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tdet.harris_score(torch.tensor(img)).numpy(),
                               np.asarray(jdet.harris_score(jnp.asarray(img))), atol=1e-6, rtol=0)


def test_detect_features_matches_jax():
    img = _texture(1)
    ex = np.asarray([[50.0, 40.0], [90.0, 70.0], [0.0, 0.0]], np.float32)
    ex_mask = np.asarray([True, True, False])
    pj, vj = jdet.detect_features(jnp.asarray(img), 12, min_dist=8, border=10,
                                  exclude=jnp.asarray(ex), exclude_mask=jnp.asarray(ex_mask))
    pt, vt = tdet.detect_features(torch.tensor(img), 12, min_dist=8, border=10,
                                  exclude=torch.tensor(ex), exclude_mask=torch.tensor(ex_mask))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert vt.sum() >= 6
    np.testing.assert_array_equal(pt.numpy()[vt.numpy()], np.asarray(pj)[np.asarray(vj)])


@pytest.mark.parametrize("with_exclude", [False, True])
def test_detect_features_tie_order_matches_jax(monkeypatch, with_exclude):
    """Planted ties in the score map: the candidates with equal scores must
    fill the slots in flat-index order in both packages."""
    score = np.zeros((H, W), np.float32)
    peaks = [(30, 100), (30, 40), (80, 40), (80, 100), (55, 70), (100, 130), (20, 130)]
    for k, (y, x) in enumerate(peaks):
        score[y, x] = 0.5 if k < 5 else 0.25  # five-way tie at the top
    monkeypatch.setattr(jdet, "harris_score", lambda img: jnp.asarray(score))
    monkeypatch.setattr(tdet, "harris_score", lambda img: torch.tensor(score))
    kw = dict(min_dist=5, border=5)
    ex = np.asarray([[100.0, 30.0]], np.float32)  # excludes the peak at (y=30, x=100)
    if with_exclude:
        kw_j = dict(kw, exclude=jnp.asarray(ex), exclude_mask=jnp.asarray([True]))
        kw_t = dict(kw, exclude=torch.tensor(ex), exclude_mask=torch.tensor([True]))
    else:
        kw_j = kw_t = kw
    img = np.zeros((H, W), np.float32)
    pj, vj = jdet.detect_features(jnp.asarray(img), 3, **kw_j)
    pt, vt = tdet.detect_features(torch.tensor(img), 3, **kw_t)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    second = [70.0, 55.0] if with_exclude else [100.0, 30.0]
    np.testing.assert_array_equal(pt.numpy()[:2], [[40.0, 30.0], second])


@pytest.mark.parametrize("gap", ["separated", "near-degenerate"])
def test_smallest_eigvec_matches_jax(gap):
    """The two packages run the same inverse iteration; with a near-degenerate
    smallest pair it need not return eigh's eigenvector, but both must return
    the same vector."""
    rng = np.random.default_rng(5)
    lams = np.sort(rng.uniform(0.5, 4.0, size=(32, 9)), axis=1)
    lams[:, 0] = 0.05
    if gap == "near-degenerate":
        lams[:, 1] = lams[:, 0] * (1.0 + 1e-3)
    Q, _ = np.linalg.qr(rng.normal(size=(32, 9, 9)))
    G = np.einsum("kij,kj,klj->kil", Q, lams, Q)
    G = (0.5 * (G + np.swapaxes(G, -1, -2))).astype(np.float32)
    vj = np.asarray(jransac.smallest_eigvec(jnp.asarray(G)))
    vt = transac.smallest_eigvec(torch.tensor(G)).numpy()
    np.testing.assert_allclose(vt, vj, atol=1e-5, rtol=0)  # float32 round-off
    align = np.abs(np.sum(vt * Q[:, :, 0], axis=-1))
    if gap == "near-degenerate":
        assert align.min() < 0.5  # not eigh's eigenvector: a vector in the pair's span
    else:
        assert align.min() > 0.999


@pytest.mark.parametrize("seed,next_id", [(0, 0), (1, 17), (2, 250)])
def test_ransac_mask_matches_jax(seed, next_id):
    prev, curr, mask = _two_view(seed)
    key_j = jax.random.fold_in(jax.random.PRNGKey(np.uint32(7)), np.int32(next_id))
    key_t = prng.fold_in(prng.prng_key(7, "cpu"), next_id)
    mj = jransac.ransac_epipolar_mask(jnp.asarray(prev), jnp.asarray(curr), jnp.asarray(mask), key_j,
                                      threshold=0.9, hypotheses=64)
    mt = transac.ransac_epipolar_mask(torch.tensor(prev), torch.tensor(curr), torch.tensor(mask), key_t,
                                      threshold=0.9, hypotheses=64)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    # the tracker's op (its CPU implementation) folds the counter in itself
    mo = ransac_kernel.ransac_mask(torch.tensor(prev), torch.tensor(curr), torch.tensor(mask), prng.prng_key(7, "cpu"),
                                   torch.tensor(next_id), threshold=0.9, hypotheses=64)
    np.testing.assert_array_equal(mo.numpy(), np.asarray(mj))
    assert mt.numpy()[5:-3].all() and mt.numpy()[:5].sum() <= 2  # inliers kept, outliers cut


def test_tracker_steps_match_jax():
    """Five tracker frames with the RANSAC gate and the detector gate on:
    identical masks, ids and detector decisions, positions within 1e-4 px."""
    reader = SyntheticASLReader(end_time=1.2, width=320, height=240, frame_freq=10.0, num_points=300)
    kw = dict(max_features=20, win_size=15, max_error=0.08, feature_search_threshold=0.8,
              ransac_inlier_threshold=0.9, ransac_hypotheses=64, ransac_min_inliers=8)
    cfg_j, cfg_t = jtracker.TrackerConfig(**kw), ttracker.TrackerConfig(**kw)
    step_j = jax.jit(lambda s, im: jtracker.tracker_step(s, im, cfg_j))
    sj = jtracker.tracker_init(cfg_j, (240, 320))
    st = ttracker.tracker_init(cfg_t, (240, 320), "cpu")
    searched = []
    for i in range(6):
        img = reader.load_image_u8(i).astype(np.float32) * (1.0 / 255.0)
        sj = step_j(sj, jnp.asarray(img))
        st = ttracker.tracker_step(st, torch.tensor(img), cfg_t)
        if i == 2:  # hand the JAX state across mid-sequence, as convert does
            st = convert.tracker_state_from_numpy(sj, "cpu")
        np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask), err_msg=f"frame {i}")
        np.testing.assert_array_equal(st.ids.numpy(), np.asarray(sj.ids), err_msg=f"frame {i}")
        assert int(st.next_id) == int(sj.next_id)
        assert bool(st.searched) == bool(sj.searched)
        np.testing.assert_allclose(st.positions.numpy(), np.asarray(sj.positions), atol=1e-4, rtol=0)
        searched.append(bool(st.searched))
    assert int(st.mask.sum()) >= 10
    assert searched[0] and not all(searched)  # the detector gate both fires and skips
