"""The RANSAC gate's op (``eqvio_tpu_torch::ransac_epipolar_mask``,
``eqvio_tpu_torch/kernels/ransac.py``) on the CPU, where it runs the plain
version.

- The op equals ``fold_in`` plus ``frontend.ransac.ransac_epipolar_mask``
  bit for bit, and launches nothing.
- ``torch.library.opcheck``: the schema, the fake implementation and the
  registrations.
- The vmap rule (one lane axis, nested, a key shared or per lane) against
  the plain gate under ``torch.func.vmap``, functorch's per-lane fallback
  turned into an error; lane dims passed directly equal single calls.
- ``kernels.ransac_bench.gate_parts``, the plain intermediates the card
  tests' near-tie rule reads, reproduces the plain gate on inputs the
  tracker hands over, and the rule does not excuse a mask with a track
  flipped far from the threshold.
- ``ransac_bench.kernel_mirror``, the kernel's arithmetic in numpy float32
  that the card tests hold the kernel to bit for bit, gives the plain
  gate's masks, or differs at a near tie.
"""

import numpy as np
import pytest
import torch

from eqvio_tpu_torch.data import SyntheticASLReader
from eqvio_tpu_torch.frontend import prng
from eqvio_tpu_torch.frontend import ransac as plain
from eqvio_tpu_torch.io import bench_config
from eqvio_tpu_torch.kernels import ransac as RK
from eqvio_tpu_torch.kernels import ransac_bench as RB
from tests.test_torch_batch_frame import no_vmap_fallback

_two_view = RB.two_view

KEY = prng.prng_key(7, "cpu")


def _plain(prev, curr, mask, next_id, threshold=0.9, hypotheses=34, min_inliers=8):
    return plain.ransac_epipolar_mask(prev, curr, mask, prng.fold_in(KEY, next_id), threshold, hypotheses, 8,
                                      min_inliers)


def _lanes(n_lanes=3, n=40):
    views = [_two_view(seed, n=n) for seed in range(n_lanes)]
    prev, curr, mask = (torch.tensor(np.stack(a)) for a in zip(*views))
    return prev, curr, mask, torch.tensor([17, 3, 250, 99][:n_lanes])


@pytest.mark.parametrize("seed,next_id,hypotheses", [(0, 0, 20), (1, 17, 34), (2, 250, 64), (3, 5, 34)])
def test_op_equals_plain_gate(seed, next_id, hypotheses):
    prev, curr, mask = (torch.tensor(a) for a in _two_view(seed, n=40))
    before = (RK.ransac_mask.launches, RK.ransac_mask.captured)
    got = RK.ransac_mask(prev, curr, mask, KEY, torch.tensor(next_id), 0.9, hypotheses, 8, 8)
    assert torch.equal(got, _plain(prev, curr, mask, next_id, hypotheses=hypotheses))
    assert (RK.ransac_mask.launches, RK.ransac_mask.captured) == before  # the plain path launches nothing
    assert got[5:-3].all() and not got[-3:].any()


def test_op_opcheck():
    prev, curr, mask = (torch.tensor(a) for a in _two_view(1, n=40))
    torch.library.opcheck(RK._ransac_op, (prev, curr, mask, KEY, torch.tensor(17), 0.9, 34, 8, 8))
    prev, curr, mask, ids = _lanes()
    torch.library.opcheck(RK._ransac_op, (prev, curr, mask, KEY, ids, 0.9, 20, 8, 8))


def test_op_under_vmap_equals_plain_under_vmap():
    """One lane axis with the key shared, nested vmap, and a key per lane:
    each equal to the plain gate under ``torch.func.vmap``."""
    prev, curr, mask, ids = _lanes()
    op = lambda p, c, m, k, i: RK.ransac_mask(p, c, m, k, i, 0.9, 34, 8, 8)  # noqa: E731
    ref = lambda p, c, m, k, i: plain.ransac_epipolar_mask(p, c, m, prng.fold_in(k, i), 0.9, 34, 8, 8)  # noqa: E731
    shared = (0, 0, 0, None, 0)
    keys = torch.stack([KEY, prng.prng_key(11, "cpu"), prng.prng_key(2**32 - 1, "cpu")])
    with no_vmap_fallback():
        got = torch.func.vmap(op, in_dims=shared)(prev, curr, mask, KEY, ids)
        want = torch.func.vmap(ref, in_dims=shared)(prev, curr, mask, KEY, ids)
        nested = torch.func.vmap(torch.func.vmap(op, in_dims=shared), in_dims=(None, None, None, None, 0))(
            prev, curr, mask, KEY, torch.stack([ids, ids + 1]))
        per_key = torch.func.vmap(op)(prev, curr, mask, keys, ids)
        per_key_ref = torch.func.vmap(ref)(prev, curr, mask, keys, ids)
    assert torch.equal(got, want) and torch.equal(per_key, per_key_ref)
    assert torch.equal(nested[0], got)
    for b in range(3):
        assert torch.equal(nested[1, b], _plain(prev[b], curr[b], mask[b], int(ids[b]) + 1))
    assert not torch.equal(got, per_key)  # the keys draw other hypotheses


def test_op_takes_lane_dims_directly():
    prev, curr, mask, ids = _lanes()
    got = RK.ransac_mask(prev[None], curr[None], mask[None], KEY, ids[None], 0.9, 34, 8, 8)
    assert got.shape == (1, 3, 40)
    for b in range(3):
        assert torch.equal(got[0, b], _plain(prev[b], curr[b], mask[b], int(ids[b])))


def test_gate_parts_reproduce_the_plain_gate():
    """On the inputs the tracker hands the gate over ten frames, the plain
    intermediates give the plain gate's mask: the refined mask where it
    holds ``min_inliers`` of the tracked slots, else the mask.  A refined
    mask with the track farthest from the threshold flipped is no Sampson
    near tie."""
    reader = SyntheticASLReader(end_time=1.6, width=320, height=240, frame_freq=10.0, num_points=300)
    cfg = bench_config()
    cfg["GIFT"]["ransacParams"]["minInliers"] = 12
    inputs, kw = RB.gate_inputs(reader, cfg, 10, "cpu")
    assert len(inputs) == 10 and kw["hypotheses"] == 64
    used = 0
    for g in inputs:
        parts = RB.gate_parts(g, kw["threshold"], kw["hypotheses"])
        usable = int(g.mask.sum()) >= 8 and int(parts["refined"].sum()) >= kw["min_inliers"]
        out = RK.ransac_mask(*g, **kw)
        assert torch.equal(out, parts["refined"] if usable else g.mask)
        if usable:
            far = int(torch.argmax(torch.where(g.mask, (parts["d2_lo"] - parts["thr2"]).abs(), -1.0)))
            flipped = out.clone()
            flipped[far] = ~flipped[far]
            assert RB.near_tie(flipped, g, kw["threshold"], kw["hypotheses"], kw["min_inliers"]) != "sampson"
        used += usable
    assert used >= 5


def test_kernel_mirror_matches_plain_gate():
    """Two-view scenes (40 tracks, 45: not a multiple of a warp, and 300:
    more than a block's threads; 20, 34 and 64 hypotheses; with the
    refit's guard and without) and the tracker's inputs over twelve frames:
    the mirror's masks equal the plain gate's, or differ at a near tie
    (``near_tie``: on seed 7 with 20 hypotheses the plain gate's pick is
    decided by rounding), and most are equal."""
    cases = []
    for seed in range(8):
        for n, k in ((40, 20), (45, 34), (300, 64)):
            g = RB.GateInput(*(torch.tensor(a) for a in _two_view(seed, n=n)), KEY, torch.tensor(seed * 37))
            cases += [(g, 0.9, k, mi) for mi in (8, 0)]
    reader = SyntheticASLReader(end_time=1.6, width=320, height=240, frame_freq=10.0, num_points=300)
    inputs, kw = RB.gate_inputs(reader, bench_config(), 12, "cpu")
    cases += [(g, kw["threshold"], kw["hypotheses"], mi) for g in inputs for mi in (8, 0)]
    equal = 0
    for g, thr, k, mi in cases:
        got = RB.kernel_mirror(g, thr, k, 8, mi)
        if torch.equal(got, RK.ransac_mask_plain(*g, thr, k, 8, mi)):
            equal += 1
        else:
            assert RB.near_tie(got, g, thr, k, mi) is not None
    assert equal >= len(cases) - 6
