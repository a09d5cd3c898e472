"""The frozen generator against the port's at a small size, and the frozen
reference against the port's frame steps in float64 on the CPU."""

from __future__ import annotations


import numpy as np
import pytest
import torch

from benchmark import scene as S
from benchmark.run import run_cell
from benchmark.tests.small import small_cell, window_seconds

EUROC = dict(kind="mh", camera_model="radtan", width=320, height=240, frame_freq=20.0, imu_freq=200.0,
             num_points=300, num_walls=6, wall_distance=2.5, intrinsics=[195.2, 194.6, 160.0, 120.0],
             distortion=[-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05],
             imu_noise={"gyr": 1.6968e-04, "acc": 2.0e-03, "gyrBias": 1.9393e-05, "accBias": 3.0e-03})
RACING = dict(kind="racing", camera_model="equidistant", width=320, height=240, frame_freq=30.0, imu_freq=500.0,
              num_points=300, num_walls=6, wall_distance=4.0, intrinsics=[139.3, 139.2, 160.0, 120.0],
              distortion=[-0.0137218, 0.0207274, -0.0127865, 0.0025242],
              imu_noise={"gyr": 3.0e-04, "acc": 2.0e-03, "gyrBias": 4.0e-05, "accBias": 3.0e-03})


def _port_reader(sc: dict, seed: int):
    from eqvio_tpu_torch.data.synthetic import SyntheticASLReader, SyntheticUZHFPVReader

    common = dict(end_time=sc["end_time"], imu_freq=sc["imu_freq"], frame_freq=sc["frame_freq"], width=sc["width"],
                  height=sc["height"], num_points=sc["num_points"], seed=seed, kind=sc["kind"],
                  intrinsics=tuple(sc["intrinsics"]), distortion=tuple(sc["distortion"]), imu_noise=sc["imu_noise"],
                  num_walls=sc["num_walls"], wall_distance=sc["wall_distance"])
    if sc["camera_model"] == "equidistant":
        return SyntheticUZHFPVReader(**common)
    return SyntheticASLReader(gt_freq=100.0, **common)


def _numpy_noise(sc: dict, seed: int):
    """The port's render noise: its numpy stream after the IMU's draws."""
    rng = np.random.default_rng(seed)
    n = len(np.arange(S.T0, sc["end_time"], 1.0 / sc["imu_freq"]))
    for _ in range(4):
        rng.normal(size=(n, 3))

    def noise(t0, t1):
        return np.stack([rng.normal(scale=0.01, size=(sc["height"], sc["width"])).astype(np.float32)
                         for _ in range(t1 - t0)])
    return noise


@pytest.mark.parametrize("params,seconds,seed", [(EUROC, 1.5, 5), (RACING, 1.0, 2**31 + 9)], ids=["euroc", "racing"])
def test_scene_matches_the_port(params, seconds, seed):
    sc = {**params, "end_time": seconds, "sequence_s": seconds}
    mine = S.build_scene(sc, seed, "cpu", noise=_numpy_noise(sc, seed))
    port = _port_reader(sc, seed)
    for a, b in ((mine.imu.stamps, port.imu.stamps), (mine.imu.gyr, port.imu.gyr), (mine.imu.acc, port.imu.acc),
                 (mine.images.stamps, port.images.stamps)):
        np.testing.assert_array_equal(a, b)
    assert mine.images.paths == port.images.paths
    assert mine.camera.model == port.camera.model and mine.camera.resolution == port.camera.resolution
    np.testing.assert_array_equal(mine.camera.T_BS, port.camera.T_BS)
    theirs = np.stack(port.frames).astype(np.int16)
    diff = np.abs(mine.host_frames.astype(np.int16) - theirs)
    # fixed-point sums against float32 sums: a value on a rounding edge moves one level
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    assert (theirs > 40).mean() > 0.002  # the blobs are there


def test_scene_is_the_same_for_a_seed():
    sc = {**EUROC, "end_time": 0.6, "sequence_s": 0.6}
    a = S.build_scene(sc, 2**33 + 1, "cpu")
    b = S.build_scene(sc, 2**33 + 1, "cpu")
    c = S.build_scene(sc, 2**33 + 2, "cpu")
    assert torch.equal(a.frames, b.frames) and not torch.equal(a.frames, c.frames)


def test_noised_lanes():
    frames = torch.tensor([[[0, 255], [128, 3]]], dtype=torch.uint8)
    gen = torch.Generator().manual_seed(3)
    lanes = S.noised_lanes(frames.expand(40, 2, 2).contiguous(), 3, gen)
    d = lanes.to(torch.int16) - frames.to(torch.int16)
    assert lanes.shape == (3, 40, 2, 2) and d.min() >= -3 and d.max() <= 3
    assert not torch.equal(lanes[0], lanes[1])


def test_lagged_stamps_feed_the_instants():
    """A scene whose image stamps lag by the configuration's ``cameraLag``,
    fed with that lag taken off, gives the frames the unlagged scene gives,
    at the same instants to the stamps' rounding."""
    from benchmark import reference

    for params in (EUROC, RACING):
        sc = {**params, "end_time": 1.0, "sequence_s": 1.0}
        plain = S.build_scene(sc, 7, "cpu")
        lagged = S.build_scene(sc, 7, "cpu", lag=0.01223)
        assert torch.equal(plain.frames, lagged.frames)
        np.testing.assert_allclose(lagged.images.stamps - plain.images.stamps, 0.01223, atol=2e-9)
        K = reference.imu_window_size(plain)
        first0, feed0 = reference.frame_feed(plain, 20, K)
        first1, feed1 = reference.frame_feed(lagged, 20, K, 0.01223)
        assert first0[0] == first1[0] and [f[0] for f in feed0] == [f[0] for f in feed1]
        np.testing.assert_allclose([f[1] for f in feed1], [f[1] for f in feed0], atol=2e-9)


@pytest.mark.parametrize("workload", ["mh03.seq", "racing.seq", "mh03.batch"])
def test_reference_is_the_program_in_float64(workload, tmp_path):
    """Run in float64 on the CPU, the program and the reference compute the
    same frames: the stretches agree to round-off, far inside the limits."""
    torch.set_num_threads(4)
    cell = small_cell(workload)
    cell.cfg["dtype"] = "float64"
    res = run_cell(cell, 123456789012, window_seconds(cell), False, device="cpu", out_root=str(tmp_path))
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["pos_gap_m"]["value"] < 1e-6  # batched and single-lane float64 algebra round apart
