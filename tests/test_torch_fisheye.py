"""Parity of the port's fisheye UZH-FPV front end with ``eqvio_tpu`` on the CPU.

The equidistant camera, histogram equalisation, the tracker with
equalisation and the median-flow gate, the ``racing`` trajectory, the
in-memory UZH-FPV scene against the UZH-FPV reader on a tree written by the
JAX generator, and ``run_dataset`` with ``configs/config_racing_proxy.yaml``
(float64, eager and fused) against ``eqvio_tpu``'s per-frame run.  Inputs
come from ``numpy`` seeds.  The JAX tracker runs with ``klt_mode="gather"``,
so no Pallas kernel is reached (the racing config pins ``mxu``, which
matches gather to 8e-6 px).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eqvio_tpu.app.run_opt as jax_run_opt
import eqvio_tpu_torch.app.run_opt as torch_run_opt
from eqvio_tpu import camera as JCam
from eqvio_tpu import sim as JSim
from eqvio_tpu.data.synthetic import generate_uzhfpv_dataset
from eqvio_tpu.frontend import detector as jdetector
from eqvio_tpu.frontend import tracker as jtracker
from eqvio_tpu.io import load_config
from eqvio_tpu_torch import camera as TCam
from eqvio_tpu_torch import sim as TSim
from eqvio_tpu_torch.data import SyntheticUZHFPVReader, UZHFPVDatasetReader, create_dataset_reader
from eqvio_tpu_torch.frontend import detector as tdetector
from eqvio_tpu_torch.frontend import tracker as ttracker
from eqvio_tpu_torch.io import tracker_config_from_config
from tests.test_torch_core import F64, assert_tree_close, tt
from tests.test_torch_run_opt import _recording_writer, one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST = (-0.013721808247486035, 0.020727425669427896, -0.012786476702685545, 0.0025242267320687625)
NOISE = {"gyr": 3.0e-04, "acc": 2.0e-03, "gyrBias": 4.0e-05, "accBias": 3.0e-03}
# the racing proxy's sensors at 320x240 for 2 s (the trajectory's stationary start)
READER_SCENE = dict(end_time=2.0, width=320, height=240, imu_freq=500.0, frame_freq=30.0, num_points=400,
                    seed=13, kind="racing", distortion=DIST, imu_noise=NOISE, num_walls=6, wall_distance=4.0)
# a moving fisheye scene for the pipeline runs
RUN_SCENE = dict(end_time=3.0, width=320, height=240, frame_freq=10.0, num_points=300, seed=2)


def test_equidistant_camera_matches_jax():
    cam_j = JCam.EquidistantCamera.create(278.66, 278.48, 319.75, 241.96, DIST, 640, 480)
    cam_t = TCam.EquidistantCamera.create(278.66, 278.48, 319.75, 241.96, DIST, 640, 480, dtype=F64, device="cpu")
    rng = np.random.default_rng(7)
    p = rng.uniform(-2, 2, size=(64, 3)) + [0, 0, 0.5]
    p[0] = [1.0, 0.0, -0.3]  # behind the image plane, inside the fisheye's field
    p[1, 2] = 0.0  # the z-guard
    px = rng.uniform([0, 0], [640, 480], size=(64, 2))
    for name, a, b in (
        ("project", cam_j.project(jnp.asarray(p)), cam_t.project(tt(p))),
        ("undistort", cam_j.undistort(jnp.asarray(px)), cam_t.undistort(tt(px))),
        ("jacobian", cam_j.projection_jacobian(jnp.asarray(p[2:])), cam_t.projection_jacobian(tt(p[2:]))),
        ("in_domain", cam_j.is_in_domain(jnp.asarray(p)), cam_t.is_in_domain(tt(p))),
    ):
        assert_tree_close(a, b, 1e-10, name)
    assert bool(cam_t.is_in_domain(tt(p[:1]))[0]) is False  # x = 1 lands outside the 640 px image
    # project and undistort invert each other in front of the camera
    front = tt(p[p[:, 2] > 0.2])
    bearings = cam_t.undistort(cam_t.project(front))
    torch.testing.assert_close(bearings, front / front.norm(dim=-1, keepdim=True), atol=1e-9, rtol=0)


@pytest.fixture(scope="module")
def uzh_tree(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("uzh"))
    generate_uzhfpv_dataset(out, **READER_SCENE)
    return out


def test_equalize_histogram_matches_jax_exactly(uzh_tree):
    reader = UZHFPVDatasetReader(uzh_tree)
    rng = np.random.default_rng(3)
    frames = [reader.load_image_u8(i) for i in (0, 30)]
    frames.append((rng.uniform(0, 1, (240, 320)) ** 4 * 255).astype(np.uint8))  # a skewed histogram
    frames.append(np.full((240, 320), 77, np.uint8))  # a single bin
    for k, u8 in enumerate(frames):
        img = u8.astype(np.float32) * (1.0 / 255.0)
        out_j = np.asarray(jdetector.equalize_histogram(jnp.asarray(img)))
        out_t = tdetector.equalize_histogram(torch.tensor(u8).to(torch.float32) * (1.0 / 255.0)).numpy()
        np.testing.assert_array_equal(out_t, out_j, err_msg=f"frame {k}")


def test_tracker_with_equalisation_and_flow_gate_matches_jax():
    """Twelve tracker frames of a moving fisheye scene with equalisation and
    a 3 px median-flow gate: identical ids, masks and next ids, positions to
    1e-4 px.  The two float32 KLTs sum their windows in different orders:
    one ulp (1.5e-5 px at 128-256 px) from frame 2, carried along the
    tracks to 9.2e-5 px by frame 11."""
    reader = SyntheticUZHFPVReader(**RUN_SCENE)
    kw = dict(max_features=24, win_size=15, max_error=0.3, feature_search_threshold=0.7, equalize_histogram=True,
              flow_outlier_threshold=3.0)
    cfg_j, cfg_t = jtracker.TrackerConfig(**kw, klt_mode="gather"), ttracker.TrackerConfig(**kw)
    step_j = jax.jit(lambda s, im: jtracker.tracker_step(s, im, cfg_j))
    sj = jtracker.tracker_init(cfg_j, (240, 320))
    st = ttracker.tracker_init(cfg_t, (240, 320), "cpu")
    gated = 0
    for i in range(12):
        img = reader.load_image_u8(i).astype(np.float32) * (1.0 / 255.0)
        sj = step_j(sj, jnp.asarray(img))
        prev_mask = st.mask
        st = ttracker.tracker_step(st, torch.from_numpy(img), cfg_t)
        np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask), err_msg=f"frame {i}")
        np.testing.assert_array_equal(st.ids.numpy(), np.asarray(sj.ids), err_msg=f"frame {i}")
        assert int(st.next_id) == int(sj.next_id)
        np.testing.assert_allclose(st.positions.numpy(), np.asarray(sj.positions), atol=1e-4, rtol=0)
        gated += int((prev_mask & ~st.mask).sum())
    assert gated > 0  # tracks were dropped along the way


def test_median_flow_gate_matches_jax():
    """The gate alone on seeded flows: outliers past the threshold go, and
    under 4 tracked features everything stays."""
    rng = np.random.default_rng(11)
    for n_tracked in (12, 3):
        prev = rng.uniform(20, 300, (16, 2)).astype(np.float32)
        new = prev + rng.normal(0, 0.5, (16, 2)).astype(np.float32) + np.float32(2.0)
        new[[1, 5]] += 9.0
        tracked = np.arange(16) < n_tracked
        flow = new - prev
        med = np.sort(np.where(tracked[:, None], flow, 1e9), axis=0)[min(n_tracked // 2, 15)]
        expect = tracked & ((np.linalg.norm(flow - med, axis=-1) < 3.0) | (n_tracked < 4))
        out = ttracker._median_flow_gate(torch.tensor(prev), torch.tensor(new), torch.tensor(tracked), 3.0)
        np.testing.assert_array_equal(out.numpy(), expect)
        assert (n_tracked < 4) or not bool(out[1])


def test_klt_mode_config():
    """``kltMode`` takes the JAX package's values, every one the same KLT; an
    unknown one raises."""
    base = tracker_config_from_config({"GIFT": {}})
    for mode in ("auto", "gather", "mxu", "pallas"):
        assert tracker_config_from_config({"GIFT": {"kltMode": mode}}) == base
    cfg = load_config(os.path.join(REPO, "configs", "config_racing_proxy.yaml"))
    assert cfg["GIFT"]["kltMode"] == "mxu"
    tracker_config_from_config(cfg)
    with pytest.raises(ValueError, match="kltMode"):
        tracker_config_from_config({"GIFT": {"kltMode": "fast"}})


def test_racing_trajectory_matches_jax():
    """Positions to 1e-12 m.  The attitude's pitch is a second finite
    difference of the positions at 100 Hz (speed, then its gradient), which
    scales an ulp of ``sin`` by about 1e4: attitudes to 1e-11."""
    tj, pj = JSim.trajectory_poses("racing", 61.0, 100.0)
    tt_, pt = TSim.trajectory_poses("racing", 61.0, 100.0, device="cpu")
    np.testing.assert_array_equal(tt_.numpy(), np.asarray(tj))
    np.testing.assert_allclose(pt.x.numpy(), np.asarray(pj.x), atol=1e-12, rtol=0)
    np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), atol=1e-11, rtol=0)
    sj = JSim.Simulator.create(kind="racing", end_time=12.0, num_points=200, num_walls=6, wall_distance=4.0, seed=13)
    st = TSim.Simulator.create(kind="racing", end_time=12.0, num_points=200, num_walls=6, wall_distance=4.0, seed=13,
                               device="cpu")
    np.testing.assert_array_equal(st.world.numpy(), np.asarray(sj.world))
    ts = np.arange(3.5, 11.0, 0.31)
    imu_j = sj.get_imu_batch(jnp.asarray(ts))
    imu_t = st.get_imu_batch(tt(ts))
    gyr_t, acc_t = imu_t.gyr, imu_t.acc
    assert_tree_close((imu_j.gyr, imu_j.acc), (gyr_t, acc_t), 1e-8, "racing imu")


def test_uzhfpv_reader_and_synthetic_scene_match_jax_tree(uzh_tree):
    """The UZH-FPV reader on the JAX generator's tree, against the in-memory
    scene built from the same arguments: frames and stamps bit for bit, IMU
    and ground-truth rows to their 9th decimal (a last-digit flip is
    1e-9)."""
    disk = create_dataset_reader("uzhfpv", uzh_tree)
    mem = SyntheticUZHFPVReader(**READER_SCENE)
    assert disk.camera.model == mem.camera.model == "equidistant"
    assert disk.camera.resolution == mem.camera.resolution
    assert tuple(disk.camera.intrinsics) == tuple(mem.camera.intrinsics)
    assert tuple(disk.camera.distortion) == tuple(mem.camera.distortion)
    np.testing.assert_array_equal(mem.camera.T_BS, disk.camera.T_BS)
    np.testing.assert_array_equal(mem.images.stamps, disk.images.stamps)
    np.testing.assert_array_equal(mem.imu.stamps, disk.imu.stamps)
    for a, b in ((mem.imu.gyr, disk.imu.gyr), (mem.imu.acc, disk.imu.acc),
                 (mem.groundtruth.position, disk.groundtruth.position),
                 (mem.groundtruth.quaternion, disk.groundtruth.quaternion)):
        np.testing.assert_allclose(a, b, atol=1.01e-9, rtol=0)
    np.testing.assert_array_equal(mem.groundtruth.stamps, disk.groundtruth.stamps)
    assert len(mem.frames) == len(disk.images.stamps) == 53
    for i in range(len(mem.frames)):
        np.testing.assert_array_equal(mem.load_image_u8(i), disk.load_image_u8(i), err_msg=f"frame {i}")
    # the other formats' readers are served too: on this tree each finds none of its files
    for mode in ("anu", "rosbag", "hilti"):
        with pytest.raises(OSError):
            create_dataset_reader(mode, uzh_tree)


@pytest.fixture(scope="module")
def run_tree(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("uzh_run"))
    generate_uzhfpv_dataset(out, **RUN_SCENE)
    return out


def test_racing_config_run_matches_jax(run_tree, tmp_path):
    """``config_racing_proxy.yaml`` (InvDepth, fast Riccati, dense float64,
    equalisation, 40 features, fisheye camera) on a moving 320x240 UZH-FPV
    scene: the port's eager run from the tree and fused run from the
    in-memory scene against ``eqvio_tpu``'s per-frame run with identical
    tracked ids, pixels within 1e-3 px, positions within 1e-6 m over the
    first 20 frames and 1e-5 m over all 27, and the two port runs within
    1e-7 m of each other (the in-memory IMU rows may differ from the files'
    in their 9th decimal).  The trackers differ by float32 round-off alone,
    which tracks carry from frame to frame: 4e-6 px at frame 2, 3.4e-4 px by
    frame 19, 9e-4 px by frame 26, and 1.1e-6 m in the positions there."""
    cfg = load_config(os.path.join(REPO, "configs", "config_racing_proxy.yaml"))
    cfg_j = {**cfg, "GIFT": {**cfg["GIFT"], "kltMode": "gather"}}
    rows = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_run_opt, "VIOWriter", _recording_writer(jax_run_opt.VIOWriter, rows))
        _, sum_j = jax_run_opt.run_dataset(run_tree, cfg_j, mode="uzhfpv", output_dir=str(tmp_path / "jax"),
                                           chunk_size=1, dtype=jnp.float64)
    pos_j = np.stack([p for _, p in rows["states"]])
    ids_j = np.stack([np.where(m, i, -1) for _, i, m in rows["features"]])
    assert sum_j["frames"] == 27 and sum_j["healthy"]
    assert not torch_run_opt.settings_from_config(cfg).sqrt_covariance  # dense in float64
    runs = {}
    for dataset, chunk in ((run_tree, 1), (SyntheticUZHFPVReader(**RUN_SCENE), 8)):
        rows_t = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch_run_opt, "VIOWriter", _recording_writer(torch_run_opt.VIOWriter, rows_t))
            _, sum_t = torch_run_opt.run_dataset(dataset, cfg, mode="uzhfpv", output_dir=str(tmp_path / f"t{chunk}"),
                                                 device="cpu", chunk_size=chunk)
        assert sum_t["frames"] == sum_j["frames"] and sum_t["healthy"]
        assert sum_t["landmarks"] == sum_j["landmarks"] >= 10
        np.testing.assert_array_equal(sum_t["feature_ids"], ids_j, err_msg=f"chunk {chunk}")
        for k, ((px_j, _, m_j), (px_t, _, m_t)) in enumerate(zip(rows["features"], rows_t["features"])):
            np.testing.assert_allclose(px_t[m_t], px_j[m_j], atol=1e-3, rtol=0, err_msg=f"frame {k} pixels")
        np.testing.assert_allclose(sum_t["positions"][:20], pos_j[:20], atol=1e-6, rtol=0, err_msg=f"chunk {chunk}")
        np.testing.assert_allclose(sum_t["positions"], pos_j, atol=1e-5, rtol=0, err_msg=f"chunk {chunk}")
        runs[chunk] = sum_t["positions"]
    np.testing.assert_allclose(runs[8], runs[1], atol=1e-7, rtol=0)


def test_cli_passes_the_dataset_mode(monkeypatch):
    seen = {}

    def fake_run(dataset, config, **kwargs):
        seen.update(kwargs)
        return None, {"healthy": True, "frames": 0, "fps": 0.0, "landmarks": 0}

    monkeypatch.setattr(torch_run_opt, "load_config", lambda path: {})
    monkeypatch.setattr(torch_run_opt, "run_dataset", fake_run)
    torch_run_opt.main(["d", "c.yaml", "--mode", "uzhfpv", "--device", "cpu"])
    assert seen["mode"] == "uzhfpv" and seen["device"] == "cpu"
