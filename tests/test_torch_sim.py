"""Parity of the port's simulator, slot tracker, simulation-support filter
API, input preparation and EuRoC proxy scenes with ``eqvio_tpu`` in float64
on the CPU.

Tolerances: trajectories 1e-12; IMU and the cubic-fit truth 1e-9 (each
inverts a 4x4 normal matrix over 10 ms stamps, condition ~1e8); selected
and slot ids, windows and masks exactly; the filter functions 1e-10 (a QR
or a Cholesky factor lies between input and output); the prepared inputs
1e-12 where they are closed-form and 1e-9 where they pass the cubic fit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqvio_tpu import filter as JF
from eqvio_tpu import runner as JR
from eqvio_tpu import sim as JSim
from eqvio_tpu.camera import default_test_camera
from eqvio_tpu.data import synthetic as JSyn
from eqvio_tpu.io import load_config
from eqvio_tpu.io import sim_params_from_config as jax_sim_params
from eqvio_tpu.lie import se3_exp, se3_mul
from eqvio_tpu_torch import convert
from eqvio_tpu_torch import filter as TF
from eqvio_tpu_torch import runner as TR
from eqvio_tpu_torch import sim as TSim
from eqvio_tpu_torch.data import create_dataset_reader, distractor_proxy, mh03_proxy, v101_proxy
from eqvio_tpu_torch.io import mh03_proxy_config, sim_params_from_config, v101_proxy_config
from tests.test_torch_core import F64, NCAP, _filter_settings, _mid_sequence_state, assert_tree_close, tt
from tests.test_torch_run_opt import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ["line", "wave", "sine", "square", "room", "v101", "mh", "machine_hall"]


@pytest.mark.parametrize("kind", KINDS)
def test_trajectory_kinds_match_jax(kind):
    tj, pj = JSim.trajectory_poses(kind, 70.0, 100.0)
    tt_, pt = TSim.trajectory_poses(kind, 70.0, 100.0, device="cpu")
    np.testing.assert_array_equal(tt_.numpy(), np.asarray(tj))
    assert_tree_close(pj, pt, 1e-12, kind)


def test_unknown_trajectory_kind_raises():
    with pytest.raises(ValueError, match="unknown trajectory"):
        JSim.trajectory_poses("spiral", 5.0, 100.0)
    with pytest.raises(ValueError, match="unknown trajectory"):
        TSim.trajectory_poses("spiral", 5.0, 100.0, device="cpu")


def _sims(kind, **kw):
    args = dict(kind=kind, end_time=8.0, num_points=120, num_walls=4, seed=3, **kw)
    return JSim.Simulator.create(**args), TSim.Simulator.create(**args, device="cpu")


@pytest.mark.parametrize("kind", ["line", "mh"])
def test_simulator_queries_match_jax(kind):
    """IMU, the exact true state and the per-frame selection (in both forms)
    of a scene, batched over stamps, against the JAX package's vmap."""
    sj, st = _sims(kind)
    np.testing.assert_array_equal(st.world.numpy(), np.asarray(sj.world))
    ts = np.arange(0.25, 7.0, 0.05)
    imu_j = sj.get_imu_batch(jnp.asarray(ts))
    imu_t = st.get_imu_batch(tt(ts))
    assert_tree_close(imu_j, imu_t, 1e-9, "imu")
    full_j = jax.vmap(sj.full_state)(jnp.asarray(ts))
    full_t = st.full_state(tt(ts))
    assert_tree_close(full_j.sensor, full_t.sensor, 1e-9, "true sensor")
    assert_tree_close(full_j.landmarks, full_t.landmarks, 1e-9, "true landmarks")
    np.testing.assert_array_equal(full_t.ids.numpy(), np.asarray(full_j.ids))
    np.testing.assert_array_equal(full_t.mask.numpy(), np.asarray(full_j.mask))

    cam_j = JR.default_sim_camera()
    cam_t = TR.default_sim_camera(device="cpu")
    pts_j, sel_j = jax.vmap(lambda t: sj.get_vision(t, cam_j, 12))(jnp.asarray(ts))
    pts_t, sel_t = st.get_vision(tt(ts), cam_t, 12)
    assert_tree_close(pts_j, pts_t, 1e-12, "camera points")
    np.testing.assert_array_equal(sel_t.numpy(), np.asarray(sel_j))
    assert sel_t.any(dim=1).all() and (sel_t.sum(dim=1) <= 12).all()
    ids_j, cpts_j = jax.vmap(lambda t: sj.get_vision_compact(t, cam_j, 12))(jnp.asarray(ts))
    ids_t, cpts_t = st.get_vision_compact(tt(ts), cam_t, 12)
    np.testing.assert_array_equal(ids_t.numpy(), np.asarray(ids_j))
    assert_tree_close(cpts_j, cpts_t, 1e-12, "compact points")


def test_from_poses_matches_jax():
    sj, st = _sims("wave")
    fj = JSim.Simulator.from_poses(sj.times[::3], jax.tree.map(lambda a: a[::3], sj.poses), sj.camera_offset,
                                   num_points=90, num_walls=6, seed=4)
    ft = TSim.Simulator.from_poses(st.times[::3], TSim.SE3(st.poses.R[::3], st.poses.x[::3]), st.camera_offset,
                                   num_points=90, num_walls=6, seed=4, device="cpu")
    assert_tree_close((fj.times, fj.poses, fj.world), (ft.times, ft.poses, ft.world), 1e-12, "from_poses")
    ts = np.arange(0.3, 5.0, 0.3)
    assert_tree_close(fj.get_imu_batch(jnp.asarray(ts)), ft.get_imu_batch(tt(ts)), 1e-9, "from_poses imu")


def _selections(rng, P, steps):
    """Per-step visibility masks that persist, drop and add points."""
    sel = rng.uniform(size=P) < 0.3
    out = []
    for _ in range(steps):
        flip = rng.uniform(size=P) < 0.12
        sel = np.where(flip, ~sel, sel)
        out.append(sel.copy())
    return out


@pytest.mark.parametrize("capacity,max_features", [(8, 6), (6, 10)])
def test_slot_trackers_and_gathers_match_jax(capacity, max_features):
    """Both tracker steps and both gathers over a sequence whose selections
    persist, drop and add points (free slots both scarce and plentiful):
    slot ids, visibility and ids exactly, pixels and points to 1e-12."""
    rng = np.random.default_rng(capacity)
    P = 40
    cam_j, cam_t = JR.default_sim_camera(), TR.default_sim_camera(device="cpu")
    tj = tjc = JSim.slot_tracker_init(capacity)
    ts = tsc = TSim.slot_tracker_init(capacity, device="cpu")
    for k, sel in enumerate(_selections(rng, P, 30)):
        rank = np.cumsum(sel) - 1
        sel = sel & (rank < max_features)
        cam_pts = rng.uniform(-1, 1, size=(P, 3)) + [0.0, 0.0, 4.0]
        ids = np.where(sel, np.arange(P), P)
        first = np.sort(ids)[:max_features]
        sel_ids = np.where(first < P, first, -1)
        sel_pts = np.where((first < P)[:, None], cam_pts[np.clip(first, 0, P - 1)], [0.0, 0.0, 1.0])

        tj = JSim.slot_tracker_step(tj, jnp.asarray(sel))
        ts = TSim.slot_tracker_step(ts, torch.as_tensor(sel))
        np.testing.assert_array_equal(ts.slot_ids.numpy(), np.asarray(tj.slot_ids), err_msg=f"step {k}")
        tjc = JSim.slot_tracker_step_compact(tjc, jnp.asarray(sel_ids, dtype=jnp.int32))
        tsc = TSim.slot_tracker_step_compact(tsc, torch.as_tensor(sel_ids))
        np.testing.assert_array_equal(tsc.slot_ids.numpy(), np.asarray(tjc.slot_ids), err_msg=f"compact {k}")
        np.testing.assert_array_equal(tsc.slot_ids.numpy(), ts.slot_ids.numpy())

        out_j = JSim.gather_slots(jnp.asarray(cam_pts), tj, cam_j)
        out_t = TSim.gather_slots(tt(cam_pts), ts, cam_t)
        out_jc = JSim.gather_slots_compact(jnp.asarray(sel_ids, dtype=jnp.int32), jnp.asarray(sel_pts), tjc, cam_j)
        out_tc = TSim.gather_slots_compact(torch.as_tensor(sel_ids), tt(sel_pts), tsc, cam_t)
        for name, oj, ot in (("gather", out_j, out_t), ("compact gather", out_jc, out_tc)):
            assert_tree_close(oj[0], ot[0], 1e-12, f"{name} pixels {k}")
            np.testing.assert_array_equal(ot[1].numpy(), np.asarray(oj[1]))
            np.testing.assert_array_equal(ot[2].numpy(), np.asarray(oj[2]))
            assert_tree_close(oj[3], ot[3], 1e-12, f"{name} points {k}")


def test_build_imu_windows_matches_jax():
    imu_times = np.arange(0.2, 3.0, 1.0 / 200.0)
    frame_times = np.arange(0.2 + 1.0 / 17.0, 3.0, 1.0 / 17.0)  # windows of unequal length
    for got, want in zip(TR.build_imu_windows(imu_times, frame_times, 0.2),
                         JR.build_imu_windows(imu_times, frame_times, 0.2)):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module", params=["sqrt", "dense"])
def mid_state(request):
    """A JAX filter state after three frames and its port, with the
    settings (square-root or dense covariance) and a slot-aligned true state."""
    settings_j = _filter_settings(False, False)
    if request.param == "dense":
        settings_j = dataclasses.replace(settings_j, sqrt_covariance=False)
    pts = np.random.default_rng(2).uniform(-0.5, 0.5, size=(NCAP, 3)) + [0, 0, 4.0]
    st_j, r = _mid_sequence_state(settings_j, default_test_camera(), pts)
    est = JF.state_estimate(st_j)
    true_j = est._replace(
        sensor=est.sensor._replace(pose=se3_mul(est.sensor.pose, se3_exp(jnp.asarray(r.normal(size=6) * 0.02))),
                                   velocity=est.sensor.velocity + jnp.asarray(r.normal(size=3) * 0.05)),
        landmarks=est.landmarks + jnp.asarray(r.normal(size=(NCAP, 3)) * 0.05),
    )
    return (settings_j, st_j, true_j), (convert.settings_from_jax_settings(settings_j),
                                        convert.eqf_state_from_numpy(st_j, F64, "cpu"),
                                        convert.vio_state_from_numpy(true_j, F64, "cpu"))


SUPPORT = {
    "set_state": lambda M, s, st, xi, c: M.set_state(st, xi, s),
    "set_landmarks": lambda M, s, st, xi, c: M.set_landmarks(st, xi.landmarks, xi.ids, c(np.arange(NCAP) % 3 > 0),
                                                             s),
    "augment_landmarks": lambda M, s, st, xi, c: M.augment_landmarks(st, c(np.arange(NCAP) >= 7), xi.ids + 100,
                                                                     xi.landmarks, s),
    "remove_invalid_landmarks": lambda M, s, st, xi, c: M.remove_invalid_landmarks(
        st._replace(X=st.X._replace(Q=st.X.Q._replace(a=st.X.Q.a * c(np.where(np.arange(NCAP) == 2, 1e-10, 1.0))))),
        s),
    "compute_nees": lambda M, s, st, xi, c: M.compute_nees(st, xi, None, s),
    "consistency_outputs": lambda M, s, st, xi, c: M.consistency_outputs(st, xi, None, s),
}


@pytest.mark.parametrize("fn", sorted(SUPPORT))
def test_sim_support_filter_functions_match_jax(mid_state, fn):
    (sj, st_j, true_j), (s_t, st_t, true_t) = mid_state
    out_j = SUPPORT[fn](JF, sj, st_j, true_j, jnp.asarray)
    out_t = SUPPORT[fn](TF, s_t, st_t, true_t, lambda a: torch.as_tensor(a, dtype=F64 if a.dtype.kind == "f"
                                                                          else None))
    if fn == "consistency_outputs":
        lm_j, lm_t = np.asarray(out_j[-1]), out_t[-1].numpy()
        np.testing.assert_array_equal(np.isnan(lm_t), ~np.asarray(st_j.xi0.mask))  # NaN on inactive slots
        np.testing.assert_array_equal(np.isnan(lm_t), np.isnan(lm_j))
        assert_tree_close(np.nan_to_num(lm_j), np.nan_to_num(lm_t), 1e-10, "landmark errors")
        out_j, out_t = out_j[:-1], out_t[:-1]
    if fn == "remove_invalid_landmarks":
        assert not bool(out_t.xi0.mask[2]) and bool(st_t.xi0.mask[2])
    assert_tree_close(out_j, out_t, 1e-10, fn)
    if fn == "compute_nees":  # one factor, however the covariance is held
        total, *_ = TF.consistency_outputs(st_t, true_t, None, s_t)
        torch.testing.assert_close(out_t, total, rtol=1e-10, atol=0)
        assert all(torch.isfinite(v) for v in TF.compute_nees_breakdown(st_t, true_t, None, s_t))


@pytest.mark.parametrize("full_state", [False, True])
def test_prepare_sim_inputs_matches_jax(full_state):
    """Every prepared input with all three noise switches on."""
    sj = JF.Settings(measurement_noise=0.5)
    kw = dict(capacity=12, max_features=10, end_time=2.0, num_points=60 if full_state else 150, kind="sine",
              input_noise=True, output_noise=True, initial_noise=True, noise_seed=7, full_state=full_state)
    ij = JR.prepare_sim_inputs(sj, **kw)
    it = TR.prepare_sim_inputs(convert.settings_from_jax_settings(sj), **kw)
    assert it.capacity == ij.capacity == (60 if full_state else 12) and it.max_features == ij.max_features
    np.testing.assert_array_equal(it.idx.numpy(), np.asarray(ij.idx))
    np.testing.assert_array_equal(it.sel_ids.numpy(), np.asarray(ij.sel_ids))
    for name in ("ftimes", "dts", "pixel_noise", "sel_pts"):
        assert_tree_close(getattr(ij, name), getattr(it, name), 1e-12, name)
    assert_tree_close(ij.sim, it.sim, 1e-12, "sim")
    assert_tree_close(ij.imu_all, it.imu_all, 1e-9, "imu")
    assert_tree_close(ij.state0, it.state0, 1e-9, "state0")
    for name in ("true_pos", "true_R", "true_vel"):
        assert_tree_close(getattr(ij, name), getattr(it, name), 1e-9, name)
    if full_state:
        assert_tree_close(ij.true_lm_full, it.true_lm_full, 1e-9, "true_lm_full")
    else:
        assert ij.true_lm_full is None and it.true_lm_full is None


@pytest.mark.parametrize("name", ["mh03", "v101"])
def test_proxy_configs_match_yaml(name):
    fn = {"mh03": mh03_proxy_config, "v101": v101_proxy_config}[name]
    assert fn() == load_config(os.path.join(REPO, "configs", f"config_{name}_proxy.yaml"))


def test_sim_params_from_config_matches_jax():
    cfg = {"sim": {"trajectory": "square", "duration": 12, "imuFreq": 400, "imageFreq": 25, "maxFeatures": 20,
                   "numPoints": 300, "numWalls": 6, "randomSeed": 9, "inputNoise": 1, "outputNoise": 0,
                   "wallDistance": 3.0}}
    assert sim_params_from_config(cfg) == jax_sim_params(cfg)
    assert sim_params_from_config({}) == jax_sim_params({}) == {}


PROXIES = {
    "v101": (JSyn.generate_v101_proxy, v101_proxy, {}),
    "mh03": (JSyn.generate_mh03_proxy, mh03_proxy, {}),
    "distractor": (JSyn.generate_distractor_proxy, distractor_proxy, {"num_distractors": 8}),
}


@pytest.mark.parametrize("name", sorted(PROXIES))
def test_proxy_readers_match_jax_tree(tmp_path, name):
    """Each in-memory EuRoC proxy against the JAX generator's tree, read back
    by the ASL reader, at a cut length: the camera, IMU rows and ground truth
    to their 9th decimal, stamps and the first frames bit for bit."""
    gen, reader, kw = PROXIES[name]
    gen(str(tmp_path), end_time=1.0, **kw)
    disk = create_dataset_reader("asl", str(tmp_path))
    mem = reader(end_time=1.0, **kw)
    assert disk.camera.model == mem.camera.model == "radtan"
    assert tuple(disk.camera.resolution) == tuple(mem.camera.resolution) == (752, 480)
    np.testing.assert_allclose(disk.camera.intrinsics, mem.camera.intrinsics, rtol=0, atol=0)
    np.testing.assert_allclose(disk.camera.distortion, mem.camera.distortion, rtol=0, atol=0)
    np.testing.assert_allclose(disk.camera.T_BS, mem.camera.T_BS, atol=1e-12)
    np.testing.assert_array_equal(disk.imu.stamps, mem.imu.stamps)
    np.testing.assert_allclose(disk.imu.gyr, mem.imu.gyr, atol=1.01e-9, rtol=0)  # a last-digit flip is 1e-9
    np.testing.assert_allclose(disk.imu.acc, mem.imu.acc, atol=1.01e-9, rtol=0)
    np.testing.assert_array_equal(disk.groundtruth.stamps, mem.groundtruth.stamps)
    assert len(mem.groundtruth.stamps) == 80  # 100 Hz ground truth
    for a, b in ((disk.groundtruth.position, mem.groundtruth.position),
                 (disk.groundtruth.quaternion, mem.groundtruth.quaternion),
                 (disk.groundtruth.velocity, mem.groundtruth.velocity)):
        np.testing.assert_allclose(a, b, atol=1.01e-9, rtol=0)
    np.testing.assert_array_equal(disk.images.stamps, mem.images.stamps)
    for i in (0, 1, len(mem.images.stamps) - 1):
        np.testing.assert_array_equal(disk.load_image_u8(i), mem.load_image_u8(i))
