"""Parity of the port's filter modes with ``eqvio_tpu`` in float64 on the CPU.

The Euclidean, inverse-depth and Normal coordinate suites; the fast,
accurate (matrix-exponential) and discrete Riccati steps in dense and
square-root covariance; the continuous velocity lift; the matrix
exponential over every Pade degree and squaring count; the dense vision
update; and ``run_dataset`` with ``configs/config_template.yaml``'s switches
(Euclidean, accurate Riccati, discrete innovation lift, median depth), dense
and square-root, eager and fused.  Inputs come from ``numpy`` seeds and go
through the JAX function and its port; outputs agree to 1e-9 (absolute,
relative above magnitude 1) unless a test says otherwise.
"""

import os

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_map

import eqvio_tpu.app.run_opt as jax_run_opt
import eqvio_tpu_torch.app.run_opt as torch_run_opt
from eqvio_tpu import camera as JCam
from eqvio_tpu import charts as JC
from eqvio_tpu import filter as JF
from eqvio_tpu import group as JG
from eqvio_tpu import matrices as JM
from eqvio_tpu.data import generate_asl_dataset
from eqvio_tpu.io import load_config
from eqvio_tpu_torch import camera as TCam
from eqvio_tpu_torch import charts as TC
from eqvio_tpu_torch import convert
from eqvio_tpu_torch import filter as TF
from eqvio_tpu_torch import group as TG
from eqvio_tpu_torch import matrices as TM
from eqvio_tpu_torch.data import SyntheticASLReader, SyntheticUZHFPVReader
from eqvio_tpu_torch.io import template_config
from tests.test_torch_core import (
    F64,
    NCAP,
    _frame_inputs,
    _jax_imu,
    _state_and_group,
    _torch_imu,
    assert_tree_close,
    tt,
)
from tests.test_torch_run_opt import _recording_writer, one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-9
SUITES = ["euclid", "invdepth", "normal"]
COVARIANCE = [False, True]
COV_IDS = ["dense", "sqrt"]


def _cameras(model: str):
    if model == "radtan":
        dist = (-0.28, 0.07, 2e-4, 1.8e-5)
        return (JCam.RadTanCamera.create(458.6, 457.3, 367.2, 248.4, dist, 752, 480),
                TCam.RadTanCamera.create(458.6, 457.3, 367.2, 248.4, dist, 752, 480, dtype=F64, device="cpu"))
    dist = (-0.0137, 0.0207, -0.0128, 0.0025)
    return (JCam.EquidistantCamera.create(278.66, 278.48, 319.75, 241.96, dist, 640, 480),
            TCam.EquidistantCamera.create(278.66, 278.48, 319.75, 241.96, dist, 640, 480, dtype=F64, device="cpu"))


# ---------------------------------------------------------------------------
# charts, lifts and the suites
# ---------------------------------------------------------------------------

CHART_CASES = {
    "point_chart_euclid": lambda C, xi, xi1: C.point_chart_euclid_inv(
        C.point_chart_euclid(xi1.landmarks, xi.landmarks), xi.landmarks),
    "point_chart_normal": lambda C, xi, xi1: C.point_chart_normal(xi1.landmarks, xi.landmarks),
    "point_chart_normal_inv": lambda C, xi, xi1: C.point_chart_normal_inv(
        C.point_chart_normal(xi1.landmarks, xi.landmarks), xi.landmarks),
    "sensor_chart_normal": lambda C, xi, xi1: C.sensor_chart_normal(xi1.sensor, xi.sensor),
    "sensor_chart_normal_inv": lambda C, xi, xi1: C.sensor_chart_normal_inv(
        C.sensor_chart_normal(xi1.sensor, xi.sensor), xi.sensor),
    "normal_diffs": lambda C, xi, xi1: (C.sphere_chart_normal.chart_diff0(xi.landmarks),
                                        C.sphere_chart_normal.chart_inv_diff0(xi.landmarks)),
    "state_chart_euclid": lambda C, xi, xi1: C.STATE_CHARTS["euclid"].chart_inv(
        C.STATE_CHARTS["euclid"].chart(xi1, xi), xi),
    "state_chart_normal": lambda C, xi, xi1: C.STATE_CHARTS["normal"].chart_inv(
        C.STATE_CHARTS["normal"].chart(xi1, xi), xi),
}


@pytest.mark.parametrize("case", sorted(CHART_CASES))
def test_charts_match_jax(case):
    (xi_j, X_j, _), (xi_t, X_t, _) = _state_and_group(6)
    out_j = CHART_CASES[case](JC, xi_j, JG.state_action(X_j, xi_j))
    out_t = CHART_CASES[case](TC, xi_t, TG.state_action(X_t, xi_t))
    assert_tree_close(out_j, out_t, 1e-12, case)


def test_continuous_velocity_lift_matches_jax():
    (xi_j, _, imu_j), (xi_t, _, imu_t) = _state_and_group(3)
    out_j = JG.group_exp(JG.algebra_scale(JG.lift_velocity(xi_j, imu_j), 0.01))
    out_t = TG.group_exp(TG.algebra_scale(TG.lift_velocity(xi_t, imu_t), 0.01))
    assert_tree_close(JG.lift_velocity(xi_j, imu_j), TG.lift_velocity(xi_t, imu_t), 1e-12, "lift")
    assert_tree_close(out_j, out_t, 1e-12, "exp of the scaled lift")


SUITE_CASES = {
    "state_matrix_A": lambda S, M, xi, X, imu, cam, px, g: S.state_matrix_A(X, xi, imu),
    "input_matrix_B": lambda S, M, xi, X, imu, cam, px, g: S.input_matrix_B(X, xi),
    "output_Ci_star": lambda S, M, xi, X, imu, cam, px, g: S.output_Ci_star(xi.landmarks, X.Q, cam, px),
    "output_Ci": lambda S, M, xi, X, imu, cam, px, g: S.output_Ci(xi.landmarks, X.Q, cam),
    "lift_innovation": lambda S, M, xi, X, imu, cam, px, g: S.lift_innovation(g, xi),
    "lift_innovation_discrete": lambda S, M, xi, X, imu, cam, px, g: S.lift_innovation_discrete(g, xi),
    "state_matrix_A_discrete": lambda S, M, xi, X, imu, cam, px, g: M.state_matrix_A_discrete(S, X, xi, imu, 0.005),
}


@pytest.mark.parametrize("suite", SUITES)
@pytest.mark.parametrize("case", sorted(SUITE_CASES))
def test_suite_matches_jax(case, suite):
    """A, B, C*, C, both innovation lifts and the discrete state matrix of
    each suite, with the radial-tangential camera (the fisheye one for C)."""
    (xi_j, X_j, imu_j), (xi_t, X_t, imu_t) = _state_and_group(8)
    cam_j, cam_t = _cameras("equidistant" if case.startswith("output") else "radtan")
    rng = np.random.default_rng(9)
    px = np.asarray(cam_j.project(JG.state_action(X_j, xi_j).landmarks)) + rng.normal(size=(8, 2))
    g = rng.normal(size=21 + 3 * 8) * 0.01
    fn_j = jax.jit(lambda *a: SUITE_CASES[case](JM.get_suite(suite), JM, *a))  # eager JAX AD is slow
    out_j = fn_j(xi_j, X_j, imu_j, cam_j, jnp.asarray(px), jnp.asarray(g))
    out_t = SUITE_CASES[case](TM.get_suite(suite), TM, xi_t, X_t, imu_t, cam_t, tt(px), tt(g))
    assert_tree_close(out_j, out_t, TOL if case == "state_matrix_A_discrete" else 1e-11, case)


FORWARD_AD_CASES = {  # (xi, X, imu, cast of the camera) -> Jacobian
    "radtan_projection_jacobian": lambda xi, X, imu, cast: cast(_cameras("radtan")[1]).projection_jacobian(
        xi.landmarks),
    "equidistant_projection_jacobian": lambda xi, X, imu, cast: cast(
        _cameras("equidistant")[1]).projection_jacobian(xi.landmarks),
    "normal_euclid_sensor_differential": lambda xi, X, imu, cast: TM.normal_euclid_sensor_differential(xi),
    "euclid_normal_sensor_differential": lambda xi, X, imu, cast: TM.euclid_normal_sensor_differential(xi),
    "state_matrix_A_discrete_normal": lambda xi, X, imu, cast: TM.state_matrix_A_discrete(
        TM.get_suite("normal"), X, xi, imu, 0.005),
    "state_matrix_A_discrete_invdepth": lambda xi, X, imu, cast: TM.state_matrix_A_discrete(
        TM.get_suite("invdepth"), X, xi, imu, 0.005),
}


@pytest.mark.parametrize("case", sorted(FORWARD_AD_CASES))
def test_forward_ad_jacobians_keep_float32(case):
    """The forward-AD Jacobians (``lie.jacfwd``) of float32 inputs are
    float32, with no cast, and equal the float64 ones to 1e-5 of their
    largest entry.  (Forward AD would promote a 0-dim float32 tangent that
    meets a Python number.)"""
    (_, _, _), (xi, X, imu) = _state_and_group(8)
    f32 = lambda t: tree_map(lambda a: a.float() if torch.is_tensor(a) and a.is_floating_point() else a, t)  # noqa: E731
    J64 = FORWARD_AD_CASES[case](xi, X, imu, lambda t: t)
    J32 = FORWARD_AD_CASES[case](f32(xi), f32(X), f32(imu), f32)
    assert J64.dtype == torch.float64 and J32.dtype == torch.float32
    scale = max(1.0, float(J64.abs().max()))
    assert float((J32.double() - J64).abs().max()) <= 1e-5 * scale


# ---------------------------------------------------------------------------
# the matrix exponential
# ---------------------------------------------------------------------------

# L1 norms that reach every Pade degree and squaring count of
# jax.scipy.linalg.expm: float64 degrees 3/5/7/9/13 below 0.015/0.25/0.95/2.1
# and squarings from 5.37 up (17 gives NaN); float32 degrees 3/5/7 below
# 0.43/1.88 and squarings from 3.93 up
EXPM_NORMS = {
    "float64": [0.01, 0.1, 0.5, 1.5, 3.0, 20.0, 1e3, 1.9e5, 3.9e5, 8e5],
    "float32": [0.1, 1.0, 3.0, 50.0, 4e3],
}


@pytest.mark.parametrize("dtype", sorted(EXPM_NORMS))
def test_expm_matches_jax_at_every_degree_and_squaring(dtype):
    """Skew-symmetric matrices plus a small general part, scaled to each L1
    norm (their exponentials stay bounded however many squarings run)."""
    rng = np.random.default_rng(5)
    n = 12
    tol = 1e-9 if dtype == "float64" else 2e-4
    for norm in EXPM_NORMS[dtype]:
        W = rng.normal(size=(n, n))
        M = (W - W.T) + 0.01 * rng.normal(size=(n, n))
        M *= norm / np.abs(M).sum(axis=0).max()
        M = M.astype(dtype)
        out_j = np.asarray(jsl.expm(jnp.asarray(M)))
        out_t = TF.expm(torch.tensor(M)).numpy()
        if np.isnan(out_j).all():
            assert np.isnan(out_t).all(), norm
            continue
        scale = max(1.0, float(np.abs(out_j).max()))
        np.testing.assert_allclose(out_t, out_j, atol=tol * scale, rtol=0, err_msg=f"L1 norm {norm}")
    n_sq = np.floor(np.log2(np.asarray(EXPM_NORMS["float64"]) / 5.371920351148152))
    assert n_sq.max() == 17 and 16 in n_sq and 15 in n_sq


# ---------------------------------------------------------------------------
# Riccati steps and the dense update
# ---------------------------------------------------------------------------


def _mode_settings(suite: str, sqrt: bool, **kw):
    return JF.Settings(measurement_noise=0.5, sqrt_covariance=sqrt, coordinate_choice=suite,
                       initial_scene_depth=4.0, outlier_threshold_abs=30.0, outlier_threshold_prob=20.0,
                       feature_retention=0.5, initial_point_var=2.0, **kw)


def _random_filter_state(suite: str, sqrt: bool, seed: int = 21):
    """A state with 6 of 8 slots active and a random positive-definite Sigma
    (or its lower factor), sanitized as the filter keeps it."""
    (xi_j, X_j, imu_j), (_, _, imu_t) = _state_and_group(seed)
    settings = _mode_settings(suite, sqrt)
    D = xi_j.dim()
    rng = np.random.default_rng(seed)
    G = rng.normal(size=(D, D)) * 0.1
    Sigma = G @ G.T + np.eye(D) * 0.05
    Sigma = np.asarray(JF.sanitize_sigma(jnp.asarray(Sigma), xi_j, JF.Settings(sqrt_covariance=False)))
    if sqrt:
        Sigma = np.linalg.cholesky(Sigma)
    st_j = JF.EqFState(xi_j, X_j, jnp.asarray(Sigma), jnp.asarray(0.3))
    return st_j, convert.eqf_state_from_numpy(st_j, F64, "cpu"), imu_j, imu_t, settings


RICCATI = {
    "fast": (JF.integrate_riccati_fast, TF.integrate_riccati_fast),
    "accurate": (JF.integrate_riccati_accurate, TF.integrate_riccati_accurate),
    "discrete": (JF.integrate_riccati_discrete, TF.integrate_riccati_discrete),
}


@pytest.mark.parametrize("sqrt", COVARIANCE, ids=COV_IDS)
@pytest.mark.parametrize("suite", SUITES)
@pytest.mark.parametrize("step", sorted(RICCATI))
def test_riccati_step_matches_jax(step, suite, sqrt):
    """One Riccati step at dt = 5 ms and at dt = 0 (a no-op in the
    per-sample steps); the factor is compared directly (``tria`` makes it
    unique)."""
    st_j, st_t, imu_j, imu_t, settings_j = _random_filter_state(suite, sqrt)
    settings_t = convert.settings_from_jax_settings(settings_j)
    fj, ft = RICCATI[step]
    fj = jax.jit(fj, static_argnums=(3, 4))
    for dt in (0.005, 0.0):
        if step == "fast" and dt == 0.0:
            continue
        out_j = fj(st_j, imu_j, dt, settings_j, settings_j.suite)
        out_t = ft(st_t, imu_t, tt(dt), settings_t, settings_t.suite)
        assert_tree_close(out_j.Sigma, out_t.Sigma, TOL, f"{step} Sigma at dt={dt}")
        if dt == 0.0 and sqrt:
            assert torch.equal(out_t.Sigma, st_t.Sigma)


@pytest.mark.parametrize("sqrt", COVARIANCE, ids=COV_IDS)
@pytest.mark.parametrize("riccati", ["accurate", "discrete", "fast-continuous-lift"])
def test_propagate_window_matches_jax(riccati, sqrt):
    """A padded IMU window through the per-sample paths (and fast Riccati
    with the per-sample continuous lift), Euclidean suite."""
    kw = {"accurate": dict(use_accurate_riccati=True), "discrete": dict(use_discrete_state_matrix=True),
          "fast-continuous-lift": dict(fast_riccati=True, use_discrete_velocity_lift=False)}[riccati]
    st_j, st_t, _, _, _ = _random_filter_state("euclid", sqrt)
    settings_j = _mode_settings("euclid", sqrt, **kw)
    settings_t = convert.settings_from_jax_settings(settings_j)
    imu, dts = _frame_inputs(np.random.default_rng(4), 0)
    out_j = jax.jit(JF.propagate_window, static_argnums=(3, 4, 5))(st_j, _jax_imu(imu), jnp.asarray(dts),
                                                                   settings_j, None, True)
    out_t = TF.propagate_window(st_t, _torch_imu(imu), tt(dts), settings_t, wide_factor=True)
    assert_tree_close(out_j, out_t, TOL, riccati)


def _frame_case(suite: str, sqrt: bool):
    """Mid-sequence state (three frames of JAX lifecycle and updates), and
    the next frame's inputs: slot 2 lost, slot 3 reused, slot 8 new, slot 5
    pushed 40 px off so the outlier gate fires."""
    settings_j = _mode_settings(suite, sqrt, fast_riccati=True, use_median_depth=True)
    cam_j = JCam.default_test_camera()
    cam_t = TCam.PinholeCamera.create(400.0, 400.0, 400.0, 240.0, 800, 480, dtype=F64, device="cpu")
    pts = np.random.default_rng(2).uniform(-0.5, 0.5, size=(NCAP, 3)) + [0, 0, 4.0]
    r = np.random.default_rng(11)
    st = JF.init_state(settings_j, NCAP, jnp.float64)
    ids0, mask0 = jnp.arange(NCAP), jnp.arange(NCAP) < 7

    @jax.jit
    def frame(st, imu, dts, pix):
        st = JF.propagate_window(st, imu, dts, settings_j, wide_factor=True)
        return JF.process_vision(st, pix, mask0, ids0, cam_j, settings_j)

    for k in range(3):
        imu, dts = _frame_inputs(r, k)
        st = frame(st, _jax_imu(imu), jnp.asarray(dts),
                   cam_j.project(jnp.asarray(pts)) + jnp.asarray(r.normal(size=(NCAP, 2)) * 0.3))
    noise = r.normal(size=(NCAP, 2)) * 0.3
    noise[5] += [40.0, 0.0]
    vis = np.arange(NCAP) < 7
    vis[2], vis[8] = False, True
    ids = np.arange(NCAP)
    ids[3], ids[8] = 103, 108
    pix = np.asarray(cam_j.project(jnp.asarray(pts))) + noise
    return settings_j, cam_j, cam_t, st, pix, vis, ids


@pytest.mark.parametrize("suite", SUITES)
def test_dense_vision_update_matches_jax(suite):
    """Dense covariance: ``outlier_mask``, ``update_vision`` and
    ``process_vision`` (with and without the update) from a mid-sequence
    state."""
    settings_j, cam_j, cam_t, st_j, pix, vis, ids = _frame_case(suite, sqrt=False)
    settings_t = convert.settings_from_jax_settings(settings_j)
    st_t = convert.eqf_state_from_numpy(st_j, F64, "cpu")
    args_j = (jnp.asarray(pix), jnp.asarray(vis))
    args_t = (tt(pix), torch.as_tensor(vis))

    @jax.jit
    def jax_side(st, pix, vis, ids):  # eager JAX AD (the Normal suite's) is slow
        return (JF.outlier_mask(st, pix, vis, cam_j, settings_j), JF.update_vision(st, pix, vis, cam_j, settings_j),
                [JF.process_vision(st, pix, vis, ids, cam_j, settings_j, do_update=u) for u in (False, True)])

    out_j, upd_j, proc_j = jax_side(st_j, *args_j, jnp.asarray(ids))
    out_t = TF.outlier_mask(st_t, *args_t, cam_t, settings_t)
    assert_tree_close(out_j, out_t, 0, "outlier mask")
    assert bool(out_t[5])
    assert_tree_close(upd_j, TF.update_vision(st_t, *args_t, cam_t, settings_t), TOL, "update_vision")
    for do_update, sj in zip((False, True), proc_j):
        s_t = TF.process_vision(st_t, *args_t, torch.as_tensor(ids), cam_t, settings_t, do_update=do_update)
        assert_tree_close(sj, s_t, TOL, f"process_vision(do_update={do_update})")
    hj, ht = JF.health_check(sj, settings_j), TF.health_check(s_t, settings_t)
    assert {k: bool(v) for k, v in hj.items()} == {k: bool(v) for k, v in ht.items()}
    assert bool(ht["sigma_pd"]) and not bool(ht["nan"])


# ---------------------------------------------------------------------------
# run_dataset with the template config's switches
# ---------------------------------------------------------------------------

# 20 Hz frames keep the per-sample window at 16 IMU samples, as on the benchmark scene
SCENE = dict(end_time=1.5, width=320, height=240, frame_freq=20.0, num_points=300)
FRAMES = 12


@pytest.fixture(scope="module")
def asl_scene(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("modes"))
    generate_asl_dataset(out, **SCENE)
    return out


def _template(sqrt: bool) -> dict:
    cfg = load_config(os.path.join(REPO, "configs", "config_template.yaml"))
    assert cfg == template_config()
    if sqrt:
        cfg["eqf"]["settings"]["useSqrtCovariance"] = True
    return cfg


@pytest.mark.parametrize("sqrt", COVARIANCE, ids=COV_IDS)
def test_template_config_run_matches_jax(asl_scene, tmp_path, sqrt):
    """The template config (Euclidean, accurate Riccati, discrete innovation
    lift, median depth) over 12 frames: the port's eager and fused runs
    against ``eqvio_tpu``'s per-frame run with identical tracked ids, pixels
    within 1e-3 px and positions within 1e-6 m; the fused run equals the
    eager one to 1e-9 m.  (The two float32 trackers differ by float32
    round-off alone, one 1.5e-5 px ulp on one frame of this scene.)"""
    cfg = _template(sqrt)
    settings = torch_run_opt.settings_from_config(cfg)
    assert settings.use_accurate_riccati and not settings.fast_riccati
    assert settings.coordinate_choice == "euclid" and settings.use_median_depth
    rows = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_run_opt, "VIOWriter", _recording_writer(jax_run_opt.VIOWriter, rows))
        _, sum_j = jax_run_opt.run_dataset(asl_scene, cfg, output_dir=str(tmp_path / "jax"), chunk_size=1,
                                           limit_frames=FRAMES, dtype=jnp.float64)
    pos_j = np.stack([p for _, p in rows["states"]])
    ids_j = np.stack([np.where(m, i, -1) for _, i, m in rows["features"]])
    runs = {}
    for chunk in (1, 5):
        rows_t = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch_run_opt, "VIOWriter", _recording_writer(torch_run_opt.VIOWriter, rows_t))
            state_t, sum_t = torch_run_opt.run_dataset(asl_scene, cfg, output_dir=str(tmp_path / f"t{chunk}"),
                                                       device="cpu", chunk_size=chunk, limit_frames=FRAMES)
        assert sum_t["frames"] == sum_j["frames"] == FRAMES
        assert sum_t["healthy"] and sum_j["healthy"] and sum_t["landmarks"] == sum_j["landmarks"] >= 10
        assert state_t.Sigma.shape == (state_t.xi0.dim(), state_t.xi0.dim())
        np.testing.assert_array_equal(sum_t["feature_ids"], ids_j, err_msg=f"chunk {chunk}")
        for k, ((px_j, _, m_j), (px_t, _, m_t)) in enumerate(zip(rows["features"], rows_t["features"])):
            np.testing.assert_allclose(px_t[m_t], px_j[m_j], atol=1e-3, rtol=0, err_msg=f"frame {k} pixels")
        np.testing.assert_allclose(sum_t["positions"], pos_j, atol=1e-6, rtol=0, err_msg=f"chunk {chunk}")
        runs[chunk] = sum_t["positions"]
    np.testing.assert_allclose(runs[5], runs[1], atol=1e-9, rtol=0)


SHIPPED_CONFIGS = ["config_template.yaml", "config_EuRoC.yaml", "config_v101_proxy.yaml", "config_mh03_proxy.yaml",
                   "config_UZHFPV.yaml", "config_racing_proxy.yaml"]


@pytest.mark.parametrize("name", SHIPPED_CONFIGS)
def test_every_shipped_config_runs(name):
    """Each config in ``configs/`` runs six fused frames through the port on
    a small in-memory scene of its dataset's kind (fisheye UZH-FPV for the
    UZH-FPV configs), in float64 and in float32 (which switches on
    square-root covariance): healthy, with tracked landmarks."""
    cfg = load_config(os.path.join(REPO, "configs", name))
    scene = dict(end_time=1.0, width=320, height=240, frame_freq=20.0, num_points=300)
    reader = SyntheticUZHFPVReader(**scene) if "UZHFPV" in name or "racing" in name else SyntheticASLReader(**scene)
    for dtype in (torch.float64, torch.float32):
        state, summary = torch_run_opt.run_dataset(reader, cfg, device="cpu", chunk_size=4, limit_frames=6,
                                                   dtype=dtype)
        assert summary["frames"] == 6 and summary["healthy"] and summary["landmarks"] >= 1, (name, dtype)
        assert bool(torch.isfinite(state.Sigma).all())
