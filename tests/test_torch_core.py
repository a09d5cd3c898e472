"""Parity of the PyTorch port's filter math with ``eqvio_tpu`` in float64.

Inputs come from ``numpy.random.default_rng`` seeds (via the JAX test
generators in ``tests/utils.py``), go through the JAX function and its port,
and the outputs are compared at ``1e-12`` for the closed-form modules
(absolute, relative for entries above magnitude 1) and ``1e-9`` for the
filter steps (a QR and a triangular solve of a ~50x100 factor lie between
input and output).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqvio_tpu import camera as JCam
from eqvio_tpu import charts as JC
from eqvio_tpu import filter as JF
from eqvio_tpu import group as JG
from eqvio_tpu import lie as JL
from eqvio_tpu import matrices as JM
from eqvio_tpu import sim as JSim
from eqvio_tpu import states as JS
from eqvio_tpu_torch import camera as TCam
from eqvio_tpu_torch import charts as TC
from eqvio_tpu_torch import convert
from eqvio_tpu_torch import filter as TF
from eqvio_tpu_torch import group as TG
from eqvio_tpu_torch import lie as TL
from eqvio_tpu_torch import matrices as TM
from eqvio_tpu_torch import sim as TSim
from eqvio_tpu_torch import states as TS
from tests.utils import reasonable_group, reasonable_state

F64 = torch.float64
TOL = 1e-12


def tt(x):
    return torch.as_tensor(np.array(x), dtype=F64)


def assert_tree_close(j, t, atol, path="out"):
    """Compare a JAX result with its port, NamedTuple field by field."""
    if hasattr(j, "_fields"):
        assert tuple(j._fields) == tuple(t._fields), path
        for name in j._fields:
            assert_tree_close(getattr(j, name), getattr(t, name), atol, f"{path}.{name}")
        return
    if isinstance(j, (tuple, list)):
        for k, (a, b) in enumerate(zip(j, t)):
            assert_tree_close(a, b, atol, f"{path}[{k}]")
        return
    a = np.asarray(j)
    b = t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert a.shape == b.shape, (path, a.shape, b.shape)
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        # absolute below magnitude 1, relative above (C* entries reach ~1e3)
        scale = max(1.0, float(np.abs(a).max())) if a.size else 1.0
        np.testing.assert_allclose(b, a, atol=atol * scale, rtol=0, err_msg=path)


def _vectors(rng, n=16):
    w = rng.normal(size=(n, 3))
    w[0] = 0.0
    w[1] = [1e-9, -2e-9, 5e-10]  # small-angle branches
    w[2] = [np.pi - 1e-9, 0.0, 0.0]  # near pi
    w[3] = [0.0, 0.0, -np.pi + 1e-6]
    return w


# ---------------------------------------------------------------------------
# lie
# ---------------------------------------------------------------------------

LIE_CASES = {
    "so3_exp": lambda L, w, u6, u9: L.so3_exp(w),
    "so3_log": lambda L, w, u6, u9: L.so3_log(L.so3_exp(w)),
    "so3_project": lambda L, w, u6, u9: L.so3_project(L.so3_exp(w) * 1.001),
    "so3_from_vectors": lambda L, w, u6, u9: L.so3_from_vectors(w, u6[..., 0:3]),
    "so3_from_vectors_antiparallel": lambda L, w, u6, u9: L.so3_from_vectors(w[4:], -w[4:]),
    "se3_exp": lambda L, w, u6, u9: L.se3_exp(u6),
    "se3_log": lambda L, w, u6, u9: L.se3_log(L.se3_exp(u6)),
    "se3_Adjoint": lambda L, w, u6, u9: L.se3_Adjoint(L.se3_exp(u6)),
    "se3_adjoint": lambda L, w, u6, u9: L.se3_adjoint(u6),
    "sot3_exp_log": lambda L, w, u6, u9: L.sot3_log(L.sot3_exp(u6[..., 0:4])),
    "se23_exp": lambda L, w, u6, u9: L.se23_exp(u9),
    "se23_log": lambda L, w, u6, u9: L.se23_log(L.se23_exp(u9)),
}


@pytest.mark.parametrize("case", sorted(LIE_CASES))
def test_lie_matches_jax(case):
    rng = np.random.default_rng(1)
    w = _vectors(rng)
    u6 = np.concatenate([w, rng.normal(size=(len(w), 3))], axis=-1)
    u9 = np.concatenate([u6, rng.normal(size=(len(w), 3))], axis=-1)
    fn = LIE_CASES[case]
    out_j = fn(JL, jnp.asarray(w), jnp.asarray(u6), jnp.asarray(u9))
    out_t = fn(TL, tt(w), tt(u6), tt(u9))
    assert_tree_close(out_j, out_t, TOL, case)


# ---------------------------------------------------------------------------
# states, group, charts
# ---------------------------------------------------------------------------


def _state_and_group(seed, n=8, n_active=6):
    rng = np.random.default_rng(seed)
    xi = reasonable_state(rng, n, n_active)
    X = reasonable_group(rng, n)
    imu = JS.IMU.create(0.3, jnp.asarray(rng.normal(size=3)), jnp.asarray(rng.normal(size=3) + [0, 0, 9.8]))
    return (xi, X, imu), (
        convert.vio_state_from_numpy(xi, F64, "cpu"),
        convert.group_from_numpy(X, F64, "cpu"),
        TS.IMU(tt(imu.stamp), tt(imu.gyr), tt(imu.acc), tt(imu.gyr_bias_vel), tt(imu.acc_bias_vel)),
    )


GROUP_CASES = {
    "group_mul": lambda G, xi, X, imu, lam: G.group_mul(X, G.group_exp(lam)),
    "group_inv": lambda G, xi, X, imu, lam: G.group_inv(X),
    "group_exp": lambda G, xi, X, imu, lam: G.group_exp(lam),
    "state_action": lambda G, xi, X, imu, lam: G.state_action(X, xi),
    "lift_velocity_discrete": lambda G, xi, X, imu, lam: G.lift_velocity_discrete(xi, imu, 0.01),
    "group_element_between": lambda G, xi, X, imu, lam: G.group_element_between(xi, G.state_action(X, xi)),
    "group_normalize": lambda G, xi, X, imu, lam: G.group_normalize(G.group_mul(X, X)),
}


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_group_matches_jax(case):
    (xi_j, X_j, imu_j), (xi_t, X_t, imu_t) = _state_and_group(3)
    rng = np.random.default_rng(13)
    parts = [rng.normal(size=s) * 0.2 for s in ((6,), (6,), (3,), (6,), (8, 4))]
    lam_j = JG.VIOAlgebra(*(jnp.asarray(p) for p in parts))
    lam_t = TG.VIOAlgebra(*(tt(p) for p in parts))
    out_j = GROUP_CASES[case](JG, xi_j, X_j, imu_j, lam_j)
    out_t = GROUP_CASES[case](TG, xi_t, X_t, imu_t, lam_t)
    assert_tree_close(out_j, out_t, TOL, case)


@pytest.mark.parametrize("dt", [0.0, 0.005])
def test_integrate_system_matches_jax(dt):
    (xi_j, _, imu_j), (xi_t, _, imu_t) = _state_and_group(4)
    out_j = JS.integrate_system(xi_j, imu_j, dt)
    out_t = TS.integrate_system(xi_t, imu_t, torch.tensor(dt, dtype=F64))
    assert_tree_close(out_j, out_t, TOL, "integrate_system")


def test_measure_system_and_output_action_match_jax():
    (xi_j, X_j, _), (xi_t, X_t, _) = _state_and_group(5)
    cam_j = JCam.default_test_camera()
    cam_t = TCam.PinholeCamera.create(400.0, 400.0, 400.0, 240.0, 800, 480, dtype=F64, device="cpu")
    assert_tree_close(JS.measure_system(xi_j, cam_j), TS.measure_system(xi_t, cam_t), TOL)
    px = JS.measure_system(xi_j, cam_j)[0]
    assert_tree_close(JG.output_action(X_j, px, cam_j), TG.output_action(X_t, tt(px), cam_t), TOL)


CHART_CASES = {
    "point_chart_invdepth": lambda C, xi, xi1: C.point_chart_invdepth(xi1.landmarks, xi.landmarks),
    "point_chart_invdepth_inv": lambda C, xi, xi1: C.point_chart_invdepth_inv(
        C.point_chart_invdepth(xi1.landmarks, xi.landmarks), xi.landmarks),
    "sensor_chart_std": lambda C, xi, xi1: C.sensor_chart_std(xi1.sensor, xi.sensor),
    "sensor_chart_std_inv": lambda C, xi, xi1: C.sensor_chart_std_inv(
        C.sensor_chart_std(xi1.sensor, xi.sensor), xi.sensor),
    "state_chart_invdepth": lambda C, xi, xi1: C.state_chart_invdepth.chart(xi1, xi),
    "state_chart_invdepth_inv": lambda C, xi, xi1: C.state_chart_invdepth.chart_inv(
        C.state_chart_invdepth.chart(xi1, xi), xi),
    "invdepth_euclid_block": lambda C, xi, xi1: C.invdepth_euclid_block(xi.landmarks),
    "euclid_invdepth_block": lambda C, xi, xi1: C.euclid_invdepth_block(xi.landmarks),
    "sphere_diffs": lambda C, xi, xi1: (
        C.e3_project_sphere_diff(xi.landmarks / 30.0), C.e3_project_sphere_inv_diff(xi.landmarks[:, :2])),
}


@pytest.mark.parametrize("case", sorted(CHART_CASES))
def test_charts_match_jax(case):
    (xi_j, X_j, _), (xi_t, X_t, _) = _state_and_group(6)
    out_j = CHART_CASES[case](JC, xi_j, JG.state_action(X_j, xi_j))
    out_t = CHART_CASES[case](TC, xi_t, TG.state_action(X_t, xi_t))
    assert_tree_close(out_j, out_t, TOL, case)


# ---------------------------------------------------------------------------
# cameras and the InvDepth suite
# ---------------------------------------------------------------------------


def _cameras():
    dist = (-0.28, 0.07, 2e-4, 1.8e-5)
    return [
        (JCam.PinholeCamera.create(458.6, 457.3, 367.2, 248.4, 752, 480),
         TCam.PinholeCamera.create(458.6, 457.3, 367.2, 248.4, 752, 480, dtype=F64, device="cpu")),
        (JCam.RadTanCamera.create(458.6, 457.3, 367.2, 248.4, dist, 752, 480),
         TCam.RadTanCamera.create(458.6, 457.3, 367.2, 248.4, dist, 752, 480, dtype=F64, device="cpu")),
    ]


@pytest.mark.parametrize("model", [0, 1], ids=["pinhole", "radtan"])
def test_camera_matches_jax(model):
    cam_j, cam_t = _cameras()[model]
    rng = np.random.default_rng(7)
    p = rng.uniform(-1, 1, size=(32, 3)) + [0, 0, 2.5]
    p[0, 2] = 0.0  # the z-guard
    px = rng.uniform([0, 0], [752, 480], size=(32, 2))
    for name, a, b in (
        ("project", cam_j.project(jnp.asarray(p)), cam_t.project(tt(p))),
        ("undistort", cam_j.undistort(jnp.asarray(px)), cam_t.undistort(tt(px))),
        ("jacobian", cam_j.projection_jacobian(jnp.asarray(p[1:])), cam_t.projection_jacobian(tt(p[1:]))),
        ("in_domain", cam_j.is_in_domain(jnp.asarray(p)), cam_t.is_in_domain(tt(p))),
    ):
        assert_tree_close(a, b, TOL, name)


MATRIX_CASES = {
    "state_matrix_A": lambda M, xi, X, imu, cam, px, g: M.state_matrix_A_invdepth(X, xi, imu),
    "input_matrix_B": lambda M, xi, X, imu, cam, px, g: M.input_matrix_B_invdepth(X, xi),
    "output_Ci_star": lambda M, xi, X, imu, cam, px, g: M.output_matrix_Ci_star_invdepth(
        xi.landmarks, X.Q, cam, px),
    "output_Ci": lambda M, xi, X, imu, cam, px, g: M.output_matrix_Ci_invdepth(xi.landmarks, X.Q, cam),
    "lift_innovation": lambda M, xi, X, imu, cam, px, g: M.lift_innovation_invdepth(g, xi),
    "lift_innovation_discrete": lambda M, xi, X, imu, cam, px, g: M.lift_innovation_discrete_invdepth(g, xi),
}


@pytest.mark.parametrize("model", [0, 1], ids=["pinhole", "radtan"])
@pytest.mark.parametrize("case", sorted(MATRIX_CASES))
def test_invdepth_suite_matches_jax(case, model):
    (xi_j, X_j, imu_j), (xi_t, X_t, imu_t) = _state_and_group(8)
    cam_j, cam_t = _cameras()[model]
    rng = np.random.default_rng(9)
    px = np.asarray(JS.measure_system(JG.state_action(X_j, xi_j), cam_j)[0]) + rng.normal(size=(8, 2))
    g = rng.normal(size=21 + 3 * 8) * 0.01
    out_j = MATRIX_CASES[case](JM, xi_j, X_j, imu_j, cam_j, jnp.asarray(px), jnp.asarray(g))
    out_t = MATRIX_CASES[case](TM, xi_t, X_t, imu_t, cam_t, tt(px), tt(g))
    assert_tree_close(out_j, out_t, TOL, case)


# ---------------------------------------------------------------------------
# the public names the surface audit found missing, ported in one slice
# ---------------------------------------------------------------------------


class _Pkg:
    """One package's modules and its creation arguments (the port takes a
    dtype and a device where ``eqvio_tpu`` takes a dtype or nothing)."""

    def __init__(self, jax_side):
        self.jax = jax_side
        self.L, self.G, self.S, self.Cam, self.M = (JL, JG, JS, JCam, JM) if jax_side else (TL, TG, TS, TCam, TM)
        self.arr = jnp.asarray if jax_side else tt
        self.dtype = jnp.float64 if jax_side else F64
        self.dev = {} if jax_side else {"device": "cpu"}


def _surface_inputs(p: _Pkg):
    rng = np.random.default_rng(21)
    u4 = p.arr(rng.normal(size=(6, 4)) * 0.7)
    x = p.arr(rng.normal(size=(6, 3)))
    lam = [p.G.VIOAlgebra(*(p.arr(rng.normal(size=s) * 0.2) for s in ((6,), (6,), (3,), (6,), (5, 4))))
           for _ in range(2)]
    imu = [p.arr(v) for v in (0.25, rng.normal(size=3), rng.normal(size=3), rng.normal(size=3),
                              rng.normal(size=3))]
    xi = reasonable_state(np.random.default_rng(22), 5, 4)
    if not p.jax:
        xi = convert.vio_state_from_numpy(xi, F64, "cpu")
    return u4, x, lam, imu, xi


SURFACE_CASES = {
    "lie.sot3_apply": lambda p, u4, x, lam, imu, xi: p.L.sot3_apply(p.L.sot3_exp(u4), x),
    "lie.sot3_Adjoint_inv_of": lambda p, u4, x, lam, imu, xi: p.L.sot3_Adjoint_inv_of(p.L.sot3_exp(u4)),
    "lie.SE3.batch_shape": lambda p, u4, x, lam, imu, xi: np.asarray(tuple(
        p.L.se3_exp(p.arr(np.arange(36.0).reshape(2, 3, 6) * 0.01)).batch_shape)),
    "group.algebra_add": lambda p, u4, x, lam, imu, xi: p.G.algebra_add(*lam),
    "group.algebra_sub": lambda p, u4, x, lam, imu, xi: p.G.algebra_sub(*lam),
    "group.group_identity(batch_shape)": lambda p, u4, x, lam, imu, xi: p.G.group_identity(
        5, dtype=p.dtype, batch_shape=(2, 3), **p.dev),
    "states.sensor_identity(batch_shape)": lambda p, u4, x, lam, imu, xi: p.S.sensor_identity(
        dtype=p.dtype, batch_shape=(3,), **p.dev),
    "states.state_identity(batch_shape)": lambda p, u4, x, lam, imu, xi: p.S.state_identity(
        4, dtype=p.dtype, batch_shape=(2,), **p.dev),
    "states.IMU.create(bias_vel)": lambda p, u4, x, lam, imu, xi: p.S.IMU.create(
        *imu[:3], gyr_bias_vel=imu[3], acc_bias_vel=imu[4], **({} if p.jax else {"dtype": F64, "device": "cpu"})),
    "states.IMU.create": lambda p, u4, x, lam, imu, xi: p.S.IMU.create(
        *imu[:3], **({} if p.jax else {"dtype": F64, "device": "cpu"})),
    "camera.default_test_camera": lambda p, u4, x, lam, imu, xi: p.Cam.default_test_camera(p.dtype, **p.dev),
    "matrices.normal_euclid_differential": lambda p, u4, x, lam, imu, xi: p.M.normal_euclid_differential(xi),
}


@pytest.mark.parametrize("case", sorted(SURFACE_CASES))
def test_surface_items_match_jax(case):
    """Each name or parameter the surface audit found missing matches its
    ``eqvio_tpu`` counterpart in float64 at 1e-12 (integers, shapes and
    the camera's image size exactly)."""
    pj, pt = _Pkg(True), _Pkg(False)
    out_j = SURFACE_CASES[case](pj, *_surface_inputs(pj))
    out_t = SURFACE_CASES[case](pt, *_surface_inputs(pt))
    assert_tree_close(out_j, out_t, TOL, case)


def test_get_suite_names_roadmap_for_unported_suites():
    """Every coordinate choice the configs name has its suite (the Euclidean
    and Normal suites were once unported and raised)."""
    for name, key in (("InvDepth", "invdepth"), ("Euclidean", "euclid"), ("normal", "normal")):
        assert TM.get_suite(name).name == key
        assert TM.get_suite(name) is TM.SUITES[key]


# ---------------------------------------------------------------------------
# filter: one frame from a shared mid-sequence state
# ---------------------------------------------------------------------------

NCAP = 10
K = 4


def _filter_settings(discrete_lift: bool, median_depth: bool):
    return JF.Settings(
        measurement_noise=0.5, sqrt_covariance=True, fast_riccati=True,
        coordinate_choice="invdepth", use_discrete_innovation_lift=discrete_lift,
        use_median_depth=median_depth, initial_scene_depth=4.0,
        outlier_threshold_abs=30.0, outlier_threshold_prob=20.0, feature_retention=0.5,
        initial_point_var=2.0,
    )


def _frame_inputs(r, k, dtype=np.float64):
    imu = dict(
        stamp=np.asarray([0.005 * (K * k + i) for i in range(K)]),
        gyr=r.normal(size=(K, 3)) * 0.1,
        acc=r.normal(size=(K, 3)) + [0, 0, 9.81],
    )
    dts = np.asarray([0.005, 0.005, 0.005, 0.0])  # last entry: zero-dt pad
    return imu, dts


def _jax_imu(imu):
    z = jnp.zeros((K, 3))
    return JS.IMU(jnp.asarray(imu["stamp"]), jnp.asarray(imu["gyr"]), jnp.asarray(imu["acc"]), z, z)


def _torch_imu(imu):
    z = torch.zeros(K, 3, dtype=F64)
    return TS.IMU(tt(imu["stamp"]), tt(imu["gyr"]), tt(imu["acc"]), z, z)


def _mid_sequence_state(settings, cam, pts, seed=11):
    """A JAX state after three frames of lifecycle and updates."""
    r = np.random.default_rng(seed)
    ids0 = jnp.arange(NCAP, dtype=jnp.int64)
    mask0 = jnp.arange(NCAP) < 7
    st = JF.init_state(settings, NCAP, jnp.float64)
    for k in range(3):
        imu, dts = _frame_inputs(r, k)
        st = JF.propagate_window(st, _jax_imu(imu), jnp.asarray(dts), settings, wide_factor=True)
        pix = cam.project(jnp.asarray(pts)) + jnp.asarray(r.normal(size=(NCAP, 2)) * 0.3)
        st = JF.process_vision(st, pix, mask0, ids0, cam, settings)
    return st, r


@pytest.mark.parametrize("discrete_lift,median_depth", [(False, False), (True, True)],
                         ids=["bench-switches", "discrete-lift-median-depth"])
def test_filter_frame_matches_jax(discrete_lift, median_depth):
    settings_j = _filter_settings(discrete_lift, median_depth)
    settings_t = convert.settings_from_jax_settings(settings_j)
    cam_j = JCam.default_test_camera()
    cam_t = TCam.PinholeCamera.create(400.0, 400.0, 400.0, 240.0, 800, 480, dtype=F64, device="cpu")
    pts = np.random.default_rng(2).uniform(-0.5, 0.5, size=(NCAP, 3)) + [0, 0, 4.0]
    st_j, r = _mid_sequence_state(settings_j, cam_j, pts)
    st_t = convert.eqf_state_from_numpy(st_j, F64, "cpu")
    assert_tree_close(st_j, convert.eqf_state_to_numpy(st_t), 0.0, "convert round trip")

    # next frame: slot 2 lost, slot 3 re-used under a new id, slot 8 new, and
    # slot 5 pushed 40 px off so the outlier gate fires
    imu, dts = _frame_inputs(r, 3)
    noise = r.normal(size=(NCAP, 2)) * 0.3
    noise[5] += [40.0, 0.0]
    vis = np.arange(NCAP) < 7
    vis[2], vis[8] = False, True
    ids = np.arange(NCAP)
    ids[3], ids[8] = 103, 108

    sj = JF.propagate_window(st_j, _jax_imu(imu), jnp.asarray(dts), settings_j, wide_factor=True)
    st = TF.propagate_window(st_t, _torch_imu(imu), tt(dts), settings_t, wide_factor=True)
    assert_tree_close(sj.X, st.X, 1e-9, "propagated X")
    np.testing.assert_allclose(  # the wide factors agree in their Gram
        st.Sigma.numpy() @ st.Sigma.numpy().T, np.asarray(sj.Sigma @ sj.Sigma.T), atol=1e-9)
    pix_j = cam_j.project(jnp.asarray(pts)) + jnp.asarray(noise)
    out_j = JF.outlier_mask(sj, pix_j, jnp.asarray(vis), cam_j, settings_j)
    out_t = TF.outlier_mask(st, tt(pix_j), torch.as_tensor(vis), cam_t, settings_t)
    assert_tree_close(out_j, out_t, 0, "outlier mask")
    assert bool(out_t[5])
    sj = JF.process_vision(sj, pix_j, jnp.asarray(vis), jnp.asarray(ids), cam_j, settings_j)
    st = TF.process_vision(st, tt(pix_j), torch.as_tensor(vis), torch.as_tensor(ids), cam_t, settings_t)
    assert_tree_close(sj, st, 1e-9, "frame")
    assert_tree_close(JF.state_estimate(sj), TF.state_estimate(st), 1e-9, "estimate")
    hj, ht = JF.health_check(sj, settings_j), TF.health_check(st, settings_t)
    assert {k: bool(v) for k, v in hj.items()} == {k: bool(v) for k, v in ht.items()}


def test_add_remove_landmarks_match_jax():
    settings_j = _filter_settings(False, True)
    settings_t = convert.settings_from_jax_settings(settings_j)
    cam_j = JCam.default_test_camera()
    cam_t = TCam.PinholeCamera.create(400.0, 400.0, 400.0, 240.0, 800, 480, dtype=F64, device="cpu")
    pts = np.random.default_rng(4).uniform(-0.5, 0.5, size=(NCAP, 3)) + [0, 0, 4.0]
    st_j, _ = _mid_sequence_state(settings_j, cam_j, pts, seed=5)
    st_t = convert.eqf_state_from_numpy(st_j, F64, "cpu")
    rm = np.zeros(NCAP, dtype=bool)
    rm[[1, 4]] = True
    new = np.zeros(NCAP, dtype=bool)
    new[[8, 9]] = True
    pix = np.asarray(cam_j.project(jnp.asarray(pts)))
    ids = np.arange(NCAP) + 50
    sj = JF.add_landmarks(JF.remove_landmarks(st_j, jnp.asarray(rm), settings_j), jnp.asarray(pix),
                          jnp.asarray(new), jnp.asarray(ids), cam_j, settings_j)
    st = TF.add_landmarks(TF.remove_landmarks(st_t, torch.as_tensor(rm), settings_t), tt(pix),
                          torch.as_tensor(new), torch.as_tensor(ids), cam_t, settings_t)
    assert_tree_close(sj, st, 1e-9, "add/remove")


def test_tria_sign_convention_matches_jax():
    """tria returns the unique lower factor with a nonnegative diagonal,
    whatever sign convention the QR library uses."""
    rng = np.random.default_rng(12)
    M = rng.normal(size=(30, 75))
    M[5] = 0.0  # a zero row: zero diagonal entry, sign treated as +1
    L_t = TF.tria(tt(M)).numpy()
    L_j = np.asarray(JF.tria(jnp.asarray(M)))
    assert np.all(np.triu(L_t, 1) == 0.0)
    assert np.all(np.diag(L_t) >= 0.0)
    # two QR libraries on a 75x30 input: round-off ~1e-14 relative, entries ~10
    np.testing.assert_allclose(L_t @ L_t.T, M @ M.T, atol=1e-11)
    np.testing.assert_allclose(L_t, L_j, atol=1e-11)


def test_one_qr_frame_fusion_matches_two_qr():
    """The port's one-QR frame (wide Riccati stack into the Kailath
    pre-array) equals the two-QR path over a multi-frame sequence with
    lifecycle and zero-dt padding (float64, 1e-9; the JAX package's
    test_filter.py check)."""
    settings = TF.Settings(measurement_noise=0.5, sqrt_covariance=True, fast_riccati=True,
                           coordinate_choice="invdepth")
    cam = TCam.PinholeCamera.create(400.0, 400.0, 400.0, 240.0, 800, 480, dtype=F64, device="cpu")
    rng = np.random.default_rng(11)
    pts = tt(rng.uniform(-0.5, 0.5, size=(NCAP, 3)) + [0, 0, 4.0])
    ids0 = torch.arange(NCAP)
    mask0 = torch.arange(NCAP) < 7
    state0 = TF.add_landmarks(TF.init_state(settings, NCAP, F64, "cpu"), cam.project(pts), mask0, ids0,
                              cam, settings)

    def run(wide):
        st = state0
        r = np.random.default_rng(7)
        for k in range(6):
            imu, dts = _frame_inputs(r, k)
            st = TF.propagate_window(st, _torch_imu(imu), tt(dts), settings, wide_factor=wide)
            pix = cam.project(pts) + tt(r.normal(size=(NCAP, 2)) * 0.3)
            vis, ids = mask0.clone(), ids0.clone()
            if k == 3:
                vis[2], vis[8] = False, True
                ids[3], ids[8] = 103, 108
            st = TF.process_vision(st, pix, vis, ids, cam, settings)
        return st

    two_qr, one_qr = run(False), run(True)
    assert one_qr.Sigma.shape == two_qr.Sigma.shape
    assert torch.equal(one_qr.xi0.mask, two_qr.xi0.mask)
    np.testing.assert_allclose(one_qr.X.A.x.numpy(), two_qr.X.A.x.numpy(), atol=1e-9)
    S1, S2 = TF.dense_sigma(one_qr, settings).numpy(), TF.dense_sigma(two_qr, settings).numpy()
    scale = max(1.0, np.abs(S2).max())
    np.testing.assert_allclose(S1 / scale, S2 / scale, atol=1e-9)


def test_unported_filter_modes_raise():
    """The modes that once raised (per-sample Riccati, the continuous
    velocity lift, dense covariance) now propagate: a window of zero-dt
    entries leaves every one of them where it was (fast Riccati steps over
    the window's total dt, clamped to 1e-9 s)."""
    imu = TS.IMU(*(torch.zeros(K, 3, dtype=F64) if i else torch.zeros(K, dtype=F64) for i in range(5)))
    for mode in (dict(fast_riccati=False), dict(use_discrete_velocity_lift=False),
                 dict(fast_riccati=False, use_accurate_riccati=True),
                 dict(fast_riccati=False, use_discrete_state_matrix=True), dict(sqrt_covariance=False)):
        s = TF.Settings(**{"sqrt_covariance": True, "fast_riccati": True, "coordinate_choice": "invdepth", **mode})
        st = TF.init_state(s, 4, F64, "cpu")
        out = TF.propagate_window(st, imu, torch.zeros(K, dtype=F64), s)
        torch.testing.assert_close(TF.dense_sigma(out, s), TF.dense_sigma(st, s), atol=1e-9, rtol=0)
        torch.testing.assert_close(out.X.A.x, st.X.A.x, atol=1e-12, rtol=0)


@pytest.mark.parametrize("kind", ["wave", "room"])
def test_sim_scene_matches_jax(kind):
    """Trajectory, world points, interpolated poses, IMU and true state of
    the synthetic scene (rendered frames are checked in test_torch_run_opt)."""
    sj = JSim.Simulator.create(kind=kind, end_time=6.0, num_points=50, num_walls=4, seed=3)
    st = TSim.Simulator.create(kind=kind, end_time=6.0, num_points=50, num_walls=4, seed=3, device="cpu")
    assert_tree_close((sj.times, sj.poses, sj.world, sj.camera_offset),
                      (st.times, st.poses, st.world, st.camera_offset), TOL, "scene")
    ts = np.arange(0.2, 5.0, 0.137)
    imu_j = sj.get_imu_batch(jnp.asarray(ts))
    imu_t = st.get_imu_batch(tt(ts))
    gyr_t, acc_t = imu_t.gyr, imu_t.acc
    # accelerations come from inverting a cubic fit's 4x4 normal matrix over
    # 10 ms stamps (condition ~1e8): 1e-9 instead of 1e-12
    assert_tree_close((imu_j.gyr, imu_j.acc), (gyr_t, acc_t), 1e-9, "imu")
    for t in ts[::7]:
        assert_tree_close(sj.interpolate_pose(jnp.asarray(t)), st.interpolate_pose(tt(t)), TOL, "pose")
        xi = sj.full_state(jnp.asarray(t))
        pose, vel = st.true_pose_velocity(tt(t))
        assert_tree_close((xi.sensor.pose, xi.sensor.velocity), (pose, vel), 1e-9, "true state")
