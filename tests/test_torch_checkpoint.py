"""The port's checkpoint against ``eqvio_tpu.checkpoint``: round trips, the
one-line CSV state against the JAX package's, files that cross between the
packages both ways, and a resumed fused run stitched to the uninterrupted
one (as ``tests/test_app.py``'s resume test does for ``eqvio_tpu``), in
float64 on the CPU.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eqvio_tpu import checkpoint as jck
from eqvio_tpu import filter as JF
from eqvio_tpu.frontend import TrackerConfig as JTrackerConfig
from eqvio_tpu.frontend import tracker_init as jtracker_init
from eqvio_tpu_torch import checkpoint as tck
from eqvio_tpu_torch import convert
from eqvio_tpu_torch.app.run_opt import run_dataset
from eqvio_tpu_torch.data import generate_asl_dataset
from eqvio_tpu_torch.frontend import TrackerConfig, tracker_init
from eqvio_tpu_torch.io import bench_config, load_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread per test worker: the workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_state(sqrt: bool, seed: int = 0):
    """A JAX filter state with landmarks in some slots and a full covariance."""
    rng = np.random.default_rng(seed)
    settings = JF.Settings(sqrt_covariance=sqrt)
    st = JF.init_state(settings, N, jnp.float64)
    mask = np.array([1, 0, 1, 1, 0, 1], bool)
    ids = np.where(mask, np.arange(N) + 7, -1).astype(np.int32)
    D = 21 + 3 * N
    A = rng.normal(size=(D, D))
    cov = A @ A.T + D * np.eye(D)
    xi0 = st.xi0._replace(landmarks=jnp.asarray(rng.normal(size=(N, 3)) + [0, 0, 3]), ids=jnp.asarray(ids),
                          mask=jnp.asarray(mask))
    xi0 = xi0._replace(sensor=xi0.sensor._replace(bias=jnp.asarray(rng.normal(size=6) * 0.01),
                                                  velocity=jnp.asarray(rng.normal(size=3))))
    X = st.X._replace(beta=jnp.asarray(rng.normal(size=6)), w=jnp.asarray(rng.normal(size=3)),
                      Q=st.X.Q._replace(a=jnp.asarray(rng.uniform(0.5, 2.0, N))))
    Sigma = np.linalg.cholesky(cov) if sqrt else cov
    return st._replace(xi0=xi0, X=X, Sigma=jnp.asarray(Sigma), t=jnp.asarray(1.25)), settings


def _torch_state(sqrt: bool, seed: int = 0):
    st_j, settings_j = _jax_state(sqrt, seed)
    return convert.eqf_state_from_numpy(st_j, torch.float64, "cpu"), convert.settings_from_jax_settings(settings_j)


def _flat(state) -> dict:
    """Leaves of a state of either package as numpy arrays, under the file's keys."""
    xi0, X = state.xi0, state.X
    s = xi0.sensor
    vals = [s.bias, s.pose.R, s.pose.x, s.velocity, s.camera_offset.R, s.camera_offset.x, xi0.landmarks,
            xi0.ids, xi0.mask, X.beta, X.A.R, X.A.x, X.w, X.B.R, X.B.x, X.Q.R, X.Q.a, state.Sigma, state.t]
    return {k: np.asarray(v) for k, v in zip(tck._STATE_KEYS, vals)}


def _assert_states_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("sqrt", [False, True])
def test_round_trip_state_and_tracker(tmp_path, sqrt):
    state, _ = _torch_state(sqrt)
    tracker = tracker_init(TrackerConfig(max_features=N, max_level=2), (40, 56), "cpu")
    tracker = tracker._replace(positions=torch.rand(N, 2), ids=torch.tensor([3, -1, 5, 9, -1, 2]),
                               mask=torch.tensor([1, 0, 1, 1, 0, 1], dtype=torch.bool),
                               next_id=torch.tensor(10), pyramid=tuple(torch.rand_like(p) for p in tracker.pyramid))
    path = str(tmp_path / "ck.npz")
    tck.save_checkpoint(path, state, tracker, {"frames": 42, "imu_buf": [[1.0, [0.1, 0.2, 0.3], [0, 0, 9.8]]]})
    st2, trk2, cursor, key = tck.load_checkpoint(path, device="cpu")
    assert cursor == {"frames": 42, "imu_buf": [[1.0, [0.1, 0.2, 0.3], [0, 0, 9.8]]]} and key is None
    _assert_states_equal(state, st2)
    assert st2.xi0.ids.dtype == trk2.ids.dtype == torch.int64 and st2.Sigma.dtype == torch.float64
    for name in ("positions", "ids", "mask", "next_id"):
        assert torch.equal(getattr(tracker, name), getattr(trk2, name)), name
    assert all(torch.equal(p, q) for p, q in zip(tracker.pyramid, trk2.pyramid)) and bool(trk2.searched)
    st32, _, _, _ = tck.load_checkpoint(path, dtype=torch.float32, device="cpu")
    assert st32.Sigma.dtype == torch.float32 and st32.xi0.ids.dtype == torch.int64


@pytest.mark.parametrize("sqrt", [False, True])
def test_csv_line_matches_jax(sqrt):
    st_j, settings_j = _jax_state(sqrt)
    st_t, settings_t = _torch_state(sqrt)
    line_j, line_t = jck.state_to_csv_line(st_j, settings_j), tck.state_to_csv_line(st_t, settings_t)
    vj = np.array([float(v) for v in line_j.split(",")])
    vt = np.array([float(v) for v in line_t.split(",")])
    # 23 sensor values, N, 4 active landmarks x (id, p), 23 group values, N, 4 x (id, a, quaternion), Sigma
    assert vt.shape == vj.shape == (23 + 1 + 4 * 4 + 23 + 1 + 4 * 6 + (21 + 3 * 4) ** 2,)
    if sqrt:  # the factor's product in each package's matmul
        np.testing.assert_allclose(vt, vj, rtol=1e-13, atol=1e-12)
    else:
        assert line_t == line_j
    back_t = tck.state_from_csv_line(line_j, N, settings_t, t=1.25, device="cpu")
    back_j = jck.state_from_csv_line(line_j, N, settings_j, dtype=jnp.float64, t=1.25)
    fj, ft = _flat(back_j), _flat(back_t)
    for k in fj:
        np.testing.assert_allclose(ft[k], fj[k], rtol=0, atol=1e-12 if k == "Sigma" else 0, err_msg=k)


def test_jax_file_loads_into_port(tmp_path):
    st_j, _ = _jax_state(True)
    trk_j = jtracker_init(JTrackerConfig(max_features=N, max_level=2), (40, 56))
    trk_j = trk_j._replace(ids=jnp.asarray([4, -1, 6, 1, -1, 0], jnp.int32), next_id=jnp.asarray(11, jnp.int32))
    path = str(tmp_path / "jax.npz")
    jck.save_checkpoint(path, st_j, trk_j, {"frames": 16, "t_prev": 2.5})
    st_t, trk_t, cursor, _ = tck.load_checkpoint(path, device="cpu")
    assert cursor == {"frames": 16, "t_prev": 2.5}
    _assert_states_equal(st_j, st_t)
    assert trk_t.ids.dtype == torch.int64 and trk_t.ids.tolist() == [4, -1, 6, 1, -1, 0] and int(trk_t.next_id) == 11
    for p, q in zip(trk_j.pyramid, trk_t.pyramid):
        np.testing.assert_array_equal(np.asarray(p), q.numpy())


def test_port_file_loads_into_jax(tmp_path):
    st_t, _ = _torch_state(True, seed=3)
    trk_t = tracker_init(TrackerConfig(max_features=N, max_level=2), (40, 56), "cpu")
    trk_t = trk_t._replace(ids=torch.tensor([0, 1, -1, 3, 4, -1]), next_id=torch.tensor(5),
                           positions=torch.rand(N, 2))
    path = str(tmp_path / "port.npz")
    tck.save_checkpoint(path, st_t, trk_t, {"frames": 8})
    st_j, trk_j, cursor, _ = jck.load_checkpoint(path)
    assert cursor == {"frames": 8}
    _assert_states_equal(st_t, st_j)
    assert np.asarray(trk_j.ids).tolist() == [0, 1, -1, 3, 4, -1] and int(trk_j.next_id) == 5
    np.testing.assert_array_equal(np.asarray(trk_j.positions), trk_t.positions.numpy())
    with np.load(path) as z:
        assert z["xi0.ids"].dtype == z["trk.ids"].dtype == np.int32


def _key_data(kind):
    """Raw key data of ``jax.random.key(7)`` in the form the port takes."""
    import jax

    data = np.asarray(jax.random.key_data(jax.random.key(7)))
    return {"numpy": data, "int64": torch.tensor(data.astype(np.int64)),
            "uint32": torch.tensor(data.view(np.int32)).view(torch.uint32)}[kind]


@pytest.mark.parametrize("kind", ["numpy", "int64", "uint32"])
def test_port_rng_key_loads_into_jax(tmp_path, kind):
    """A key written by the port (raw key data as a uint32 array or an
    integer tensor) loads in ``eqvio_tpu`` and round-trips through
    ``jax.random.key_data``; the port reads it back as that data."""
    import jax

    st_t, _ = _torch_state(False, seed=5)
    path = str(tmp_path / "key.npz")
    tck.save_checkpoint(path, st_t, rng_key=_key_data(kind))
    want = np.asarray(jax.random.key_data(jax.random.key(7)))
    st_j, _, _, key_j = jck.load_checkpoint(path)
    _assert_states_equal(st_t, st_j)
    got = np.asarray(jax.random.key_data(key_j))
    assert got.dtype == want.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(jax.random.normal(key_j, (3,)), jax.random.normal(jax.random.key(7), (3,)))
    _, _, _, key_t = tck.load_checkpoint(path, device="cpu")
    assert key_t.dtype == np.uint32
    np.testing.assert_array_equal(key_t, want)
    with pytest.raises(ValueError, match="uint32"):
        tck.save_checkpoint(path, st_t, rng_key=torch.tensor([-1, 3]))


@pytest.fixture(scope="module")
def asl_tree(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("asl"))
    generate_asl_dataset(out, end_time=3.5, width=160, height=120, frame_freq=10.0, num_points=150)
    return out


def test_resumed_fused_run_stitches(asl_tree, tmp_path):
    """Stopped after 16 frames with a checkpoint, resumed to 32: the two
    IMUState.csv parts equal the uninterrupted run's rows (tests/test_app.py's
    resume test, on the port's fused CPU path in float64, with the
    benchmark's switches on the template config)."""
    cfg = bench_config(load_config(os.path.join(REPO, "configs", "config_template.yaml")))
    cfg["GIFT"].update(maxFeatures=12, winSize=11)
    out_full, out_a, out_b = (str(tmp_path / k) for k in ("full", "a", "b"))
    run_dataset(asl_tree, cfg, output_dir=out_full, chunk_size=8, limit_frames=32, device="cpu")
    _, sum_a = run_dataset(asl_tree, cfg, output_dir=out_a, chunk_size=8, limit_frames=16, checkpoint_every=16,
                           device="cpu")
    assert sum_a["checkpoint"]["saves"] == 1
    _, summary = run_dataset(asl_tree, cfg, output_dir=out_b, chunk_size=8, limit_frames=32,
                             resume=os.path.join(out_a, "checkpoint.npz"), device="cpu")
    assert summary["frames"] == 32 and len(summary["stamps"]) == 16
    full, a, b = (np.genfromtxt(os.path.join(d, "IMUState.csv"), delimiter=",", skip_header=1)
                  for d in (out_full, out_a, out_b))
    stitched = np.vstack([a[:16], b])
    assert stitched.shape == full.shape
    np.testing.assert_allclose(stitched, full, atol=1e-12)
    with pytest.raises(ValueError, match="fused path"):
        run_dataset(asl_tree, cfg, chunk_size=1, limit_frames=4, checkpoint_every=2, output_dir=out_a, device="cpu")
