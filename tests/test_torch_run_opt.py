"""The port's main path as a whole against ``eqvio_tpu``'s per-frame
``run_dataset`` on the hermetic synthetic ASL scene of ``tests/test_app.py``.

Both runs use the template config with the benchmark's algorithm switches
(``io.config.bench_config``) in float64 on the CPU for 20 frames; the JAX
side takes the per-frame path (``chunk_size=1``), the port its default, the
fused chunk path.  Every row the two writers
receive is recorded at full precision: positions must agree to 1e-6 m, the
tracked feature ids exactly and their pixels to 1e-3 px.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eqvio_tpu.app.run_opt as jax_run_opt
import eqvio_tpu_torch.app.run_opt as torch_run_opt
from eqvio_tpu import data as jdata
from eqvio_tpu import io as jio
from eqvio_tpu.data import generate_asl_dataset
from eqvio_tpu.io import load_config
from eqvio_tpu_torch import convert
from eqvio_tpu_torch import data as tdata
from eqvio_tpu_torch import io as tio
from eqvio_tpu_torch.data import ASLDatasetReader, SyntheticASLReader
from eqvio_tpu_torch.io import bench_config, racing_proxy_config, template_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = dict(end_time=4.0, width=320, height=240, frame_freq=10.0, num_points=300)
FRAMES = 20


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the port on one CPU thread per test worker.  Its tensors are
    small, so torch's intra-op threads gain nothing, and the workers share
    the machine's cores: their threads together would oversubscribe it and
    slow every op many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixture_dataset(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("asl"))
    generate_asl_dataset(out, **SCENE)
    return out


def test_template_config_matches_yaml():
    assert template_config() == load_config(os.path.join(REPO, "configs", "config_template.yaml"))


def test_racing_proxy_config_matches_yaml():
    assert racing_proxy_config() == load_config(os.path.join(REPO, "configs", "config_racing_proxy.yaml"))


@pytest.mark.parametrize("name", ["config_template.yaml", "config_EuRoC.yaml", "config_UZHFPV.yaml",
                                  "config_racing_proxy.yaml", "config_v101_proxy.yaml", "config_mh03_proxy.yaml"])
def test_config_readers_match_jax(name):
    cfg = load_config(os.path.join(REPO, "configs", name))
    assert convert.settings_from_jax_settings(jio.settings_from_config(cfg)) == tio.settings_from_config(cfg)
    tj, tt = jio.tracker_config_from_config(cfg), tio.tracker_config_from_config(cfg)
    for field in tt.__dataclass_fields__:
        assert getattr(tt, field) == getattr(tj, field), field


def test_writer_matches_jax(tmp_path):
    """Both writers produce byte-identical files from the same rows."""
    rng = np.random.default_rng(0)
    R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    R[:, 0] *= np.sign(np.linalg.det(R))  # a proper rotation
    args = (1403636579.763555527, R, rng.normal(size=3), rng.normal(size=3), np.eye(3), rng.normal(size=3),
            rng.normal(size=6))
    kw = dict(landmarks=rng.normal(size=(4, 3)), landmark_ids=np.arange(4), landmark_mask=np.array([1, 0, 1, 1], bool))
    px, ids, vis = rng.uniform(0, 300, (4, 2)), np.arange(4) + 7, np.array([1, 1, 0, 1], bool)
    for mod, out in ((jio.writer, tmp_path / "jax"), (tio.writer, tmp_path / "torch")):
        w = mod.VIOWriter(str(out))
        w.write_states(*args, **kw)
        w.write_features(args[0], px, ids, vis)
        w.write_timing(args[0], {"features": 0.001, "total": 0.002})
        w.flush()
    for name in ("IMUState.csv", "camera.csv", "bias.csv", "points.csv", "features.csv", "timing.csv"):
        assert (tmp_path / "jax" / name).read_bytes() == (tmp_path / "torch" / name).read_bytes(), name


def test_asl_reader_and_server_match_jax(fixture_dataset):
    rj, rt = jdata.ASLDatasetReader(fixture_dataset), tdata.ASLDatasetReader(fixture_dataset)
    for a, b in ((rj.imu, rt.imu), (rj.groundtruth, rt.groundtruth)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x))
    np.testing.assert_array_equal(rt.images.stamps, rj.images.stamps)
    assert rt.images.paths == rj.images.paths and rt.camera.model == rj.camera.model
    np.testing.assert_array_equal(rt.camera.T_BS, rj.camera.T_BS)
    seq_j = [(m.kind, m.stamp, m.index) for m in jdata.DataServer(rj, start_time=0.5, stop_time=2.0)]
    seq_t = [(m.kind, m.stamp, m.index) for m in tdata.DataServer(rt, start_time=0.5, stop_time=2.0)]
    assert seq_t == seq_j and len(seq_t) > 100


def test_synthetic_reader_matches_fixture(fixture_dataset):
    """The in-memory scene serves what the ASL reader reads back from the
    JAX package's generated tree."""
    disk = ASLDatasetReader(fixture_dataset)
    mem = SyntheticASLReader(**SCENE)
    assert disk.camera.model == mem.camera.model and disk.camera.resolution == mem.camera.resolution
    assert tuple(disk.camera.intrinsics) == tuple(mem.camera.intrinsics)
    np.testing.assert_array_equal(mem.camera.T_BS, disk.camera.T_BS)
    np.testing.assert_array_equal(mem.images.stamps, disk.images.stamps)
    np.testing.assert_array_equal(mem.imu.stamps, disk.imu.stamps)
    # rows are printed with 9 decimals: a last-digit rounding flip is 1e-9
    np.testing.assert_allclose(mem.imu.gyr, disk.imu.gyr, atol=1.01e-9, rtol=0)
    np.testing.assert_allclose(mem.imu.acc, disk.imu.acc, atol=1.01e-9, rtol=0)
    np.testing.assert_allclose(mem.groundtruth.position, disk.groundtruth.position, atol=1.01e-9, rtol=0)
    for i in range(len(disk.images.stamps)):
        np.testing.assert_array_equal(mem.load_image_u8(i), disk.load_image_u8(i), err_msg=f"frame {i}")


def _recording_writer(base, rows):
    class RecordingWriter(base):
        def write_states(self, stamp, pose_R, pose_x, *args, **kwargs):
            rows.setdefault("states", []).append((float(stamp), np.array(pose_x, dtype=np.float64)))
            return super().write_states(stamp, pose_R, pose_x, *args, **kwargs)

        def write_features(self, stamp, pixels, ids, mask):
            rows.setdefault("features", []).append(
                (np.array(pixels, np.float64), np.array(ids, np.int64), np.array(mask, bool)))
            return super().write_features(stamp, pixels, ids, mask)

    return RecordingWriter


def test_slice_matches_jax_per_frame_run(fixture_dataset, tmp_path, monkeypatch):
    cfg = bench_config(load_config(os.path.join(REPO, "configs", "config_template.yaml")))
    rows_j, rows_t = {}, {}
    monkeypatch.setattr(jax_run_opt, "VIOWriter", _recording_writer(jax_run_opt.VIOWriter, rows_j))
    monkeypatch.setattr(torch_run_opt, "VIOWriter", _recording_writer(torch_run_opt.VIOWriter, rows_t))
    _, sum_j = jax_run_opt.run_dataset(fixture_dataset, cfg, output_dir=str(tmp_path / "jax"),
                                       chunk_size=1, limit_frames=FRAMES, dtype=jnp.float64)
    state_t, sum_t = torch_run_opt.run_dataset(fixture_dataset, cfg, output_dir=str(tmp_path / "torch"),
                                               limit_frames=FRAMES, device="cpu")
    assert sum_t["frames"] == sum_j["frames"] == FRAMES
    assert sum_t["healthy"] and sum_j["healthy"]
    assert sum_t["landmarks"] == sum_j["landmarks"] >= 10

    assert len(rows_t["states"]) == len(rows_j["states"]) == FRAMES
    for k, ((tj, pj), (tt, pt)) in enumerate(zip(rows_j["states"], rows_t["states"])):
        assert tj == tt
        np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=0, err_msg=f"frame {k} position")
    np.testing.assert_allclose(sum_t["positions"], np.stack([p for _, p in rows_j["states"]]),
                               atol=1e-6, rtol=0)
    for k, ((px_j, id_j, m_j), (px_t, id_t, m_t)) in enumerate(zip(rows_j["features"], rows_t["features"])):
        np.testing.assert_array_equal(m_t, m_j, err_msg=f"frame {k} tracked mask")
        np.testing.assert_array_equal(id_t[m_t], id_j[m_j], err_msg=f"frame {k} ids")
        np.testing.assert_allclose(px_t[m_t], px_j[m_j], atol=1e-3, rtol=0, err_msg=f"frame {k} pixels")

    # the CSVs both writers produced hold the same rows and the same feature ids
    for name in ("IMUState.csv", "features.csv", "points.csv"):
        with open(tmp_path / "jax" / name) as f:
            lines_j = f.readlines()
        with open(tmp_path / "torch" / name) as f:
            lines_t = f.readlines()
        assert lines_t[0] == lines_j[0] and len(lines_t) == len(lines_j), name
        if name == "features.csv":
            for a, b in zip(lines_j[1:], lines_t[1:]):
                ids_a = [int(float(c)) for c in a.split(",")[1::3]]
                ids_b = [int(float(c)) for c in b.split(",")[1::3]]
                assert ids_a == ids_b
