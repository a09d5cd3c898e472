"""The port's file readers, bag writer, dataset-tree generators, native PNG
loader and streaming writer against ``eqvio_tpu`` on the same files.

The ANU tree is the one ``tests/test_anu_reader.py`` writes (with frames
added), the bags are written by ``tests/test_rosbag.py``'s helper with the
JAX ``BagWriter``; every array the two packages read must be equal.  The
generator trees are small (160x120, 2 s): their YAML and CSV text must
equal the JAX generator's byte for byte, and their frames decode to the
same pixels, except the IMU and ground-truth rows, whose values the two
packages' simulations reach by different float64 round-off: those rows may
differ only in the sign of a zero (a value within 1e-16 of it) or by one
unit in the 9th decimal, where a value sits on a rounding boundary.
"""

import filecmp
import os

import numpy as np
import pytest
import torch
from PIL import Image

from eqvio_tpu.data import DataServer as JDataServer
from eqvio_tpu.data import anu as janu
from eqvio_tpu.data import rosbag as jbag
from eqvio_tpu.data import synthetic as jsyn
from eqvio_tpu.io.writer import VIOWriter as JWriter
from eqvio_tpu_torch.data import DataServer, create_dataset_reader
from eqvio_tpu_torch.data import native_loader
from eqvio_tpu_torch.data import rosbag as tbag
from eqvio_tpu_torch.data import synthetic as tsyn
from eqvio_tpu_torch.io import native as tnative
from eqvio_tpu_torch.io.writer import VIOWriter
from tests.test_rosbag import _write_bag

SMALL = dict(end_time=2.0, width=160, height=120, frame_freq=10.0, num_points=150)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread per test worker: the workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
SMALL_UZH = dict(end_time=2.0, width=160, height=120, num_points=150)


def _anu_tree(base: str) -> str:
    """``tests/test_anu_reader.py``'s tree, with its three frames written."""
    base = base.rstrip("/") + "/"
    with open(base + "mav_imu.csv", "w") as f:
        f.write("stamp,wx,wy,wz,ax,ay,az\n")
        for i in range(20):
            f.write(f"{0.1*i:.3f},0.01,0.02,0.03,0.1,0.2,9.8\n")
    os.makedirs(base + "frames", exist_ok=True)
    rng = np.random.default_rng(3)
    with open(base + "cam.csv", "w") as f:
        f.write("stamp,filename\n")
        for i in range(3):
            f.write(f"{0.5*i:.3f},frame_{i}.png\n")
            Image.fromarray(rng.integers(0, 256, (24, 33, 3), dtype=np.uint8)).save(base + f"frames/frame_{i}.png")
    with open(base + "undistort.yaml", "w") as f:
        f.write(
            "%YAML:1.0\n---\n"
            "camera_matrix: !!opencv-matrix\n"
            "  rows: 3\n  cols: 3\n  dt: d\n"
            "  data: [300., 0., 320., 0., 301., 240., 0., 0., 1.]\n"
            "dist_coeffs: !!opencv-matrix\n"
            "  rows: 1\n  cols: 4\n  dt: d\n"
            "  data: [0.01, -0.002, 0.001, 0.0]\n"
        )
    with open(base + "ground_truth.csv", "w") as f:
        f.write("stamp,px,py,pz,qw,qx,qy,qz\n")
        for i in range(10):
            f.write(f"{0.2*i:.3f},{0.1*i},0,0,1,0,0,0\n")
    return base


def _hilti_calibration(path) -> None:
    """``tests/test_rosbag.py``'s Hilti calibration (a 90 deg yaw)."""
    s = float(np.sqrt(0.5))
    with open(path, "w") as f:
        f.write(
            "sensors:\n"
            "  cam0:\n"
            "    intrinsics:\n"
            "      parameters:\n"
            "        image_size: [32, 24]\n"
            "        fx: 30.0\n        fy: 31.0\n        cx: 16.0\n        cy: 12.0\n"
            "        k1: 0.01\n        k2: 0.002\n        k3: 0.0\n        k4: 0.0\n"
            "    extrinsics:\n"
            f"      quaternion: [0.0, 0.0, {s}, {s}]\n"
            "      translation: [0.1, 0.2, 0.3]\n"
        )


def _assert_readers_equal(rt, rj, frames=True):
    for name in ("stamps", "gyr", "acc"):
        np.testing.assert_array_equal(getattr(rt.imu, name), getattr(rj.imu, name), err_msg=f"imu.{name}")
    np.testing.assert_array_equal(rt.images.stamps, rj.images.stamps)
    ct, cj = rt.camera, rj.camera
    assert (ct.model, tuple(ct.intrinsics), tuple(ct.distortion), tuple(ct.resolution)) == \
        (cj.model, tuple(cj.intrinsics), tuple(cj.distortion), tuple(cj.resolution))
    np.testing.assert_array_equal(ct.T_BS, cj.T_BS)
    assert (rt.groundtruth is None) == (rj.groundtruth is None)
    if rt.groundtruth is not None:
        for a, b in zip(rt.groundtruth, rj.groundtruth):
            np.testing.assert_array_equal(a, b)
    if frames:
        for i in range(len(rj.images.stamps)):
            np.testing.assert_array_equal(rt.load_image_u8(i), rj.load_image_u8(i), err_msg=f"frame {i}")


def _assert_bag_readers_equal(rt, rj):
    """The JAX bag readers decode to float frames, which the fused path
    rounds to uint8; the port's ``load_image_u8`` must give those bytes."""
    _assert_readers_equal(rt, rj, frames=False)
    assert rt.decoder == "bag"
    for i in range(len(rj.images.stamps)):
        np.testing.assert_array_equal(rt.load_image(i), rj.load_image(i))
        np.testing.assert_array_equal(rt.load_image_u8(i),
                                      np.clip(rj.load_image(i) * 255.0 + 0.5, 0, 255).astype(np.uint8))


def test_anu_reader_matches_jax(tmp_path):
    base = _anu_tree(str(tmp_path))
    rt = create_dataset_reader("anu", base)
    _assert_readers_equal(rt, janu.APDatasetReader(base))
    assert rt.camera.model == "equidistant" and len(rt.images.stamps) == 3 and rt.decoder == "pil"


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_rosbag_reader_matches_jax(tmp_path, compression):
    _write_bag(tmp_path / "seq.bag", compression=compression)
    with open(tmp_path / "intrinsics.yaml", "w") as f:
        f.write("resolution: [32, 24]\nintrinsics: [30.0, 31.0, 16.0, 12.0]\n"
                "distortion_coefficients: [0.01, -0.002, 0.0, 0.0]\n"
                "T_BS:\n  data: [1,0,0, 0.1, 0,1,0, 0.0, 0,0,1, 0.0, 0,0,0,1]\n")
    bag = str(tmp_path / "seq.bag")
    rt, rj = create_dataset_reader("rosbag", bag), jbag.RosbagDatasetReader(bag)
    _assert_bag_readers_equal(rt, rj)
    merged = [(m.kind, m.stamp, m.index) for m in DataServer(rt)]
    assert merged == [(m.kind, m.stamp, m.index) for m in JDataServer(rj)]


def test_hilti_reader_matches_jax(tmp_path):
    _write_bag(tmp_path / "run.bag", imu_topic="/alphasense/imu", image_topic="/alphasense/cam0/image_raw",
               n_imu=10, n_img=2)
    _hilti_calibration(tmp_path / "calibration.yaml")
    args = (str(tmp_path / "run.bag"), str(tmp_path / "calibration.yaml"))
    rt = create_dataset_reader("hilti", *args)
    _assert_bag_readers_equal(rt, jbag.HiltiDatasetReader(*args))
    assert rt.camera.model == "equidistant" and len(rt.images.stamps) == 2


@pytest.mark.parametrize("compression", ["none", "bz2"])
def test_bag_writer_bytes_match_jax(tmp_path, compression):
    rng = np.random.default_rng(1)
    imu = [(100.0 + 0.005 * i, rng.normal(size=3), rng.normal(size=3)) for i in range(30)]
    imgs = [(100.0 + 0.05 * k, rng.uniform(0.0, 1.0, (12, 17))) for k in range(3)]
    for mod, name in ((jbag, "j.bag"), (tbag, "t.bag")):
        w = mod.BagWriter(str(tmp_path / name), compression=compression)
        for t, g, a in imu:
            w.write_imu(t, g, a)
        for t, img in imgs:
            w.write_image(t, img)
        w.close()
    assert (tmp_path / "j.bag").read_bytes() == (tmp_path / "t.bag").read_bytes()


def test_lz4_bags_stay_gated():
    with pytest.raises((NotImplementedError, ImportError)):
        tbag._decompress(b"\x04\x22\x4d\x18", "lz4")


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """Small ASL and UZH-FPV trees from both packages' generators."""
    root = tmp_path_factory.mktemp("gen")
    out = {}
    for name, gen_j, gen_t, kw in (("asl", jsyn.generate_asl_dataset, tsyn.generate_asl_dataset, SMALL),
                                   ("uzh", jsyn.generate_uzhfpv_dataset, tsyn.generate_uzhfpv_dataset, SMALL_UZH)):
        gen_j(str(root / f"j_{name}"), **kw)
        gen_t(str(root / f"t_{name}"), **kw)
        out[name] = (root / f"j_{name}", root / f"t_{name}")
    return out


def _rows_match(path_j, path_t, sep):
    """Simulated rows' text equal but for the sign of a zero or one unit in
    the 9th decimal of a field (the simulations' round-off)."""
    rows_j, rows_t = open(path_j).read().splitlines(), open(path_t).read().splitlines()
    assert len(rows_j) == len(rows_t) and rows_j[0] == rows_t[0]
    for a, b in zip(rows_j[1:], rows_t[1:]):
        fields_a, fields_b = a.split(sep), b.split(sep)
        assert len(fields_a) == len(fields_b) and fields_a[0] == fields_b[0], (a, b)
        for x, y in zip(fields_a, fields_b):
            if x != y:
                assert x.lstrip("-") == y.lstrip("-") == "0.000000000" or abs(float(x) - float(y)) <= 1.01e-9, (a, b)


ASL_EXACT = ("mav0/cam0/sensor.yaml", "mav0/cam0/data.csv")
ASL_SIMULATED = ("mav0/imu0/data.csv", "mav0/state_groundtruth_estimate0/data.csv")


def _assert_asl_tree(j, t):
    for rel in ASL_EXACT:
        assert filecmp.cmp(j / rel, t / rel, shallow=False), rel
    for rel in ASL_SIMULATED:
        _rows_match(j / rel, t / rel, ",")


@pytest.mark.parametrize("rel", ASL_EXACT + ASL_SIMULATED)
def test_asl_generator_tree_matches_jax(trees, rel):
    j, t = trees["asl"]
    if rel in ASL_SIMULATED:
        _rows_match(j / rel, t / rel, ",")
    else:
        assert filecmp.cmp(j / rel, t / rel, shallow=False), rel


@pytest.mark.parametrize("rel", ["camchain-imucam.yaml", "left_images.txt", "groundtruth.txt", "imu.txt"])
def test_uzhfpv_generator_tree_matches_jax(trees, rel):
    j, t = trees["uzh"]
    if rel.endswith(".txt") and rel != "left_images.txt":
        _rows_match(j / rel, t / rel, " ")
    else:
        assert filecmp.cmp(j / rel, t / rel, shallow=False), rel


@pytest.mark.parametrize("name,sub", [("asl", "mav0/cam0/data"), ("uzh", "img")])
def test_generator_frames_decode_as_jax(trees, name, sub):
    j, t = trees[name]
    files = sorted(os.listdir(j / sub))
    assert files == sorted(os.listdir(t / sub)) and len(files) == 17
    for f in files:
        np.testing.assert_array_equal(np.asarray(Image.open(t / sub / f)), np.asarray(Image.open(j / sub / f)), f)


def test_proxy_generator_matches_jax(tmp_path):
    """The MH_03 proxy generator over its first 0.45 s: the tree's text and
    frames as the JAX generator's, and ``proxy_info.yaml`` to round-off."""
    import yaml

    _, stats_j = jsyn.generate_mh03_proxy(str(tmp_path / "j"), end_time=0.45)
    _, stats_t = tsyn.generate_mh03_proxy(str(tmp_path / "t"), end_time=0.45)
    with open(tmp_path / "t" / "proxy_info.yaml") as f:
        assert yaml.safe_load(f) == stats_t
    assert stats_t.keys() == stats_j.keys() and stats_t["targets_mh03"] == stats_j["targets_mh03"]
    for key in stats_j:
        if key != "targets_mh03":
            np.testing.assert_allclose(stats_t[key], stats_j[key], rtol=1e-9, err_msg=key)
    _assert_asl_tree(tmp_path / "j", tmp_path / "t")
    frames = sorted(os.listdir(tmp_path / "j" / "mav0/cam0/data"))
    assert len(frames) == 4
    for f in frames:
        np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "t" / "mav0/cam0/data" / f)),
                                      np.asarray(Image.open(tmp_path / "j" / "mav0/cam0/data" / f)))


def test_native_loader_matches_pil(trees):
    """Where ``native/imageloader.cpp`` builds (here: libpng's header is
    present), the data server decodes with it, to PIL's pixels."""
    if not native_loader.available():
        pytest.skip("native/imageloader.cpp does not build here")
    _, t = trees["asl"]
    reader = create_dataset_reader("asl", str(t))
    server = DataServer(reader)
    frames = [m for m in server if m.kind == "image"]
    assert server.decoder == "native" and server.decoded == len(frames) == 17
    for m in frames:
        np.testing.assert_array_equal(m.data, reader.load_image_u8(m.index))
    loader = native_loader.NativeImageLoader(reader.images.paths[:5], workers=3)
    assert [k for k, _ in loader] == list(range(5))


def test_data_server_names_its_decoder(trees):
    _, t = trees["uzh"]
    reader = create_dataset_reader("uzhfpv", str(t))
    mem = tsyn.SyntheticUZHFPVReader(**SMALL_UZH)
    for r, expected in ((reader, "native" if native_loader.available() else "pil"), (mem, "memory")):
        server = DataServer(r)
        assert sum(m.kind == "image" for m in server) == 17
        assert server.decoder == expected and server.decode_s > 0


def test_streaming_writer_matches_plain(tmp_path):
    """``streaming=True`` (the native async writer) writes the same files
    as the buffered writer, and as the JAX package's streaming writer."""
    if not tnative.available():
        pytest.skip("native/aofstream.cpp does not build here")
    rng = np.random.default_rng(2)
    dirs = {k: str(tmp_path / k) for k in ("plain", "stream", "jax")}
    writers = [VIOWriter(dirs["plain"]), VIOWriter(dirs["stream"], streaming=True),
               JWriter(dirs["jax"], streaming=True)]
    assert writers[1]._native is not None
    for k in range(40):
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        R *= np.sign(np.linalg.det(R))
        args = (1.0 + 0.05 * k, R, rng.normal(size=3), rng.normal(size=3), np.eye(3), rng.normal(size=3),
                rng.normal(size=6))
        kw = dict(landmarks=rng.normal(size=(5, 3)), landmark_ids=np.arange(5),
                  landmark_mask=rng.uniform(size=5) > 0.3)
        for w in writers:
            w.write_states(*args, **kw)
            w.write_features(1.0 + 0.05 * k, rng.normal(size=(5, 2)) * 0 + k, np.arange(5), np.ones(5, bool))
            w.write_timing(1.0 + 0.05 * k, {"features": 1e-3 * k, "total": 2e-3 * k})
    for w in writers:
        w.flush()
    names = sorted(os.listdir(dirs["plain"]))
    assert names == sorted(os.listdir(dirs["stream"])) == sorted(os.listdir(dirs["jax"])) and len(names) == 6
    for name in names:
        plain = open(os.path.join(dirs["plain"], name)).read()
        assert open(os.path.join(dirs["stream"], name)).read() == plain == \
            open(os.path.join(dirs["jax"], name)).read(), name


@pytest.mark.parametrize("mode", ["asl", "uzhfpv", "anu"])
def test_load_image_matches_jax(trees, tmp_path, mode):
    """``load_image`` decodes to float32 in [0, 1]: ``load_image_u8 / 255``
    and the JAX reader's frames, bit for bit."""
    if mode == "anu":
        base = _anu_tree(str(tmp_path))
        rt, rj = create_dataset_reader("anu", base), janu.APDatasetReader(base)
    else:
        from eqvio_tpu.data import create_dataset_reader as jcreate

        _, t = trees["asl" if mode == "asl" else "uzh"]
        rt, rj = create_dataset_reader(mode, str(t)), jcreate(mode, str(t))
    assert len(rt.images.stamps) == len(rj.images.stamps) >= 3
    for i in range(len(rt.images.stamps)):
        img = rt.load_image(i)
        assert img.dtype == np.float32 and 0.0 <= img.min() and img.max() <= 1.0
        np.testing.assert_array_equal(img, rt.load_image_u8(i).astype(np.float32) / 255.0)
        np.testing.assert_array_equal(img, rj.load_image(i), err_msg=f"frame {i}")


def test_flush_all_and_close_match_jax(tmp_path):
    """``native.flush_all`` writes what every open stream holds (a no-op
    where the library does not build, as in the JAX package), and
    ``VIOWriter.close`` is its ``flush``."""
    from eqvio_tpu.io import native as jnative

    tnative.flush_all()
    jnative.flush_all()
    if tnative.available():
        path = str(tmp_path / "stream.txt")
        f = tnative.AsyncFile(path)
        f.write("one\ntwo\n")
        tnative.flush_all()
        assert open(path).read() == "one\ntwo\n"
        f.close()
    for cls, sub in ((VIOWriter, "t"), (JWriter, "j")):
        w = cls(str(tmp_path / sub))
        w.write_timing(1.0, {"total": 2e-3})
        w.close()
    assert open(tmp_path / "t" / "timing.csv").read() == open(tmp_path / "j" / "timing.csv").read()
