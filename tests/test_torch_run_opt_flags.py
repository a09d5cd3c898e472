"""``run_opt``'s ``--simvis`` and ``--simimu`` against ``eqvio_tpu``'s
``run_dataset`` with the same flags over 20 frames of the same tree (float64
on the CPU: the same feature ids, positions within 1e-6 m, the float32
tracker's pixels within 1e-3 px), the live map
server on an ephemeral port, and the figures of ``analysis.make_report`` and
``visualisation``.
"""

import json
import os
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eqvio_tpu.app.run_opt as jax_run_opt
import eqvio_tpu_torch.app.run_opt as torch_run_opt
from eqvio_tpu.data import generate_asl_dataset
from eqvio_tpu.io import load_config
from eqvio_tpu_torch import visualisation as V
from eqvio_tpu_torch.analysis import make_report
from eqvio_tpu_torch.io import bench_config
from tests.test_torch_run_opt import _recording_writer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 20


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("asl"))
    generate_asl_dataset(out, end_time=2.6, width=320, height=240, frame_freq=10.0, num_points=300)
    return out


def _config():
    """The template config under the benchmark's switches (as ``tests/test_torch_run_opt.py``), 12 features."""
    cfg = bench_config(load_config(os.path.join(REPO, "configs", "config_template.yaml")))
    cfg["GIFT"].update(maxFeatures=12, winSize=15)
    return cfg


@pytest.mark.parametrize("flag,chunk", [("simvis", 1), ("simimu", 8)])
def test_sim_flags_match_jax(tree, tmp_path, monkeypatch, flag, chunk):
    """``simvis`` runs the per-frame loop in both packages, ``simimu`` the
    fused one."""
    rows_j, rows_t = {}, {}
    monkeypatch.setattr(jax_run_opt, "VIOWriter", _recording_writer(jax_run_opt.VIOWriter, rows_j))
    monkeypatch.setattr(torch_run_opt, "VIOWriter", _recording_writer(torch_run_opt.VIOWriter, rows_t))
    cfg = _config()
    _, sum_j = jax_run_opt.run_dataset(tree, cfg, output_dir=str(tmp_path / "j"), chunk_size=chunk,
                                       limit_frames=FRAMES, dtype=jnp.float64, **{flag: True})
    _, sum_t = torch_run_opt.run_dataset(tree, cfg, output_dir=str(tmp_path / "t"), chunk_size=chunk,
                                         limit_frames=FRAMES, device="cpu", **{flag: True})
    assert sum_t["frames"] == sum_j["frames"] == FRAMES and sum_t["healthy"] and sum_j["healthy"]
    assert sum_t["landmarks"] == sum_j["landmarks"]
    tracked = [int(m.sum()) for _, _, m in rows_t["features"]]
    assert min(tracked) >= 1 and np.mean(tracked) >= 6, tracked  # the filter sees features on every frame
    for k, ((tj, pj), (tt, pt)) in enumerate(zip(rows_j["states"], rows_t["states"])):
        assert tj == tt
        np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=0, err_msg=f"frame {k} position")
    for k, ((px_j, id_j, m_j), (px_t, id_t, m_t)) in enumerate(zip(rows_j["features"], rows_t["features"])):
        np.testing.assert_array_equal(m_t, m_j, err_msg=f"frame {k} mask")
        np.testing.assert_array_equal(id_t[m_t], id_j[m_j], err_msg=f"frame {k} ids")
        np.testing.assert_allclose(px_t[m_t], px_j[m_j], atol=1e-3, rtol=0, err_msg=f"frame {k} pixels")
    assert len(rows_t["states"]) == FRAMES


@pytest.mark.parametrize("override", [{"imu_window": 16}, {"camera_lag": 0.004}], ids=["imu_window", "camera_lag"])
def test_window_and_lag_overrides_match_jax(tree, tmp_path, monkeypatch, override):
    """``imu_window`` and ``camera_lag`` override the derived window and the
    config's lag as in ``eqvio_tpu``: the same rows over 20 frames (the
    port's fused path against the JAX per-frame loop, positions within
    1e-6 m), and rows that differ from the run without the override (a
    window of 16 drops samples of the tree's 20 per frame; the derived one
    is 28)."""
    rows_j, rows_t, rows_0 = {}, {}, {}
    monkeypatch.setattr(jax_run_opt, "VIOWriter", _recording_writer(jax_run_opt.VIOWriter, rows_j))
    cfg = _config()
    _, sum_j = jax_run_opt.run_dataset(tree, cfg, output_dir=str(tmp_path / "j"), chunk_size=1,
                                       limit_frames=FRAMES, dtype=jnp.float64, **override)
    writer = torch_run_opt.VIOWriter
    for rows, kw in ((rows_t, override), (rows_0, {})):
        monkeypatch.setattr(torch_run_opt, "VIOWriter", _recording_writer(writer, rows))
        _, sum_t = torch_run_opt.run_dataset(tree, cfg, output_dir=str(tmp_path / "t"), chunk_size=8,
                                             limit_frames=FRAMES, device="cpu", **kw)
        assert sum_t["frames"] == FRAMES and sum_t["healthy"]
    assert sum_j["frames"] == FRAMES and len(rows_t["states"]) == len(rows_j["states"]) == FRAMES
    for k, ((tj, pj), (tt, pt)) in enumerate(zip(rows_j["states"], rows_t["states"])):
        assert tj == tt
        np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=0, err_msg=f"frame {k} position")
    if "camera_lag" in override:
        assert [t for t, _ in rows_t["states"]] != [t for t, _ in rows_0["states"]]
    else:
        assert any(not np.array_equal(a[1], b[1]) for a, b in zip(rows_t["states"], rows_0["states"]))


def test_explicit_window_and_lag_reproduce_defaults(tree):
    """``imu_window`` equal to the derived value and ``camera_lag`` equal to
    the config's ``cameraLag`` give the default run's numbers bit for bit;
    a lag given with a reader object shifts a copy of its stamps, as a
    path's reader is shifted, and leaves the caller's reader as it was."""
    from eqvio_tpu_torch.data import create_dataset_reader

    cfg = _config()
    cfg_lag = {**cfg, "main": {**(cfg.get("main") or {}), "cameraLag": 0.004}}
    window = torch_run_opt._setup(create_dataset_reader("asl", tree), cfg, torch.float64, "cpu")[-1]
    assert window == 28
    run = lambda data, config, **kw: torch_run_opt.run_dataset(  # noqa: E731
        data, config, chunk_size=8, limit_frames=12, device="cpu", **kw)[1]
    reader = create_dataset_reader("asl", tree)
    stamps = reader.images.stamps.copy()
    base = run(tree, cfg_lag)
    for s in (run(tree, cfg_lag, imu_window=window), run(tree, cfg, camera_lag=0.004),
              run(reader, cfg, camera_lag=0.004)):
        np.testing.assert_array_equal(s["stamps"], base["stamps"])
        np.testing.assert_array_equal(s["positions"], base["positions"])
        np.testing.assert_array_equal(s["feature_ids"], base["feature_ids"])
    np.testing.assert_array_equal(reader.images.stamps, stamps)
    assert not np.array_equal(run(reader, cfg)["stamps"], base["stamps"])


def test_display_flag_is_accepted():
    """``--display`` is accepted and ignored, as in ``eqvio_tpu``'s CLI."""
    from unittest import mock

    seen = {}

    def fake_run(dataset, config, **kwargs):
        seen.update(kwargs)
        return None, {"healthy": True, "frames": 0, "fps": 0.0, "landmarks": 0}

    with mock.patch.object(torch_run_opt, "load_config", return_value={}), \
            mock.patch.object(torch_run_opt, "run_dataset", side_effect=fake_run):
        torch_run_opt.main(["dataset_dir", "config.yaml", "--display", "--device", "cpu"])
    assert seen["device"] == "cpu" and "display" not in seen


def test_sim_flags_need_ground_truth_and_fused_options(tree):
    from eqvio_tpu_torch.data import create_dataset_reader

    reader = create_dataset_reader("asl", tree)
    reader.groundtruth = None
    with pytest.raises(ValueError, match="ground truth"):
        torch_run_opt.run_dataset(reader, _config(), device="cpu", simimu=True, limit_frames=2)
    with pytest.raises(ValueError, match="fused path"):
        torch_run_opt.run_dataset(tree, _config(), device="cpu", simvis=True, live_port=0, limit_frames=2)


def _get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=30) as r:
        assert r.status == 200
        return r.read()


def test_live_display_server_answers(tree):
    """The fused run serves its map on localhost; the server answers the
    page, the status and the rendered map."""
    server = V.LiveDisplayServer(port=0)
    try:
        base = f"http://127.0.0.1:{server.port}"
        rng = np.random.default_rng(0)
        for k in range(5):
            server.update(0.1 * k, np.eye(3), np.array([0.1 * k, 0, 0]), np.eye(3), np.zeros(3),
                          rng.normal(size=(4, 3)) + [0, 0, 3], np.arange(4), np.ones(4, bool),
                          gt_position=np.array([0.1 * k, 0.01, 0]))
        assert b"live map" in _get(base + "/")
        assert json.loads(_get(base + "/status.json")) == {"frames": 5, "t": 0.4}
        assert _get(base + "/map.png")[:8] == b"\x89PNG\r\n\x1a\n"
        assert len(server.display.persistent) == 4  # seen in more than 3 frames
    finally:
        server.close()
    _, summary = torch_run_opt.run_dataset(tree, _config(), device="cpu", chunk_size=4, limit_frames=8, live_port=0)
    assert summary["frames"] == 8


def test_figures_written(tree, tmp_path):
    out = str(tmp_path / "run")
    torch_run_opt.run_dataset(tree, _config(), device="cpu", chunk_size=4, limit_frames=16, output_dir=out,
                              timing=True)
    gt = os.path.join(tree, "mav0", "state_groundtruth_estimate0", "data.csv")
    paths = make_report(out, gt)
    assert {"trajectory", "position_error", "velocity", "biases", "camera_offset", "features",
            "timing_flamegraph", "timing_boxplots", "timing_histograms"} <= set(paths)
    assert all(os.path.getsize(p) > 0 for p in paths.values())
    extra = {"nees": V.plot_nees(np.arange(10), np.linspace(1, 3, 10), str(tmp_path / "nees.pdf")),
             "overlay": V.plot_feature_overlay(np.zeros((12, 16)), np.array([[3.0, 4.0], [5.0, 6.0]]),
                                               np.array([True, False]), str(tmp_path / "overlay.pdf")),
             "map": V.MapDisplay().render(str(tmp_path / "map.pdf"))}
    assert all(os.path.getsize(p) > 0 for p in extra.values())
