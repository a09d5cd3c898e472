"""The port's fused chunk path against ``eqvio_tpu``'s fused path and the
port's own per-frame loop, on the hermetic synthetic ASL scene of
``tests/test_torch_run_opt.py``, in float64 on the CPU.

- The fused run (``chunk_size=8`` over 20 frames: 8 + 8 + 4, so the last
  chunk is padded) equals ``eqvio_tpu.app.run_opt.run_dataset(chunk_size=8)``:
  positions to 1e-6 m, tracked ids exactly, pixels to 1e-3 px.
- It equals the port's per-frame run in every CSV to 1e-9.
- The frame step runs under a guard that raises on every host sync and on
  every tensor built from host data, which is what a CUDA graph capture
  refuses: with the bench config, with feature predictions, with the racing
  proxy's fisheye config and with the template config's accurate Riccati
  in dense covariance.
- ``predict_state``, ``process_vision(do_update=False)`` and the device-gated
  tracker step equal their JAX counterparts.
- The tracer: stamps off leave the step's ops as they were; on, they add one
  stamp op per stage boundary and nothing else.  The traced run's frames,
  stamps, spans, set-up parts and idle attribution hold together.
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import eqvio_tpu.app.run_opt as jax_run_opt
import eqvio_tpu_torch.app.run_opt as torch_run_opt
from eqvio_tpu import filter as JF
from eqvio_tpu.camera import default_test_camera
from eqvio_tpu.data import generate_asl_dataset
from eqvio_tpu.frontend import tracker as jtracker
from eqvio_tpu.io import load_config
from eqvio_tpu_torch import camera as TCam
from eqvio_tpu_torch import convert
from eqvio_tpu_torch import filter as TF
from eqvio_tpu_torch.data import SyntheticASLReader, SyntheticUZHFPVReader
from eqvio_tpu_torch.frontend import tracker as ttracker
from eqvio_tpu_torch.graph import broadcast_lanes
from eqvio_tpu_torch.io import bench_config, template_config
from eqvio_tpu_torch.io.timing import SPAN_FIELDS, write_trace
from eqvio_tpu_torch import stamps as S
from tests.test_torch_core import (
    F64,
    NCAP,
    _filter_settings,
    _frame_inputs,
    _jax_imu,
    _mid_sequence_state,
    _torch_imu,
    assert_tree_close,
    tt,
)
from tests.test_torch_cuda import fused_inputs
from tests.test_torch_run_opt import _recording_writer, one_torch_thread  # noqa: F401 (autouse fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENE = dict(end_time=4.0, width=320, height=240, frame_freq=10.0, num_points=300)
FRAMES, CHUNK = 20, 8
CSVS = ("IMUState.csv", "features.csv", "points.csv", "bias.csv", "camera.csv")


def _no_stage_programs(*args):
    """Stand-ins for the JAX package's six stage programs: its ``_run_fused``
    still builds the calibration's keys and the timing rows, without
    compiling six more XLA programs on the CPU."""
    features = lambda *a: (None, (None, None, None))  # noqa: E731
    other = lambda *a: None  # noqa: E731
    return features, other, other, other, other, other


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    base = tmp_path_factory.mktemp("fused")
    generate_asl_dataset(str(base / "asl"), **SCENE)
    return base


def _run_all(base, tag, cfg, plan):
    """Run each ``(name, module, kwargs)`` of ``plan`` over the scene in
    ``base``, writing CSVs to ``base/tag/name``; returns ``{name: (recorded
    writer rows, summary, CSV dir)}``."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, mod, kw in plan:
            rows = {}
            if mod is jax_run_opt:
                mp.setattr(mod, "_make_stage_runners", _no_stage_programs)
            mp.setattr(mod, "VIOWriter", _recording_writer(mod.VIOWriter, rows))
            csv_dir = base / tag / name
            _, summary = mod.run_dataset(str(base / "asl"), cfg, output_dir=str(csv_dir), limit_frames=FRAMES, **kw)
            mp.undo()
            out[name] = (rows, summary, csv_dir)
    return out


def _template_config(predictions: bool) -> dict:
    cfg = bench_config(load_config(os.path.join(REPO, "configs", "config_template.yaml")))
    cfg["eqf"]["settings"]["useFeaturePredictions"] = predictions
    return cfg


@pytest.fixture(scope="module")
def runs(scene):
    """The JAX fused run, the port's fused run (both with ``timing``; the
    port's traced too) and the port's per-frame run, each with its recorded
    writer rows and CSVs."""
    return _run_all(scene, "bench", _template_config(False), (
        ("jax", jax_run_opt, dict(chunk_size=CHUNK, timing=True, dtype=jnp.float64)),
        ("fused", torch_run_opt, dict(chunk_size=CHUNK, timing=True, trace=True, device="cpu")),
        ("frame", torch_run_opt, dict(chunk_size=1, device="cpu")),
    ))


def test_fused_matches_jax_fused(runs):
    _assert_matches_jax(runs["jax"], runs["fused"])


def _assert_matches_jax(run_j, run_t):
    """Positions to 1e-6 m, tracked masks and ids exactly, pixels to 1e-3 px."""
    rows_j, sum_j, _ = run_j
    rows_t, sum_t, _ = run_t
    assert sum_t["frames"] == sum_j["frames"] == FRAMES
    assert sum_t["healthy"] and sum_j["healthy"]
    assert sum_t["landmarks"] == sum_j["landmarks"] >= 10
    assert len(rows_t["states"]) == len(rows_j["states"]) == FRAMES
    for k, ((tj, pj), (tt_, pt)) in enumerate(zip(rows_j["states"], rows_t["states"])):
        assert tj == tt_
        np.testing.assert_allclose(pt, pj, atol=1e-6, rtol=0, err_msg=f"frame {k} position")
    np.testing.assert_allclose(sum_t["positions"], np.stack([p for _, p in rows_j["states"]]), atol=1e-6, rtol=0)
    for k, ((px_j, id_j, m_j), (px_t, id_t, m_t)) in enumerate(zip(rows_j["features"], rows_t["features"])):
        np.testing.assert_array_equal(m_t, m_j, err_msg=f"frame {k} tracked mask")
        np.testing.assert_array_equal(id_t[m_t], id_j[m_j], err_msg=f"frame {k} ids")
        np.testing.assert_array_equal(sum_t["feature_ids"][k][m_t], id_j[m_j])
        np.testing.assert_allclose(px_t[m_t], px_j[m_j], atol=1e-3, rtol=0, err_msg=f"frame {k} pixels")
    if "searched_frame_fraction" in sum_j:
        assert sum_t["searched_frame_fraction"] == sum_j["searched_frame_fraction"]


@pytest.mark.parametrize("name", CSVS)
def test_fused_matches_per_frame_csv(runs, name):
    """Every CSV of the fused run equals the per-frame run's to 1e-9 (a
    packing misalignment would corrupt features and points while leaving
    the first columns of IMUState intact)."""
    with open(runs["fused"][2] / name) as f:
        lines_f = f.readlines()
    with open(runs["frame"][2] / name) as f:
        lines_p = f.readlines()
    assert len(lines_f) == len(lines_p) == FRAMES + 1 and lines_f[0] == lines_p[0], name
    for la, lb in zip(lines_f[1:], lines_p[1:]):
        ca = [float(c) for c in la.split(",") if c.strip()]
        cb = [float(c) for c in lb.split(",") if c.strip()]
        assert len(ca) == len(cb), (name, la[:80], lb[:80])
        np.testing.assert_allclose(ca, cb, atol=1e-9, rtol=0, err_msg=name)


def test_fused_summary_matches_per_frame(runs):
    _, s_f, _ = runs["fused"]
    _, s_p, _ = runs["frame"]
    np.testing.assert_array_equal(s_f["stamps"], s_p["stamps"])
    np.testing.assert_allclose(s_f["positions"], s_p["positions"], atol=1e-9, rtol=0)
    np.testing.assert_array_equal(s_f["feature_ids"], s_p["feature_ids"])
    assert s_f["landmarks"] == s_p["landmarks"] and s_f["healthy"] == s_p["healthy"]


def test_timing_rows_and_device_sections(runs):
    _, sum_j, out_j = runs["jax"]
    _, sum_t, out_t = runs["fused"]
    with open(out_t / "timing.csv") as f:
        lines = f.readlines()
    with open(out_j / "timing.csv") as f:
        header_j = f.readline()
    assert lines[0] == header_j
    assert [c.strip() for c in lines[0].split(",")][1:] == torch_run_opt.TIMING_LABELS
    assert len(lines) == FRAMES + 1
    assert set(sum_t["device_sections_ms"]) == set(sum_j["device_sections_ms"])
    assert all(v >= 0 for v in sum_t["device_sections_ms"].values())
    assert sum_t["device_ms_per_frame"] > 0
    assert "enqueue_ms_per_frame" not in sum_t  # a host enqueue time exists on the card only
    keys = ("dispatch_ms_per_frame", "fetch_ms_per_frame", "write_ms_per_frame", "host_ms_per_frame",
            "searched_frame_fraction", "device_ms_per_frame", "device_sections_ms")
    assert all(k in sum_j and k in sum_t for k in keys)
    assert set(sum_t["host_ms_per_frame"]) == set(sum_j["host_ms_per_frame"])


@pytest.mark.parametrize("K,N", [(8, 5), (12, 30)])
def test_packing_matches_jax(K, N):
    assert torch_run_opt._meta_width(K) == jax_run_opt._meta_width(K)
    assert torch_run_opt._out_width(N) == jax_run_opt._out_width(N)
    rng = np.random.default_rng(K * N)
    row = rng.normal(size=torch_run_opt._out_width(N))
    row[33] = 1.0
    for a, b in zip(torch_run_opt._unpack_outputs(row, N), jax_run_opt._unpack_outputs(row, N)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# host syncs, and ``lift_fresh``: a tensor made from host data (``torch.tensor``,
# or a Python number assigned into a tensor), a host-to-device copy on the card
_SYNCS = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default,
          torch.ops.aten.masked_select.default, torch.ops.aten.lift_fresh.default}
_INDEXING = {torch.ops.aten.index.Tensor, torch.ops.aten.index_put.default, torch.ops.aten.index_put_.default}


class _HostGuard(TorchDispatchMode):
    """Raise on a host sync: ``_local_scalar_dense`` (``.item()``,
    ``bool()`` and indexing by a 0-dim tensor reach it), ``nonzero``,
    ``masked_select`` and indexing by a boolean mask, whose result size
    the host must read; and on a tensor made from host data."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in _SYNCS or (func in _INDEXING and any(
                t is not None and t.dtype in (torch.bool, torch.uint8) for t in args[1])):
            raise RuntimeError(f"host sync in the frame step: {func}")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def no_host_sync_or_host_data():
    """The guard of the frame step: ``Tensor.__bool__``, ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()`` and ``torch.tensor`` /
    ``torch.as_tensor`` of anything but a tensor raise."""
    def refuse(what):
        def fn(*args, **kwargs):
            raise RuntimeError(f"{what} in the frame step")
        return fn

    real_as_tensor = torch.as_tensor

    def as_tensor(data, *args, **kwargs):
        if not isinstance(data, torch.Tensor):
            raise RuntimeError("torch.as_tensor of host data in the frame step")
        return real_as_tensor(data, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        for name in ("__bool__", "item", "tolist", "cpu", "numpy"):
            mp.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
        mp.setattr(torch, "tensor", refuse("torch.tensor"))
        mp.setattr(torch, "as_tensor", as_tensor)
        with _HostGuard():
            yield


def test_guard_catches_host_syncs():
    x, i = torch.arange(4.0), torch.tensor(1)
    for bad in (lambda: bool(x[0] > 1), lambda: x.sum().item(), lambda: x[i], lambda: x.tolist(),
                lambda: torch.tensor([1.0]), lambda: x[x > 1], lambda: torch.as_tensor(np.zeros(2)),
                lambda: x.__setitem__(2, 1.0)):
        with pytest.raises(RuntimeError), no_host_sync_or_host_data():
            bad()
    with no_host_sync_or_host_data():
        torch.where(x > 1, x, 0.0).sum()


def _guard_case(case: str):
    """``(reader, config, dtype)`` of a guarded frame-step case: the bench
    config (with feature predictions), the racing proxy's config on a small
    fisheye scene in float32 (square-root, as on the card), and the template
    config (accurate Riccati, Euclidean, median depth) in dense float64."""
    if case == "racing":
        reader = SyntheticUZHFPVReader(end_time=1.5, width=160, height=120, frame_freq=10.0, num_points=150)
        return reader, load_config(os.path.join(REPO, "configs", "config_racing_proxy.yaml")), torch.float32
    reader = SyntheticASLReader(end_time=1.5, width=160, height=120, frame_freq=10.0, num_points=150)
    if case == "template-dense":
        return reader, template_config(), F64
    cfg = bench_config()
    cfg["eqf"]["settings"]["useFeaturePredictions"] = case == "feature-predictions"
    return reader, cfg, F64


@pytest.mark.parametrize("case", ["bench", "feature-predictions", "racing", "template-dense"])
def test_frame_step_has_no_host_sync(case):
    """After one warm-up frame (which builds the cached constants), the
    frame step runs a full chunk under the guard, padded tail included."""
    reader, cfg, dtype = _guard_case(case)
    imgs_t, meta_t, state, tracker, settings, tcfg, camera, K = fused_inputs(reader, cfg, 6, "cpu", dtype)
    assert settings.use_feature_predictions == (case == "feature-predictions")
    assert settings.sqrt_covariance == (case != "template-dense")
    assert settings.use_accurate_riccati == (case == "template-dense")
    runner = torch_run_opt.ChunkRunner(tcfg, settings, settings.suite, camera, K, dtype, state, tracker,
                                       torch.device("cpu"))
    meta_t[5:] = 0.0  # a padded tail frame
    runner.run(imgs_t[:1], meta_t[:1])
    before = [t.clone() for t in runner.step.carry]
    with no_host_sync_or_host_data():
        outs = runner.run(imgs_t[1:5], meta_t[1:5])
    after = [t.clone() for t in runner.step.carry]
    with no_host_sync_or_host_data():
        runner.run(imgs_t[5:], meta_t[5:])
    assert all(torch.equal(a, b) for a, b in zip(after, runner.step.carry))  # padded: carry unchanged
    assert not all(torch.equal(a, b) for a, b in zip(before, after))
    assert torch.isfinite(outs).all() and outs.shape == (4, torch_run_opt._out_width(tcfg.max_features))


def test_predict_state_matches_jax():
    settings_j = _filter_settings(False, False)
    cam_j = default_test_camera()
    pts = np.random.default_rng(2).uniform(-0.5, 0.5, size=(NCAP, 3)) + [0, 0, 4.0]
    st_j, r = _mid_sequence_state(settings_j, cam_j, pts)
    st_t = convert.eqf_state_from_numpy(st_j, F64, "cpu")
    imu, dts = _frame_inputs(r, 3)
    xi_j = JF.predict_state(st_j, jnp.asarray(imu["stamp"][-1]), _jax_imu(imu), jnp.asarray(dts))
    xi_t = TF.predict_state(st_t, _torch_imu(imu), tt(dts))
    assert_tree_close(xi_j, xi_t, 1e-12, "predicted state")
    assert not np.allclose(np.asarray(xi_j.sensor.pose.x), np.asarray(JF.state_estimate(st_j).sensor.pose.x))


@pytest.mark.parametrize("median_depth", [False, True])
def test_process_vision_without_update_matches_jax(median_depth):
    settings_j = _filter_settings(False, median_depth)
    settings_t = convert.settings_from_jax_settings(settings_j)
    cam_j = default_test_camera()
    cam_t = TCam.PinholeCamera.create(400.0, 400.0, 400.0, 240.0, 800, 480, dtype=F64, device="cpu")
    pts = np.random.default_rng(2).uniform(-0.5, 0.5, size=(NCAP, 3)) + [0, 0, 4.0]
    st_j, r = _mid_sequence_state(settings_j, cam_j, pts)
    st_t = convert.eqf_state_from_numpy(st_j, F64, "cpu")
    imu, dts = _frame_inputs(r, 3)
    vis = np.arange(NCAP) < 7
    vis[2], vis[8] = False, True
    ids = np.arange(NCAP)
    ids[3], ids[8] = 103, 108
    pix_j = cam_j.project(jnp.asarray(pts)) + jnp.asarray(r.normal(size=(NCAP, 2)) * 0.3)
    sj = JF.propagate_window(st_j, _jax_imu(imu), jnp.asarray(dts), settings_j, wide_factor=True)
    st = TF.propagate_window(st_t, _torch_imu(imu), tt(dts), settings_t, wide_factor=True)
    sj = JF.process_vision(sj, pix_j, jnp.asarray(vis), jnp.asarray(ids), cam_j, settings_j, do_update=False)
    st = TF.process_vision(st, tt(pix_j), torch.as_tensor(vis), torch.as_tensor(ids), cam_t, settings_t,
                           do_update=False)
    assert_tree_close(sj, st, 1e-9, "preprocessed state")
    assert st.Sigma.shape == (st.xi0.dim(), st.xi0.dim())


def test_device_gated_tracker_matches_jax():
    """The detector gate decided on the device: the port's tracker equals
    JAX's ``lax.cond`` over frames where the gate both fires and skips."""
    reader = SyntheticASLReader(end_time=1.5, width=320, height=240, frame_freq=10.0, num_points=300)
    kw = dict(max_features=20, win_size=15, max_error=0.08, feature_search_threshold=0.75,
              ransac_inlier_threshold=0.9, ransac_hypotheses=64, ransac_min_inliers=8)
    cfg_j, cfg_t = jtracker.TrackerConfig(**kw), ttracker.TrackerConfig(**kw)
    step_j = jax.jit(lambda s, im: jtracker.tracker_step(s, im, cfg_j))
    sj = jtracker.tracker_init(cfg_j, (240, 320))
    st = ttracker.tracker_init(cfg_t, (240, 320), "cpu")
    searched = []
    for i in range(8):
        img = reader.load_image_u8(i).astype(np.float32) * (1.0 / 255.0)
        sj = step_j(sj, jnp.asarray(img))
        st = ttracker.tracker_step(st, torch.from_numpy(img), cfg_t)
        np.testing.assert_array_equal(st.mask.numpy(), np.asarray(sj.mask), err_msg=f"frame {i}")
        np.testing.assert_array_equal(st.ids.numpy(), np.asarray(sj.ids), err_msg=f"frame {i}")
        assert int(st.next_id) == int(sj.next_id)
        assert bool(st.searched) == bool(sj.searched)
        np.testing.assert_allclose(st.positions.numpy(), np.asarray(sj.positions), atol=1e-4, rtol=0)
        searched.append(bool(st.searched))
    assert any(searched) and not all(searched), searched


@pytest.mark.parametrize("threshold", [1.0, 0.0])
def test_static_gate_settings(threshold):
    """A threshold of 1 always runs the detector; one of 0 never does."""
    reader = SyntheticASLReader(end_time=0.5, width=160, height=120, frame_freq=10.0, num_points=100)
    cfg = ttracker.TrackerConfig(max_features=10, win_size=11, feature_search_threshold=threshold)
    st = ttracker.tracker_init(cfg, (120, 160), "cpu")
    for i in range(2):
        st = ttracker.tracker_step(st, torch.from_numpy(reader.load_image_u8(i)).float() / 255.0, cfg)
        assert bool(st.searched) == (threshold >= 1.0)
    assert (int(st.next_id) > 0) == (threshold >= 1.0)


@pytest.mark.parametrize("flag", ["--simvis", "--simimu", "--checkpointEvery=5", "--resume=x", "--live=8000"])
def test_unported_cli_flags_raise(flag, monkeypatch):
    """The flags that raised before they were ported now reach run_dataset."""
    seen = {}
    monkeypatch.setattr(torch_run_opt, "load_config", lambda path: {})
    monkeypatch.setattr(torch_run_opt, "run_dataset", lambda dataset, config, **kw: (
        seen.update(kw), (None, {"healthy": True, "frames": 0, "fps": 0.0, "landmarks": 0}))[1])
    torch_run_opt.main(["dataset_dir", "config.yaml", "--device", "cpu", flag])
    expected = {"--simvis": ("simvis", True), "--simimu": ("simimu", True),
                "--checkpointEvery=5": ("checkpoint_every", 5), "--resume=x": ("resume", "x"),
                "--live=8000": ("live_port", 8000)}[flag]
    assert seen[expected[0]] == expected[1]


def test_cli_passes_fused_options(monkeypatch):
    seen = {}

    def fake_run(dataset, config, **kwargs):
        seen.update(kwargs)
        return None, {"healthy": True, "frames": 0, "fps": 0.0, "landmarks": 0}

    monkeypatch.setattr(torch_run_opt, "load_config", lambda path: {"main": {"limitRate": 15.0}})
    monkeypatch.setattr(torch_run_opt, "run_dataset", fake_run)
    torch_run_opt.main(["d", "c.yaml", "--chunk", "4", "--f64", "--profile", "p", "--timing"])
    assert seen["chunk_size"] == 4 and seen["dtype"] == torch.float64 and seen["profile_dir"] == "p"
    assert seen["limit_rate"] == 15.0 and seen["timing"] and seen["device"] == "cuda"
    torch_run_opt.main(["d", "c.yaml", "--limitRate", "5"])
    assert seen["chunk_size"] == 16 and seen["dtype"] is None and seen["limit_rate"] == 5.0


def test_profile_dir_writes_a_trace(tmp_path):
    reader = SyntheticASLReader(end_time=1.0, width=160, height=120, frame_freq=10.0, num_points=100)
    _, summary = torch_run_opt.run_dataset(reader, bench_config(), device="cpu", chunk_size=4, limit_frames=4,
                                           profile_dir=str(tmp_path / "prof"))
    assert summary["frames"] == 4 and (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert "graph" not in summary  # the CPU calls the step directly
    assert "profile" not in summary  # the whole run was traced



# the fused path's summary on the CPU without timing or trace, before the set-up's parts
FUSED_KEYS = {"achieved_gflops", "achieved_hbm_gbps", "counters", "decode_ms_per_frame", "decoder",
              "device_ms_per_frame", "dispatch_ms_per_frame", "feature_ids", "fetch_ms_per_frame", "final_position",
              "flops_per_frame", "fps", "frames", "hbm_bytes_per_frame", "healthy", "host_ms_per_frame", "landmarks",
              "nan", "positions", "searched_frame_fraction", "setup_s", "sigma_pd", "stamps", "write_ms_per_frame"}
SETUP_PARTS = {"runner", "capture", "timing_replays", "enqueue_probe", "cost_count"}


def _is_stamp(op) -> bool:
    return op._schema.name == "eqvio_tpu_torch::frame_stamp"


class _OpRecorder(TorchDispatchMode):
    """Every op the block issues, with the slot of each stamp."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append((func, args[1] if _is_stamp(func) else None))
        return func(*args, **(kwargs or {}))


def test_stamps_add_only_their_ops_to_the_step():
    """Without stamps the frame step issues no stamp op (so the graph the card
    captures is the one without the tracer); with them, under the host-sync
    guard, the same ops plus one stamp per stage boundary, in order, and the
    cost count is the same.  A lane batch does not stamp."""
    reader, cfg, dtype = _guard_case("bench")
    imgs, meta, state, tracker, settings, tcfg, camera, K = fused_inputs(reader, cfg, 3, "cpu", dtype)
    runners = {on: torch_run_opt.ChunkRunner(tcfg, settings, settings.suite, camera, K, dtype, state, tracker,
                                             torch.device("cpu"), stamps=on) for on in (False, True)}
    ops = {}
    for on, r in runners.items():
        r.run(imgs[:1], meta[:1])
        with no_host_sync_or_host_data(), _OpRecorder() as rec:
            r.run(imgs[1:2], meta[1:2])
        ops[on] = rec.ops
    assert not any(_is_stamp(op) for op, _ in ops[False]) and len(ops[False]) > 1000
    assert [op for op, _ in ops[True] if not _is_stamp(op)] == [op for op, _ in ops[False]]
    assert [slot for op, slot in ops[True] if _is_stamp(op)] == list(range(len(S.STAMPS)))
    assert runners[False].row is None and bool((runners[True].row.diff() >= 0).all())
    off, on = (runners[k].step.cost_analysis() for k in (False, True))
    assert (on["flops"], on["bytes accessed"], on["ops"]) == (off["flops"], off["bytes accessed"],
                                                               off["ops"] + len(S.STAMPS))
    with pytest.raises(ValueError):
        torch_run_opt.ChunkRunner(tcfg, settings, settings.suite, camera, K, dtype,
                                  *broadcast_lanes((state, tracker), 2), torch.device("cpu"), stamps=True)


def test_summary_keys_and_setup_parts(runs):
    """Untraced, the summary has the keys it had and the set-up's parts; the
    parts sum to the set-up; the traced run adds its block alone."""
    reader = SyntheticASLReader(end_time=1.0, width=160, height=120, frame_freq=10.0, num_points=100)
    _, off = torch_run_opt.run_dataset(reader, bench_config(), device="cpu", chunk_size=4, limit_frames=4)
    assert set(off) == FUSED_KEYS | {"setup_parts_s"}
    _, on, _ = runs["fused"]
    assert set(on) == FUSED_KEYS | {"setup_parts_s", "device_sections_ms", "trace"}
    for s in (off, on):
        parts = s["setup_parts_s"]
        assert set(parts) == SETUP_PARTS and all(v >= 0 for v in parts.values())
        assert parts["capture"] == parts["enqueue_probe"] == 0.0  # the CPU captures no graph
        assert sum(parts.values()) == pytest.approx(s["setup_s"], rel=0.01)


def test_traced_frames_and_stages(runs):
    """Each frame's stamps do not decrease, frames follow one another in
    order with their ids and chunks, each row is in hand after its frame
    ended, the timing rows' stages sum to the frame's stamped span, and the
    idle seconds by host span are the gaps between frames."""
    _, s, out_dir = runs["fused"]
    tb = s["trace"]
    assert tb["stamps"] == list(S.STAMPS) and tb["clock"]["offset_ns"] == 0  # the CPU stamps the host clock
    col = {f: i for i, f in enumerate(tb["frame_fields"])}
    rows = np.asarray(tb["frames"], dtype=np.int64)
    assert rows[:, col["frame"]].tolist() == list(range(FRAMES))
    assert rows[:, col["chunk"]].tolist() == [f // CHUNK for f in range(FRAMES)]
    st = rows[:, col["frame_begin"]:col["frame_end"] + 1]
    assert (np.diff(st, axis=1) >= 0).all() and (st[1:, 0] >= st[:-1, -1]).all()
    assert (rows[:, col["in_hand_ns"]] >= st[:, -1]).all()
    with open(out_dir / "timing.csv") as f:
        header = [c.strip() for c in f.readline().split(",")]
        table = np.array([[float(c) for c in line.split(",")] for line in f])
    stages = table[:, header.index("features")] + table[:, header.index("total vision update")]
    np.testing.assert_allclose(stages, (st[:, S.VISION_END] - st[:, S.FRAME_BEGIN]) * 1e-9, rtol=1e-4)
    sections = s["device_sections_ms"]
    assert sections["features"] == pytest.approx((st[:, S.TRACKER_END] - st[:, S.FRAME_BEGIN]).mean() * 1e-6,
                                                 abs=1e-3)
    assert sections["features_full"] > 0 and sections["features_skip"] >= 0
    gaps = (st[1:, 0] - st[:-1, -1]) * 1e-9
    assert sum(tb["idle_by_host_s"].values()) == pytest.approx(gaps.sum(), rel=1e-9)


def test_traced_spans_nest(runs, tmp_path):
    """Every span lies in its chunk's frames and inside a span of its parent
    on its thread; the fetch thread's spans are not the main thread's; the
    JSON lines hold the block."""
    _, s, _ = runs["fused"]
    spans = [dict(zip(SPAN_FIELDS, sp)) for sp in s["trace"]["spans"]]
    names = {sp["name"] for sp in spans}
    assert {"iter_wait", "imu_window_asm", "chunk", "chunk_pack", "upload", "setup", "setup.runner",
            "setup.timing_replays", "setup.cost_count", "dispatch", "fetch_wait", "write"} <= names
    for sp in spans:
        assert sp["start_ns"] <= sp["end_ns"]
        assert 0 <= sp["chunk"] and sp["chunk"] * CHUNK <= sp["frame_begin"] <= sp["frame_end"] <= \
            (sp["chunk"] + 1) * CHUNK, sp
        assert (sp["thread"] == "main") == (sp["name"] not in ("fetch_wait", "write")), sp
        if sp["parent"] is not None:
            assert any(p["name"] == sp["parent"] and p["thread"] == sp["thread"] and p["chunk"] == sp["chunk"]
                       and p["start_ns"] <= sp["start_ns"] and sp["end_ns"] <= p["end_ns"] for p in spans), sp
    assert all(sp["parent"] == "setup" for sp in spans if sp["name"].startswith("setup."))
    write_trace(s["trace"], str(tmp_path / "trace.jsonl"))
    with open(tmp_path / "trace.jsonl") as f:
        kinds = [json.loads(line)["kind"] for line in f]
    assert kinds == ["clock"] + ["frame"] * FRAMES + ["span"] * len(spans) + ["idle_by_host_s"]


def test_cli_trace_writes_the_block(monkeypatch, tmp_path):
    block = {"stamps": list(S.STAMPS), "frame_fields": ["frame"], "clock": {"offset_ns": 0}, "frames": [[0]],
             "spans": [], "idle_by_host_s": {}}
    seen = {}

    def fake_run(dataset, config, **kwargs):
        seen.update(kwargs)
        return None, {"healthy": True, "frames": 1, "fps": 1.0, "landmarks": 0, "trace": block}

    monkeypatch.setattr(torch_run_opt, "load_config", lambda path: {})
    monkeypatch.setattr(torch_run_opt, "run_dataset", fake_run)
    torch_run_opt.main(["d", "c.yaml", "--trace", "--output", str(tmp_path)])
    assert seen["trace"] and (tmp_path / "trace.jsonl").read_text().count("\n") == 3
    with pytest.raises(SystemExit):
        torch_run_opt.main(["d", "c.yaml", "--trace"])
