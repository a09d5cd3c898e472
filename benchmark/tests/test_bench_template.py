"""The ``template.seq`` cell: EqVIO's default filter (Euclidean landmarks, a
matrix-exponential Riccati step per IMU sample, the discrete lifts, median
depth) on the MH_03 proxy.  Found by name; the program in float64 is the
reference at a small size; its two per-sample metrics read the window's
last pass summary; and a live IMU sample dropped from every window moves
the checkpoint's stretch far past the sound run."""

from __future__ import annotations

import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

from benchmark.run import Cell, run_cell
from benchmark.tests.small import small_cell, window_seconds
from benchmark.tests.test_bench_manifest import NAME, UNIT

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
NEW_METRICS = ("propagation_ms_per_imu_sample.seq", "riccati_live_share.seq")
# the proxy rests for its first 3 s: a 10 s scene puts the checkpoint's stretch in motion
MOVING_S = 10.0


def _metric(name: str):
    spec = importlib.util.spec_from_file_location("m_" + name, os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_cell_is_found_by_name():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cell = Cell("template.seq")
    assert cell.cell["config"] == "template_mh03" and cell.cell["traffic"] == "seq" and cell.cell["chips"] == 1
    assert cell.cfg["name"] == "template_mh03" and cell.cfg["dtype"] == "float32"
    assert list(cell.cfg["reduced"]) == ["end_time"] and cell.cfg["end_time"] < cell.cfg["sequence_s"]
    s = cell.config["eqf"]["settings"]
    assert (s["coordinateChoice"], s["fastRiccati"], s["useDiscreteInnovationLift"], s["useMedianDepth"]) == \
        ("Euclidean", False, True, True)
    assert cell.config["GIFT"]["maxFeatures"] == 30 and cell.config["GIFT"]["ransacParams"]["maxIterations"] == 64
    assert [m["name"] for m in cell.metrics("end_to_end")] == ["seq_frames_per_s", "setup_s"]
    per_layer = {m["name"]: m for m in cell.metrics("per_layer")}
    assert set(NEW_METRICS) <= set(per_layer) and len(per_layer) == 15
    for name in NEW_METRICS:
        m = per_layer[name]
        assert NAME.match(name) and UNIT.match(m["unit"]) and m["moves"] == "seq_frames_per_s"
        assert m["workloads"] == ["template.seq"] and m["layer"] == per_layer[NEW_METRICS[0]]["layer"]
    assert sum(c["name"] == "template_mh03" for c in manifest["configs"]) == 1


def test_yaml_is_the_template_with_the_proxys_depth():
    import yaml

    with open(os.path.join(ROOT, "configs", "config_template.yaml")) as f:
        template = yaml.safe_load(f)
    with open(os.path.join(BENCH, "configs", "template_mh03.yaml")) as f:
        mine = yaml.safe_load(f)
    assert mine["eqf"]["initialValue"]["sceneDepth"] == 9.0
    mine["eqf"]["initialValue"]["sceneDepth"] = template["eqf"]["initialValue"]["sceneDepth"]
    assert mine == template


def _drv(counters, propagation_ms=None):
    drv = types.SimpleNamespace(summary=None if counters is None else {"counters": counters})
    if propagation_ms is not None:
        drv._program_trace = {"propagation_ms_per_frame": propagation_ms}
    return drv


def test_metric_readers():
    counters = {"frames": 320, "riccati_steps": 5120, "imu_samples_live": 3514}
    assert _metric("riccati_live_share.seq")(_drv(counters)) == pytest.approx(100 * 3514 / 5120)
    assert _metric("propagation_ms_per_imu_sample.seq")(_drv(counters, 25.6)) == pytest.approx(25.6 * 320 / 3514)
    # a program without counters (the parent's summary), or without stamps, leaves both out of the line
    for drv in (_drv(None), types.SimpleNamespace(), _drv({}, 25.6)):
        assert all(_metric(n)(drv) is None for n in NEW_METRICS)
    stampless = _drv(counters)
    stampless._program_trace = None
    assert _metric("propagation_ms_per_imu_sample.seq")(stampless) is None


def test_reference_is_the_program_in_float64(tmp_path):
    """The program's float64 ``run_dataset`` with the template's switches
    computes the reference's frames, as ``test_bench_scene`` has it for the
    tuned configurations."""
    torch.set_num_threads(4)
    cell = small_cell("template.seq")
    cell.cfg["dtype"] = "float64"
    res = run_cell(cell, 123456789012, window_seconds(cell), False, device="cpu", out_root=str(tmp_path))
    assert res["correct"] and res["failed"] == 0
    assert res["checks"]["pos_gap_m"]["value"] < 1e-6


def _drop_longest_live_sample(monkeypatch):
    """Every packed IMU window loses its longest live sample (its dt set to
    0), where ``_run_fused`` packs it."""
    from eqvio_tpu_torch.app import run_opt

    pack = run_opt._pack_meta

    def dropped(row, window, stamp):
        ws, wg, wa, wd = window
        wd = np.array(wd, copy=True)
        if (wd > 0).any():
            wd[int(np.argmax(wd))] = 0.0
        pack(row, (ws, wg, wa, wd), stamp)

    monkeypatch.setattr(run_opt, "_pack_meta", dropped)


def test_dropped_imu_sample_moves_the_checkpoint_stretch(monkeypatch, tmp_path):
    """With the checkpoint's stretch in motion, a window short of one live
    sample moves the position thousands of times past the sound run's gap,
    which the CPU's shared gate keeps at round-off.  The cell's
    ``pos_gap_m`` limit (0.35 m) does not see it: on the card the gate
    kernel and the reference's gate part ways on near ties, and the sound
    program reads up to 0.14 m there, as the dropped sample does."""
    torch.set_num_threads(4)
    gaps = {}
    for fault in ("sound", "dropped"):
        cell = small_cell("template.seq")
        cell.cfg["end_time"] = MOVING_S
        hook = None if fault == "sound" else (lambda drv: _drop_longest_live_sample(monkeypatch))
        res = run_cell(cell, 2**31 + 77, window_seconds(cell), False, device="cpu",
                       out_root=str(tmp_path / fault), driver_hook=hook)
        assert res["failed"] == 0
        gaps[fault] = res["checks"]["pos_gap_m"]["value"]
        if fault == "sound":
            assert res["correct"] is True
    assert gaps["sound"] < 1e-4 and gaps["dropped"] > 1e-2
