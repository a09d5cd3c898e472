"""The metrics the program times itself, on a small ``mh03.seq`` cell on the
CPU: its set-up and window as a run makes them, then every metric that
reads :mod:`benchmark.program_trace`."""

from __future__ import annotations

import json
import os

import pytest

from benchmark import drivers, program_trace
from benchmark.run import read_metric
from benchmark.spans import Spans
from benchmark.tests.small import small_cell, window_seconds

STAGES = ("frontend_ms_per_frame.seq", "ransac_ms_per_frame.seq", "propagation_ms_per_frame.seq",
          "update_ms_per_frame.seq")


def test_program_trace_gives_all_eight_metrics(tmp_path):
    cell = small_cell("mh03.seq")
    drv = drivers.load(cell.mix["driver"])(cell.cfg, cell.mix, cell.config, 3100000001, "cpu", Spans(),
                                           str(tmp_path))
    drv.setup()
    drv.window(window_seconds(cell))
    summary, view = drv.summary, drv.view
    names = [m["name"] for m in cell.metrics("per_layer") if m["source"] == "program_span" and
             m["name"] not in ("host_ms_per_frame.seq", "pass_setup_s.seq")]
    assert len(names) == 8
    got = {name: read_metric(name, drv) for name in names}
    assert all(v is not None for v in got.values()), got
    assert drv.summary is summary and drv.view is view  # the check's and the other metrics' inputs
    assert sum(got[s] for s in STAGES) == pytest.approx(got["step_ms_per_frame.seq"], rel=1e-9)
    assert all(got[s] >= 0 for s in STAGES) and 0 <= got["step_idle_share.seq"] < 100
    assert got["pass_capture_s.seq"] == 0.0  # the CPU runs the step without a graph
    parts = summary["setup_parts_s"]
    assert got["pass_measure_s.seq"] + got["pass_capture_s.seq"] + parts["runner"] == \
        pytest.approx(summary["setup_s"], rel=0.01)
    with open(tmp_path / "program_trace.json") as f:
        written = json.load(f)
    assert sum(written["idle_by_host_s"].values()) == pytest.approx(written["idle_s"], rel=0.01)
    assert written["frames"] == len(drv.scene.images.stamps) - cell.mix["chunk_size"]
    wall = written["pass_wall_s"]  # the instrumented pass's wall time in parts
    assert sum(v for k, v in wall.items() if k != "wall") == pytest.approx(wall["wall"], rel=1e-9)
    assert min(wall.values()) >= 0 and wall["stretch"] == pytest.approx(written["window_s"], rel=1e-9)
    assert written["window_pass_s"] > 0
    assert sum(written["stage_share_pct"].values()) == pytest.approx(100.0, rel=1e-9)
    assert os.path.exists(tmp_path / "instrumented" / "features.csv")


def test_program_trace_reads_nothing_without_a_traced_program():
    class Parent:  # a program whose run_dataset takes no trace
        scene = config = mix = dtype = dev = ckpt_every = lag = out_dir = None

        @staticmethod
        def run_dataset(dataset, config, chunk_size=16):
            raise AssertionError("not called")

    assert program_trace.reading(Parent()) is None
    assert program_trace.setup_part("capture")(Parent()) is None
