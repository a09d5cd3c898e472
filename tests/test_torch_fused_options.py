"""The port's fused path with its options on, in float64 on the CPU, on the
hermetic scene of ``tests/test_torch_fused.py``:

- feature predictions: the fused run equals ``eqvio_tpu``'s fused run (both
  project the state predicted over the frame's IMU window) and the per-frame
  run equals its ``chunk_size=1`` run (both project the current estimate):
  positions to 1e-6 m, tracked ids exactly, pixels to 1e-3 px;
- ``profile_chunk``: one chunk of the run traced alone.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

import eqvio_tpu.app.run_opt as jax_run_opt
import eqvio_tpu_torch.app.run_opt as torch_run_opt
from eqvio_tpu.data import generate_asl_dataset
from eqvio_tpu_torch.data import SyntheticASLReader
from eqvio_tpu_torch.io import bench_config
from tests.test_torch_fused import CHUNK, SCENE, _assert_matches_jax, _run_all, _template_config
from tests.test_torch_run_opt import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def prediction_runs(tmp_path_factory):
    """With feature predictions on: each loop of the port and of the JAX
    package (the fused step projects the state predicted over the frame's
    IMU window, the per-frame loop the current estimate)."""
    base = tmp_path_factory.mktemp("predictions")
    generate_asl_dataset(str(base / "asl"), **SCENE)
    return _run_all(base, "predictions", _template_config(True), (
        ("jax", jax_run_opt, dict(chunk_size=CHUNK, dtype=jnp.float64)),
        ("fused", torch_run_opt, dict(chunk_size=CHUNK, device="cpu")),
        ("jax_frame", jax_run_opt, dict(chunk_size=1, dtype=jnp.float64)),
        ("frame", torch_run_opt, dict(chunk_size=1, device="cpu")),
    ))


def test_fused_matches_jax_fused_with_predictions(prediction_runs):
    _assert_matches_jax(prediction_runs["jax"], prediction_runs["fused"])


def test_per_frame_matches_jax_per_frame_with_predictions(prediction_runs):
    _assert_matches_jax(prediction_runs["jax_frame"], prediction_runs["frame"])
    # the two loops predict differently, so their tracks part
    assert not np.allclose(prediction_runs["fused"][1]["positions"], prediction_runs["frame"][1]["positions"],
                           atol=1e-9, rtol=0)


def test_profile_chunk_traces_one_chunk(tmp_path):
    """``profile_chunk`` traces that chunk of the fused run alone: the trace
    holds one chunk's frame steps, and the run's results do not move."""
    reader = SyntheticASLReader(end_time=1.5, width=160, height=120, frame_freq=10.0, num_points=100)
    kw = dict(device="cpu", chunk_size=4, limit_frames=10)
    _, plain = torch_run_opt.run_dataset(reader, bench_config(), **kw)
    _, traced = torch_run_opt.run_dataset(reader, bench_config(), profile_dir=str(tmp_path), profile_chunk=1,
                                          **kw)
    assert traced["profile"]["chunk"] == 1 and traced["profile"]["frames"] == 4 and traced["profile"]["s"] > 0
    assert traced["profile"]["device_ms_per_frame"] > 0  # the traced chunk's own untraced replays
    np.testing.assert_array_equal(traced["positions"], plain["positions"])
    with open(tmp_path / "trace.json") as f:
        names = [e.get("name") for e in json.load(f)["traceEvents"]]
    assert names.count("aten::linalg_qr") == 4  # one QR per frame step, four steps in a chunk
    with pytest.raises(ValueError, match="profile_chunk"):
        torch_run_opt.run_dataset(reader, bench_config(), device="cpu", chunk_size=1, profile_dir=str(tmp_path),
                                  profile_chunk=0)
