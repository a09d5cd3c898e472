"""The port's benchmark programs (``eqvio_tpu_torch.bench`` and
``eqvio_tpu_torch.bench_kernels``) against the repository's ``bench.py`` and
``bench_kernels.py``, on the CPU at small sizes.

The two benches' dataset trees are written at 752x480 over 2.4 s (43
frames, enough for the KLT gate's frames 40 and 41) and must agree as the
generators' tests hold them (``tests/test_torch_readers.py``): equal text
and frames, the simulated rows within 1e-9.  The gate's plain half on that
tree must track as ``eqvio_tpu``'s gather path does, within 2e-4 px and
with equal masks.  Each bench's ``main`` runs through at small sizes and
prints its line in the original's schema, and a failing part gives the line
with its error and a non-zero exit.
"""

import inspect
import json
import math
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import bench as jbench
import bench_kernels as jbench_kernels
import eqvio_tpu_torch.bench as tbench
import eqvio_tpu_torch.bench_kernels as tbench_kernels
from eqvio_tpu.frontend.detector import detect_features as jdetect
from eqvio_tpu.frontend.klt import track_features as jtrack
from eqvio_tpu.frontend.pyramid import build_pyramid as jpyramid
from eqvio_tpu_torch.kernels import klt as K
from tests.test_torch_readers import _assert_asl_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TREE_SECONDS = 2.4  # 43 frames: the gate reads frames 40 and 41
RUN_SECONDS = 0.8  # 11 frames: the tree main() runs over in full, four times
FRAMES = "mav0/cam0/data"
# the small sizes of main(): reps 3, the batch B = 2 over 8 frames in chunks
# of 4, the simulation 2 s at B = 2
SMALL_ENV = {"BENCH_REPS": "3", "BENCH_CHUNK": "4", "BENCH_FF_BATCH": "2", "BENCH_FF_FRAMES": "8",
             "BENCH_FF_CHUNK": "4", "BENCH_BATCH": "2"}
# bench.py's secondary keys that only its TPU run has: the Pallas gate and the
# prior rounds' anchor (every BENCH_r*.json was measured on a TPU)
TPU_ONLY = {"pallas_klt_max_px_diff", "prior_round_best_fps", "perf_vs_prior_ok"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread per test worker: the workers share the machine's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The JAX bench's and the port's trees, each bench's ``_ensure_dataset``
    pointed at its own directory with the scene cut to TREE_SECONDS."""
    root = tmp_path_factory.mktemp("bench")
    with pytest.MonkeyPatch.context() as mp:
        for mod, name in ((jbench, "j"), (tbench, "t")):
            mp.setattr(mod, "BENCH_DATASET", str(root / name))
            mp.setattr(mod, "BENCH_SECONDS", TREE_SECONDS)
            mod._ensure_dataset()
    return root / "j", root / "t"


def _files(base):
    return sorted(os.path.relpath(os.path.join(d, f), base) for d, _, fs in os.walk(base) for f in fs)


def test_bench_trees_match(trees):
    """(a) The same files, equal text, equal decoded frames, and the
    simulated IMU and ground-truth rows within the generators' 1e-9."""
    j, t = trees
    assert _files(j) == _files(t)
    frames = sorted(os.listdir(j / FRAMES))
    assert len(frames) >= max(tbench.KLT_FRAMES) + 1
    with Image.open(j / FRAMES / frames[0]) as im:
        assert im.size == (752, 480)
    _assert_asl_tree(j, t)
    for f in frames:
        np.testing.assert_array_equal(np.asarray(Image.open(t / FRAMES / f)), np.asarray(Image.open(j / FRAMES / f)),
                                      f)


def test_klt_gate_plain_half_matches_jax_gather(trees, monkeypatch):
    """(b) The gate's plain half on frames 40 and 41 of the port's tree
    against ``eqvio_tpu``'s gather path after its own detector and
    pyramids, called as ``bench.py``'s gate calls them."""
    j, t = trees
    monkeypatch.setattr(tbench, "BENCH_DATASET", str(t))
    case = tbench._klt_gate_case("cpu")
    pos_t, ok_t = tbench._klt_gate_track(K.klt_track_pyramid_plain, *case)

    f0, f1 = (jnp.asarray(np.asarray(Image.open(j / FRAMES / sorted(os.listdir(j / FRAMES))[i]),
                                     dtype=np.float32) / 255.0) for i in tbench.KLT_FRAMES)
    pyr0, pyr1 = jpyramid(f0, 4), jpyramid(f1, 4)
    pts, mask = jdetect(f0, 30, min_dist=20)
    track = jax.jit(lambda p0, p1, pt: jtrack([*p0], [*p1], pt, mask, win=21, iters=8, mode="gather"))
    pos_j, ok_j = (np.asarray(a) for a in track(tuple(pyr0), tuple(pyr1), pts))

    np.testing.assert_allclose(case[2].numpy(), np.asarray(pts), atol=1e-4)
    np.testing.assert_array_equal(case[3].numpy(), np.asarray(mask))
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    assert ok_j.sum() >= 20
    assert np.abs(pos_t.numpy() - pos_j)[ok_j].max() <= tbench.KLT_TOL_PX


def _r05_secondary() -> dict:
    with open(os.path.join(REPO, "BENCH_r05.json")) as f:
        rec = json.load(f)
    for line in rec["tail"].splitlines():
        if line.strip().startswith("{") and '"value"' in line:
            return json.loads(line)["secondary"]
    raise AssertionError("BENCH_r05.json holds no bench line")


def _last_line(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _finite(x) -> bool:
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


def test_bench_main_on_cpu(tmp_path, monkeypatch, capsys):
    """(c) ``main(device="cpu")`` at small sizes exits 0; its last line has
    bench.py's top-level keys and the secondary keys of ``BENCH_r05.json``
    but the TPU-only ones, every number finite."""
    for k, v in SMALL_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tbench, "BENCH_DATASET", str(tmp_path / "tree"))
    monkeypatch.setattr(tbench, "BENCH_SECONDS", RUN_SECONDS)
    monkeypatch.setattr(tbench, "SIM_SECONDS", 2.0)
    assert tbench.main(device="cpu") == 0
    out = _last_line(capsys)
    assert list(out) == ["metric", "value", "unit", "vs_baseline", "baseline_assumed", "value_spread", "healthy",
                         "secondary"]
    sec = out["secondary"]
    assert set(_r05_secondary()) - TPU_ONLY <= set(sec), set(_r05_secondary()) - TPU_ONLY - set(sec)
    assert not TPU_ONLY & set(sec)
    assert out["metric"] == "full_frame_fps_single_seq" and out["healthy"] is True and out["value"] > 0
    assert out["value_spread"]["reps"] == 3 and sec["fps_reps"] == sorted(sec["fps_reps"])
    assert sec["device_kind"] == "cpu" and sec["fused_mfu_pct"] is None and sec["batch_mfu_pct"] is None
    assert sec["full_frame_batch_B"] == 2 and sec["full_frame_batch_frames"] == 8
    assert sec["capture_s"] is None and sec["decoder"] in ("native", "pil")
    assert _finite(out)


def _stub_full_frame(dtype, device):
    return 10.0, True, {"fps_reps": [9.0, 10.0, 11.0], "device_kind": "cpu"}


@pytest.mark.parametrize("case", ["bench_part_raises", "bench_nan_run", "bench_kernels_part_raises"])
def test_failed_part_exits_nonzero(case, monkeypatch, capsys):
    """(d) A part that raises is recorded in the line under its error key,
    a NaN run makes the line unhealthy, and either exits non-zero."""
    import eqvio_tpu_torch.app.run_opt as run_opt
    import eqvio_tpu_torch.runner as runner

    def boom(*args, **kwargs):
        raise RuntimeError("injected")

    monkeypatch.setenv("BENCH_FF_BATCH", "1")
    monkeypatch.setenv("BENCH_BATCH", "1")
    monkeypatch.setattr(tbench, "SIM_SECONDS", 1.0)
    if case == "bench_part_raises":
        monkeypatch.setattr(tbench, "bench_full_frame", _stub_full_frame)
        monkeypatch.setattr(runner, "prepare_sim_inputs", boom)
        assert tbench.main(device="cpu") == 1
        out = _last_line(capsys)
        assert out["secondary"]["error"] == "RuntimeError: injected" and out["value"] == 10.0
    elif case == "bench_nan_run":
        nan = float("nan")
        summary = {"frames": 12, "healthy": False, "nan": True, "device_ms_per_frame": nan,
                   "achieved_gflops": nan, "flops_per_frame": nan, "hbm_bytes_per_frame": nan,
                   "achieved_hbm_gbps": nan}
        monkeypatch.setattr(tbench, "_ensure_dataset", lambda: None)
        monkeypatch.setattr(run_opt, "run_dataset", lambda *a, **k: (None, summary))
        assert tbench.main(device="cpu") == 1
        out = _last_line(capsys)
        assert out["healthy"] is False and "filter_only_fps" in out["secondary"]
        assert not any(k.endswith("error") for k in out["secondary"])
    else:
        orig = tbench_kernels._time
        monkeypatch.setattr(tbench_kernels, "_time", lambda f, *a, reps=50: orig(f, *a, reps=1))
        monkeypatch.setattr(tbench_kernels, "SCALING_BATCHES", (1,))
        monkeypatch.setattr(runner, "prepare_sim_inputs", boom)
        assert tbench_kernels.main(device="cpu") == 1
        out = _last_line(capsys)
        assert out["batch_scaling_error"] == "RuntimeError: injected" and "klt_kernel_ms" in out


@pytest.mark.parametrize("module", ["eqvio_tpu_torch.bench", "eqvio_tpu_torch.bench_kernels"])
def test_bench_defaults_to_the_card(module):
    """Run as a program with no arguments on a machine without a card,
    each bench raises before it prints a line: nothing falls back to the
    CPU."""
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-m", module], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == "", res.stdout
    assert "torch.cuda.is_available() is False" in res.stderr


CARDS = [
    ("NVIDIA H100 80GB HBM3", "NVIDIA H100 80GB HBM3, 700.00 W", (66.9, 3352.0)),
    ("NVIDIA H100 PCIe", "NVIDIA H100 PCIe, 350.00 W", (51.2, 2039.0)),
    ("NVIDIA A100-SXM4-80GB", "NVIDIA A100-SXM4-80GB, 400.00 W", None),
]


@pytest.mark.parametrize("name,line,peaks", CARDS)
def test_chip_peaks(name, line, peaks, monkeypatch):
    """(e) Both H100 parts map to their published float32 and memory peaks,
    an unknown card to None; the kind is nvidia-smi's name and power limit."""
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda index=None: name)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(tbench, "_card_line", lambda index: line)
    assert tbench._chip_peaks("cuda") == (line, peaks)
    mfu, hbm, kind = tbench._utilization(1e12, 1e11, "cuda")
    assert kind == line
    if peaks is None:
        assert mfu is None and hbm is None
    else:
        assert mfu == pytest.approx(100 / peaks[0], abs=1e-4) and hbm == pytest.approx(1e4 / peaks[1], abs=1e-4)
    assert tbench._chip_peaks("cpu") == ("cpu", None)


def test_prior_round_best_ignores_other_cards():
    """(e) Every committed BENCH_r*.json was measured on a TPU: no record
    counts for a card.  The TPU's own kind finds a round, and one below
    bench.py's best, which counts the rounds that name no device too."""
    assert tbench._prior_round_best("NVIDIA H100 80GB HBM3, 700.00 W") is None
    assert tbench._prior_round_best("cpu") is None
    tpu = tbench._prior_round_best(_r05_secondary()["device_kind"])
    assert tpu is not None and 0 < tpu < jbench._prior_round_best()


def test_bench_kernels_main_on_cpu(monkeypatch, capsys):
    """(f) ``bench_kernels.main(device="cpu")`` at small reps emits every key
    of ``bench_kernels.py`` (its TPU KLT routes as the kernel's and the plain
    version's), every number finite, and exits 0."""
    orig = tbench_kernels._time
    monkeypatch.setattr(tbench_kernels, "_time", lambda f, *a, reps=50: orig(f, *a, reps=2))
    monkeypatch.setattr(tbench_kernels, "SCALING_BATCHES", (1, 2))
    monkeypatch.setattr(tbench_kernels, "SCALING_SECONDS", 1.0)
    assert tbench_kernels.main(device="cpu") == 0
    out = _last_line(capsys)
    # bench_kernels.py's result keys, read from its source
    source = inspect.getsource(jbench_kernels.main)
    theirs = set(re.findall(r'results\["(\w+)"\]', source)) | set(re.findall(r'^\s+"(\w+)": round', source, re.M))
    errors = {k for k in theirs if k.endswith("_error")}
    keys = (theirs - errors - {"klt_mxu_ms", "klt_pallas_ms"}) | {"klt_plain_ms", "klt_kernel_ms", "klt_bound_ms"}
    assert len(keys) == 13, keys
    assert keys <= set(out) and not any(k.endswith("error") for k in out)
    assert _finite(out) and all(out[k] > 0 for k in keys - {"batch_scaling_fps"})
    assert list(out["batch_scaling_fps"]) == ["1", "2"] and out["klt_bound_by"] == "operations"
    assert out["device_kind"] == "cpu"
