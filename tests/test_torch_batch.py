"""The port's batch driver (``app.batch``) and analysis against
``eqvio_tpu``'s on the same two trees (ASL and UZH-FPV, written by the JAX
generators, small), in float64 on the CPU: per-sequence RMSE and scale
within 1e-6, the roll-up, and the analysis functions on the same CSVs.
The card-environment test runs the port's batch CLI in a subprocess where
matplotlib cannot be imported and the native PNG loader does not build,
as on the GPU machine.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from eqvio_tpu import analysis as janalysis
from eqvio_tpu.app import batch as jbatch
from eqvio_tpu.data import generate_asl_dataset, generate_uzhfpv_dataset
from eqvio_tpu_torch import analysis as tanalysis
from eqvio_tpu_torch.app import batch as tbatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batch_list(tmp_path_factory):
    """An ASL and a UZH-FPV tree, their configs cut to 12 features, and the
    dataset list naming them."""
    root = tmp_path_factory.mktemp("batch")
    asl, uzh = str(root / "asl"), str(root / "uzh")
    generate_asl_dataset(asl, end_time=2.0, width=160, height=120, frame_freq=10.0, num_points=150)
    generate_uzhfpv_dataset(uzh, end_time=2.0, width=160, height=120, num_points=150)
    configs = {}
    for name, src in (("asl", "config_EuRoC.yaml"), ("uzh", "config_racing_proxy.yaml")):
        with open(os.path.join(REPO, "configs", src)) as f:
            cfg = yaml.safe_load(f)
        cfg["GIFT"]["maxFeatures"] = 12
        cfg["GIFT"]["winSize"] = 11
        configs[name] = str(root / f"{name}.yaml")
        with open(configs[name], "w") as f:
            yaml.safe_dump(cfg, f)
    listing = str(root / "datasets.yaml")
    with open(listing, "w") as f:
        yaml.safe_dump({"datasets": [
            {"name": "asl_seq", "location": asl, "mode": "asl"},
            {"name": "uzh_seq", "location": uzh, "mode": "uzhfpv", "config": configs["uzh"],
             "groundtruth": os.path.join(uzh, "groundtruth.txt"), "gt_format": "uzhfpv"}]}, f)
    return listing, configs["asl"], root


@pytest.fixture(scope="module")
def both_runs(batch_list):
    listing, config, root = batch_list
    runs = {}
    sum_t = tbatch.run_batch(listing, config, str(root / "torch"), device="cpu", plots=False, timing=False,
                             runs=runs)
    sum_j = jbatch.run_batch(listing, config, str(root / "jax"), plots=False, timing=False)
    return sum_t, sum_j, runs, root


def test_batch_matches_jax(both_runs):
    sum_t, sum_j, runs, root = both_runs
    assert sum_t["completed"] == sum_j["completed"] == 2
    for name in ("asl_seq", "uzh_seq"):
        res_t, res_j = sum_t[name], sum_j[name]
        assert abs(res_t["position (m)"]["rmse"] - res_j["position (m)"]["rmse"]) <= TOL, name
        assert abs(res_t["scale"] - res_j["scale"]) <= TOL, name
        assert res_t["flags"] == res_j["flags"] == {"nan": False, "early_finish": False}
        assert runs[name]["frames"] == 17 and runs[name]["healthy"]
    assert abs(sum_t["mean position rmse"] - sum_j["mean position rmse"]) <= TOL
    with open(root / "torch" / "summary.yaml") as f:
        assert yaml.safe_load(f) == sum_t
    with open(root / "torch" / "asl_seq" / "results.yaml") as f:
        assert yaml.safe_load(f) == sum_t["asl_seq"]


def test_analysis_matches_jax(both_runs):
    """The analysis functions of both packages on the port's CSVs."""
    _, _, _, root = both_runs
    out = str(root / "torch" / "asl_seq")
    gt = os.path.join(str(root / "asl"), "mav0", "state_groundtruth_estimate0", "data.csv")
    est_t, est_j = tanalysis.load_imu_state_csv(out + "/IMUState.csv"), janalysis.load_imu_state_csv(
        out + "/IMUState.csv")
    for k in est_j:
        np.testing.assert_array_equal(est_t[k], est_j[k])
    for fmt, path in (("asl", gt), ("uzhfpv", str(root / "uzh" / "groundtruth.txt"))):
        for a, b in zip(tanalysis.load_groundtruth(path, fmt), janalysis.load_groundtruth(path, fmt)):
            np.testing.assert_array_equal(a, b)
    gt_t, gt_pos, gt_quat, gt_vel = janalysis.load_groundtruth(gt)
    args = (est_j["t"], est_j["position"], est_j["quaternion"], gt_t, gt_pos, gt_quat)
    res_t = tanalysis.analyse_trajectory(*args, est_vel=est_j["velocity"], gt_vel=gt_vel)
    res_j = janalysis.analyse_trajectory(*args, est_vel=est_j["velocity"], gt_vel=gt_vel)
    assert res_t.keys() == res_j.keys() and res_t["flags"] == res_j["flags"]
    for key in ("position (m)", "attitude (d)", "velocity (m/s)"):
        for stat in res_j[key]:
            assert abs(res_t[key][stat] - res_j[key][stat]) <= 1e-12, (key, stat)
    timing = str(root / "timing.csv")
    with open(timing, "w") as f:
        f.write("time, features, total\n" + "".join(f"{k}, {1e-3 * k}, {2e-3 * k}\n" for k in range(12)))
    assert tanalysis.analyse_timing(timing, 4) == janalysis.analyse_timing(timing, 4)
    np.testing.assert_array_equal(tanalysis.quat_to_rot(np.array([0.5, 0.5, -0.5, 0.5])),
                                  janalysis.quat_to_rot(np.array([0.5, 0.5, -0.5, 0.5])))


def test_batch_merges_results_on_disk(both_runs, tmp_path):
    """A rerun of one entry into the same output keeps the other's results."""
    _, _, _, root = both_runs
    with open(root / "datasets.yaml") as f:
        entries = yaml.safe_load(f)["datasets"]
    one = str(tmp_path / "one.yaml")
    with open(one, "w") as f:
        yaml.safe_dump({"datasets": entries[:1]}, f)
    out = str(tmp_path / "out")
    os.makedirs(os.path.join(out, "uzh_seq"))
    with open(root / "torch" / "uzh_seq" / "results.yaml") as f, \
            open(os.path.join(out, "uzh_seq", "results.yaml"), "w") as g:
        g.write(f.read())
    summary = tbatch.run_batch(one, str(root / "asl.yaml"), out, device="cpu", plots=False, timing=False)
    assert summary["completed"] == 2 and {"asl_seq", "uzh_seq"} <= set(summary)


_CARD_ENV = """
import sys
import torch
torch.set_num_threads(1)  # the test workers share the machine's cores
sys.modules["matplotlib"] = None  # the GPU machine has no matplotlib
from eqvio_tpu_torch.io import native
native._libs["imageloader"] = None  # nor libpng's header: the native PNG loader does not build there
from eqvio_tpu_torch.app import batch
import yaml
runs = {}
summary = batch.run_batch(sys.argv[1], sys.argv[2], sys.argv[3], device="cpu", plots=False, timing=False,
                          runs=runs)
assert summary["completed"] == 2, summary
assert {r["decoder"] for r in runs.values()} == {"pil"}, runs
assert "matplotlib" not in [m.split(".")[0] for m in sys.modules if sys.modules[m] is not None]
try:
    batch.make_report(sys.argv[3] + "/asl_seq")
except ImportError as e:
    print("figures need matplotlib:", e)
else:
    raise AssertionError("make_report ran without matplotlib")
print("ok", summary["mean position rmse"])
"""


def test_card_environment_runs_batch_from_files(batch_list, tmp_path):
    """The port imported and ``app.batch`` run from files with matplotlib
    missing and the native loader unbuilt: PIL decodes, the roll-up holds
    both sequences, and asking for the figures raises."""
    listing, config, _ = batch_list
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    res = subprocess.run([sys.executable, "-c", _CARD_ENV, listing, config, str(tmp_path / "out")], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "figures need matplotlib" in res.stdout and "ok" in res.stdout
    with open(tmp_path / "out" / "summary.yaml") as f:
        assert yaml.safe_load(f)["completed"] == 2


def test_batch_cli_defaults_to_the_card(monkeypatch):
    seen = {}
    monkeypatch.setattr(tbatch, "run_batch", lambda *a, **kw: seen.update(kw, args=a))
    tbatch.main(["d.yaml", "c.yaml", "--noPlots", "--checkpointEvery", "64"])
    assert seen["device"] == "cuda" and seen["plots"] is False and seen["checkpoint_every"] == 64
    tbatch.main(["d.yaml", "c.yaml", "--device", "cpu", "--noTiming"])
    assert seen["device"] == "cpu" and seen["timing"] is False and seen["plots"] is True
