"""The port's batched simulation runs and the ``run_sim`` CLI against
``eqvio_tpu`` on the CPU in float64 (the scene of
``tests/test_torch_runner.py``): a batch of two lanes of one sequence, each
lane equal to the JAX batch and to the port's own single run, and a fleet
of two different sequences with input and output noise, within 1e-8 m,
NEES within 1e-7 relative and landmark counts equal; then
``run_sim.main(["--time", "2", "--consistency", ...])`` with ``--device
cpu`` writes the JAX CLI's CSV files with the same headers and values
within 1e-8.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from eqvio_tpu import runner as JR
from eqvio_tpu.app import run_sim as jax_run_sim
from eqvio_tpu.parallel import batch_sim_step as jax_batch_step
from eqvio_tpu.parallel import make_batched_states as jax_batched_states
from eqvio_tpu_torch import convert
from eqvio_tpu_torch import runner as TR
from eqvio_tpu_torch.app import run_sim as torch_run_sim
from eqvio_tpu_torch.parallel import batch_sim_step, make_batched_states
from tests.test_torch_core import assert_tree_close
from tests.test_torch_run_opt import one_torch_thread  # noqa: F401 (autouse fixture)
from tests.test_torch_runner import SCENE, SELF_INIT, assert_runs_match

SIM_CSVS = ("IMUState.csv", "trueState.csv", "nees.csv", "poseConsistency.csv", "biasConsistency.csv",
            "landmarkError.csv", "camera.csv", "bias.csv")


def _lane(res, i):
    return type(res)(res.times, *(a[i] for a in res[1:9]), consistency=None)


def test_batch_lanes_match_jax_and_single_run():
    settings_t = convert.settings_from_jax_settings(SELF_INIT)
    ij = JR.prepare_sim_inputs(SELF_INIT, **SCENE)
    it = TR.prepare_sim_inputs(settings_t, **SCENE)
    rj = JR.build_sim_runner(SELF_INIT, ij, augment_true_landmarks=False, batch=2)()
    rt = TR.build_sim_runner(settings_t, it, augment_true_landmarks=False, batch=2, device="cpu")()
    single = TR.build_sim_runner(settings_t, it, augment_true_landmarks=False, device="cpu")()
    assert rt.est_position.shape == (2, 55, 3) and rt.nees.shape == (2, 55)
    for i in range(2):
        assert_runs_match(_lane(rj, i), _lane(rt, i))
        assert_runs_match(single, _lane(rt, i))


def test_fleet_matches_jax():
    """Two sequences with their own worlds and noise, self-initialised."""
    settings_t = convert.settings_from_jax_settings(SELF_INIT)
    kw = dict(SCENE, input_noise=True, output_noise=True)
    ij = [JR.prepare_sim_inputs(SELF_INIT, seed=s, noise_seed=s + 1, **kw) for s in (0, 1)]
    it = [TR.prepare_sim_inputs(settings_t, seed=s, noise_seed=s + 1, **kw) for s in (0, 1)]
    rj = JR.build_fleet_runner(SELF_INIT, ij)()
    rt = TR.build_fleet_runner(settings_t, it, device="cpu")()
    assert rt.est_position.shape == (2, 55, 3)
    assert torch.isnan(rt.nees).all()
    for i in range(2):
        assert_runs_match(_lane(rj, i), _lane(rt, i))
    assert not np.allclose(rt.est_position[0].numpy(), rt.est_position[1].numpy(), atol=1e-3)


def test_batch_sim_step_matches_jax():
    """``parallel.make_batched_states`` and ``batch_sim_step`` over two lanes
    (different visibility per lane) equal the JAX package's."""
    settings_t = convert.settings_from_jax_settings(SELF_INIT)
    ij = JR.prepare_sim_inputs(SELF_INIT, **SCENE)
    it = TR.prepare_sim_inputs(settings_t, **SCENE)
    sj = jax_batched_states(SELF_INIT, 2, 12, dtype=jnp.float64)
    assert_tree_close(sj, make_batched_states(settings_t, 2, 12, dtype=torch.float64, device="cpu"), 0.0,
                      "batched states")
    sj = sj._replace(xi0=jax.tree.map(lambda a: jnp.stack([a, a]), ij.state0.xi0))
    st = convert.eqf_state_from_numpy(sj, torch.float64, "cpu")
    idx = np.asarray(ij.idx[3])
    imu = [np.stack([np.asarray(a)[idx]] * 2) for a in ij.imu_all]
    dts = np.stack([np.asarray(ij.dts[3])] * 2)
    pix = np.random.default_rng(5).uniform(100, 600, size=(2, 12, 2))
    vis = np.stack([np.arange(12) < 9, np.arange(12) < 7])
    ids = np.stack([np.arange(12)] * 2)
    out_j = jax_batch_step(SELF_INIT, ij.camera)(sj, type(ij.imu_all)(*map(jnp.asarray, imu)), jnp.asarray(dts),
                                                 jnp.asarray(pix), jnp.asarray(vis), jnp.asarray(ids))
    out_t = batch_sim_step(settings_t, it.camera)(st, type(it.imu_all)(*map(torch.as_tensor, imu)),
                                                  torch.as_tensor(dts), torch.as_tensor(pix), torch.as_tensor(vis),
                                                  torch.as_tensor(ids))
    assert_tree_close(out_j, out_t, 1e-9, "batched step")
    assert not np.array_equal(out_t.xi0.mask[0].numpy(), out_t.xi0.mask[1].numpy())


def _csv_rows(path):
    with open(path) as f:
        lines = f.readlines()
    return lines[0], [[float(c) for c in line.split(",") if c.strip()] for line in lines[1:]]


def test_run_sim_cli_matches_jax(tmp_path, capsys):
    args = ["--time", "2", "--consistency", "--capacity", "12", "--maxFeatures", "10"]
    jax_run_sim.main(args + ["--output", str(tmp_path / "jax")])
    out_j = capsys.readouterr().out
    torch_run_sim.main(args + ["--output", str(tmp_path / "torch"), "--device", "cpu"])
    out_t = capsys.readouterr().out
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    assert set(SIM_CSVS) <= set(os.listdir(tmp_path / "torch"))
    for name in os.listdir(tmp_path / "jax"):
        head_j, rows_j = _csv_rows(tmp_path / "jax" / name)
        head_t, rows_t = _csv_rows(tmp_path / "torch" / name)
        assert head_t == head_j and len(rows_t) == len(rows_j) == 35, name
        for a, b in zip(rows_t, rows_j):
            assert len(a) == len(b), name
            np.testing.assert_allclose(a, b, atol=1e-8, rtol=1e-8, err_msg=name)
    # the same printout: frames, RMSE, attitude and NEES lines to their printed digits
    assert out_t.splitlines()[:4] == out_j.splitlines()[:4]
    assert out_t.splitlines()[0] == "frames: 35"
