"""Whole simulation runs of the port against ``eqvio_tpu.runner`` on the CPU
in float64 (3 s of the ``wave`` trajectory, capacity 12, 10 features, 200
points): positions within 1e-8 m, NEES within 1e-7 relative, landmark
counts equal; with landmarks augmented at their true positions and the
consistency outputs, self-initialised, and in full-state mode with landmark
resets.  The frame step runs under the capture guard of
``tests/test_torch_fused.py`` (no host sync, no tensor from host data), and
the entry points default to the card.
"""

import numpy as np
import pytest
import torch

from eqvio_tpu import filter as JF
from eqvio_tpu import runner as JR
from eqvio_tpu_torch import convert
from eqvio_tpu_torch import runner as TR
from tests.test_torch_fused import no_host_sync_or_host_data
from tests.test_torch_run_opt import one_torch_thread  # noqa: F401 (autouse fixture)

SCENE = dict(capacity=12, max_features=10, end_time=3.0, num_points=200)
POS_TOL_M = 1e-8
NEES_RTOL = 1e-7
NEES_ATOL = 1e-12  # where a NEES is round-off (the first frame's pose NEES is ~1e-31)

# the bench's sim settings: InvDepth, fast Riccati, continuous innovation lift, fixed depth
SELF_INIT = JF.Settings(measurement_noise=0.5, coordinate_choice="invdepth", fast_riccati=True,
                        use_discrete_innovation_lift=False, use_median_depth=False, initial_scene_depth=2.5)
CASES = {
    "augmented-consistency": (JF.Settings(measurement_noise=0.5), dict(consistency=True), {}),
    "self-init": (SELF_INIT, dict(augment_true_landmarks=False), {}),
    "full-state-reset": (JF.Settings(measurement_noise=0.5), dict(full_state=True, landmark_reset_every=5),
                         dict(num_points=60)),
}


def assert_runs_match(rj, rt, consistency=False):
    """Positions, attitudes, velocities and truth within POS_TOL_M, NEES
    within NEES_RTOL (NaN where JAX has NaN; NEES_ATOL where it is
    round-off), landmark counts equal."""
    np.testing.assert_array_equal(rt.times.numpy(), np.asarray(rj.times))
    for name in ("est_position", "est_attitude", "est_velocity", "true_position", "true_attitude",
                 "true_velocity"):
        np.testing.assert_allclose(getattr(rt, name).numpy(), np.asarray(getattr(rj, name)), atol=POS_TOL_M,
                                   rtol=0, err_msg=name)
    np.testing.assert_allclose(rt.nees.numpy(), np.asarray(rj.nees), rtol=NEES_RTOL, atol=NEES_ATOL)
    np.testing.assert_array_equal(rt.num_landmarks.numpy(), np.asarray(rj.num_landmarks))
    assert (rj.consistency is None) == (rt.consistency is None) == (not consistency)
    if consistency:
        pose_t, att_t, eps_t, sig_t, lm_t = (a.numpy() for a in rt.consistency)
        pose_j, att_j, eps_j, sig_j, lm_j = (np.asarray(a) for a in rj.consistency)
        np.testing.assert_allclose(pose_t, pose_j, rtol=NEES_RTOL, atol=NEES_ATOL)
        np.testing.assert_allclose(att_t, att_j, rtol=NEES_RTOL, atol=NEES_ATOL)
        np.testing.assert_allclose(eps_t, eps_j, atol=POS_TOL_M, rtol=0)
        np.testing.assert_allclose(sig_t, sig_j, atol=POS_TOL_M, rtol=0)
        np.testing.assert_array_equal(np.isnan(lm_t), np.isnan(lm_j))  # NaN on inactive slots
        np.testing.assert_allclose(lm_t, lm_j, atol=POS_TOL_M, rtol=0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_run_simulation_matches_jax(case):
    settings_j, opts, scene = CASES[case]
    kw = {**SCENE, **scene}
    rj = JR.run_simulation(settings_j, **opts, **kw)
    rt = TR.run_simulation(convert.settings_from_jax_settings(settings_j), device="cpu", **opts, **kw)
    assert_runs_match(rj, rt, consistency=opts.get("consistency", False))
    assert rt.est_position.shape == (55, 3) and int(rt.num_landmarks.min()) >= 8
    est, gt = rt.est_position.numpy(), rt.true_position.numpy()
    assert TR.ate_rmse(est, gt)[0] == pytest.approx(JR.ate_rmse(np.asarray(rj.est_position), gt)[0], rel=1e-6)


@pytest.mark.parametrize("mode", ["single", "batch", "fleet"])
def test_sim_step_has_no_host_sync(mode):
    """After the first frame (which builds the cached constants), frames run
    under the capture guard, and the runner's frame counter reads each
    frame's inputs: the guarded frames equal an unguarded run's."""
    settings = convert.settings_from_jax_settings(SELF_INIT if mode != "single" else JF.Settings(
        measurement_noise=0.5))
    kw = dict(SCENE, end_time=1.0, num_points=100, output_noise=True, input_noise=True)
    inputs = [TR.prepare_sim_inputs(settings, seed=s, noise_seed=s + 1, **kw) for s in (0, 1)]
    if mode == "fleet":
        runner = TR.build_fleet_runner(settings, inputs, device="cpu")
    else:
        opts = dict(consistency=True) if mode == "single" else dict(augment_true_landmarks=False, batch=3)
        runner = TR.build_sim_runner(settings, inputs[0], device="cpu", **opts)
    want = runner()
    runner.reset()
    runner.replay(1)
    with no_host_sync_or_host_data():
        runner.replay(runner.frames - 1)
    got = runner.result()
    for a, b in zip(got[:9], want[:9]):
        torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    assert int(runner.step.carry[-1]) == runner.frames


def test_entry_points_default_to_the_card(tmp_path):
    """``run_simulation``, ``build_sim_runner``, ``build_fleet_runner`` and the
    ``run_sim`` CLI run on CUDA unless asked for the CPU: without a card
    they raise rather than fall back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default would run there")
    from eqvio_tpu_torch.app import run_sim

    settings = convert.settings_from_jax_settings(JF.Settings(measurement_noise=0.5))
    inputs = TR.prepare_sim_inputs(settings, capacity=4, max_features=4, end_time=0.5, num_points=40)
    for call in (lambda: TR.run_simulation(settings, capacity=4, max_features=4, end_time=0.5, num_points=40),
                 lambda: TR.build_sim_runner(settings, inputs),
                 lambda: TR.build_fleet_runner(settings, [inputs]),
                 lambda: run_sim.main(["--time", "0.5", "--output", str(tmp_path)])):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
