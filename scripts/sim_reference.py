#!/usr/bin/env python3
"""The JAX package's CPU result for the simulation cells that
``chip_smoke.py`` phase 9 runs on the GPU port.

    JAX_PLATFORMS=cpu python scripts/sim_reference.py [--f64]

Runs ``eqvio_tpu.runner`` (one sequence; the lanes of a batch of one
sequence are identical) on the CPU with the batch cell's settings: the
``wave`` trajectory for 30 s, 200 Hz IMU, 20 Hz frames, capacity 32, 30
features, 1,000 points on 4 walls; InvDepth, fast Riccati, continuous
innovation lift, fixed depth 2.5 m, self-initialised landmarks, dense
covariance as the settings give it, in float32 (``--f64``: float64).  Prints
one JSON line: frames, the position RMSE after a similarity alignment
(``ate_m``), the scale and the attitude RMSE in degrees.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f64", action="store_true")
    args = ap.parse_args()
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from eqvio_tpu import filter as F
    from eqvio_tpu.runner import ate_rmse, attitude_rmse, build_sim_runner, prepare_sim_inputs

    dtype = jnp.float64 if args.f64 else jnp.float32
    settings = F.Settings(measurement_noise=0.5, coordinate_choice="invdepth", fast_riccati=True,
                          use_discrete_innovation_lift=False, use_median_depth=False, initial_scene_depth=2.5)
    inputs = prepare_sim_inputs(settings, capacity=32, max_features=30, end_time=30.0, imu_freq=200.0,
                                frame_freq=20.0, num_walls=4, dtype=dtype)
    res = build_sim_runner(settings, inputs, augment_true_landmarks=False, compute_nees=False)()
    est, gt = np.asarray(res.est_position, np.float64), np.asarray(res.true_position, np.float64)
    ate, scale = ate_rmse(est, gt)
    att = attitude_rmse(np.asarray(res.est_attitude, np.float64), np.asarray(res.true_attitude, np.float64))
    print(json.dumps({"cell": "sim batch (b), one lane", "dtype": str(np.dtype(dtype)), "platform": "cpu",
                      "frames": int(est.shape[0]), "finite": bool(np.isfinite(est).all()), "ate_m": ate,
                      "scale": scale, "attitude_rmse_deg": att}))


if __name__ == "__main__":
    main()
