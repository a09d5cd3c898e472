"""Pure-simulation entry point, the ``eqvio_sim`` equivalent (counterpart of
``eqvio_tpu/app/run_sim.py``): a synthetic trajectory and world, landmarks
augmented at their true positions (``--selfInit`` initialises them from the
measurements instead), the NEES printout and the consistency CSVs.

Usage:
    python -m eqvio_tpu_torch.app.run_sim [config.yaml] [--output DIR]
        [--device cuda|cpu] [--trajectory wave|square|line|sine|room|mh] [--time T]
        [--capacity N] [--maxFeatures F] [--selfInit] [--fullState]
        [--inputNoise] [--outputNoise] [--initialNoise] [--landmarkReset N]
        [--consistency] [--f32]

PyYAML is imported only when a config path is given.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .. import filter as F
from ..io import VIOWriter, load_config, settings_from_config, sim_params_from_config
from ..runner import ate_rmse, attitude_rmse, run_simulation
from ..runtime import configure_runtime


def main(argv=None):
    ap = argparse.ArgumentParser(description="EqVIO simulation (PyTorch / CUDA port)")
    ap.add_argument("config", nargs="?", default=None)
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="cuda (the default) runs in float32 on the card; cpu in float64")
    ap.add_argument("--trajectory", default=None)
    ap.add_argument("--time", type=float, default=None)
    ap.add_argument("--capacity", type=int, default=None)
    ap.add_argument("--maxFeatures", type=int, default=None)
    ap.add_argument("--selfInit", action="store_true",
                    help="initialise landmarks from measurements, not ground truth")
    ap.add_argument("--fullState", action="store_true",
                    help="all world landmarks are always part of the state")
    ap.add_argument("--inputNoise", action="store_true")
    ap.add_argument("--outputNoise", action="store_true")
    ap.add_argument("--initialNoise", action="store_true")
    ap.add_argument("--landmarkReset", type=int, default=0,
                    help="reset all landmarks to truth every N frames")
    ap.add_argument("--consistency", action="store_true",
                    help="write pose/bias consistency, NEES breakdown and landmark-error CSVs")
    ap.add_argument("--f32", action="store_true")
    args = ap.parse_args(argv)

    _, preferred = configure_runtime(args.device)
    sim_params = {}
    if args.config:
        cfg = load_config(args.config)
        settings = settings_from_config(cfg)
        sim_params = sim_params_from_config(cfg)  # explicit flags override it below
    else:
        settings = F.Settings(measurement_noise=0.5)

    if args.trajectory is not None:
        sim_params["kind"] = args.trajectory
    if args.time is not None:
        sim_params["end_time"] = args.time
    if args.maxFeatures is not None:
        sim_params["max_features"] = args.maxFeatures
    for flag, name in (("inputNoise", "input_noise"), ("outputNoise", "output_noise"),
                       ("initialNoise", "initial_noise")):
        if getattr(args, flag):
            sim_params[name] = True
    sim_params.setdefault("kind", "wave")
    sim_params.setdefault("end_time", 30.0)
    sim_params.setdefault("max_features", 30)
    if args.fullState:
        sim_params.setdefault("num_points", 120)  # the whole world enters the state
    capacity = args.capacity if args.capacity is not None else max(32, sim_params["max_features"])

    res = run_simulation(
        settings,
        capacity=capacity,
        augment_true_landmarks=not args.selfInit,
        landmark_reset_every=args.landmarkReset,
        consistency=args.consistency,
        full_state=args.fullState,
        dtype=torch.float32 if args.f32 else preferred,
        device=args.device,
        **sim_params,
    )

    est = res.est_position.numpy()
    gt = res.true_position.numpy()
    rmse, scale = ate_rmse(est, gt)
    att = attitude_rmse(res.est_attitude.numpy(), res.true_attitude.numpy())
    nees = res.nees.numpy()
    print(f"frames: {len(est)}")
    print(f"position RMSE (SIM3-aligned): {rmse:.4f} m   scale: {scale:.4f}")
    print(f"attitude RMSE: {att:.3f} deg")
    print(f"NEES median: {np.nanmedian(nees):.3f}  mean: {np.nanmean(nees):.3f}")

    if args.output:
        times = res.times.numpy()
        counts = res.num_landmarks.numpy()
        extras = None if res.consistency is None else [a.numpy() for a in res.consistency]
        with VIOWriter(args.output) as writer:
            for k in range(len(times)):
                writer.write_states(times[k], res.est_attitude[k].numpy(), est[k], res.est_velocity[k].numpy(),
                                    np.eye(3), np.zeros(3), np.zeros(6))
                writer.write_true_state(times[k], res.true_attitude[k].numpy(), gt[k],
                                        res.true_velocity[k].numpy(), np.zeros(6))
                dof = 21 + 3 * int(counts[k])
                if extras is None:
                    writer.write_nees(times[k], nees[k], dof)
                    continue
                pose_nees, att_nees, eps, sig_diag, lm_err = extras
                writer.write_nees(times[k], nees[k], dof, pose_nees[k], att_nees[k])
                writer.write_pose_consistency(times[k], eps[k, 6:12], sig_diag[k, 6:12])
                writer.write_bias_consistency(times[k], eps[k, 0:6], sig_diag[k, 0:6])
                writer.write_landmark_error(times[k], lm_err[k], ~np.isnan(lm_err[k]))
        print(f"wrote outputs to {args.output}")


if __name__ == "__main__":
    main()
