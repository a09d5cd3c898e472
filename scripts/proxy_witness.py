#!/usr/bin/env python3
"""Frame-by-frame witness for a EuRoC proxy's accuracy: fresh runs of the
V1_01 or MH_03 proxy held against the JAX package's committed CPU float64
run (``results/proxy_cpu_f64/<scene>_proxy/IMUState.csv``).

    python scripts/proxy_witness.py port v101 --out DIR [--frames N] [--device cpu|cuda] [--f32]
    JAX_PLATFORMS=cpu python scripts/proxy_witness.py jax v101 --out DIR --scene-dir DIR [--frames N]
    python scripts/proxy_witness.py compare v101 [DIR/IMUState.csv ...]

``port``: the PyTorch port's fused path on its in-memory scene
(``data.v101_proxy`` / ``mh03_proxy``) with the scene's config, float64
unless ``--f32`` (float32 turns on the square-root covariance); writes
``IMUState.csv`` to ``--out``.  ``jax``: the JAX package's fused path on the
JAX generator's files (``generate_v101_proxy`` / ``generate_mh03_proxy``,
written to ``--scene-dir`` first if absent), float64; writes ``IMUState.csv``
to ``--out``.  ``compare``: the committed run and each given CSV, over the
frames they share: position RMSE after a similarity alignment against the
scene's ground truth, and each CSV's largest position difference to the
committed run per block of frames (positions are written to 6 significant
digits: the floor is 1e-6 m below 1 m and 1e-5 m below 10 m).  One JSON line per CSV, and with
two CSVs a last line that holds them against each other.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# the generators' arguments (eqvio_tpu/data/synthetic.py, eqvio_tpu_torch/data/synthetic.py)
SCENES = {
    "v101": dict(kind="room", seed=11, num_points=900, wall_distance=2.0, end_time=144.0,
                 config="config_v101_proxy.yaml"),
    "mh03": dict(kind="mh", seed=17, num_points=1400, wall_distance=2.5, end_time=132.0,
                 config="config_mh03_proxy.yaml"),
}
BLOCKS = (10, 50, 100, 200, 400, 800, 1600, 3200)  # frame counts at which the running max is reported


def committed_csv(scene: str) -> str:
    return os.path.join(ROOT, "results", "proxy_cpu_f64", f"{scene}_proxy", "IMUState.csv")


def run_port(args) -> None:
    import torch

    from eqvio_tpu_torch.app.run_opt import run_dataset
    from eqvio_tpu_torch.data import mh03_proxy, v101_proxy
    from eqvio_tpu_torch.io import mh03_proxy_config, v101_proxy_config

    make, config = {"v101": (v101_proxy, v101_proxy_config), "mh03": (mh03_proxy, mh03_proxy_config)}[args.scene]
    t0 = time.perf_counter()
    reader = make()
    build_s = time.perf_counter() - t0
    dtype = torch.float32 if args.f32 else torch.float64
    t0 = time.perf_counter()
    _, summary = run_dataset(reader, config(), device=args.device, chunk_size=16, output_dir=args.out,
                             limit_frames=args.frames, dtype=dtype)
    print(json.dumps({"run": "port", "scene": args.scene, "device": args.device, "dtype": str(dtype),
                      "frames": summary["frames"], "healthy": summary["healthy"], "scene_build_s": build_s,
                      "run_s": time.perf_counter() - t0}), flush=True)


def run_jax(args) -> None:
    import jax

    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp

    from eqvio_tpu.app.run_opt import run_dataset
    from eqvio_tpu.data.synthetic import generate_mh03_proxy, generate_v101_proxy
    from eqvio_tpu.io import load_config

    t0 = time.perf_counter()
    if not os.path.exists(os.path.join(args.scene_dir, "proxy_info.yaml")):
        {"v101": generate_v101_proxy, "mh03": generate_mh03_proxy}[args.scene](args.scene_dir)
    build_s = time.perf_counter() - t0
    cfg = load_config(os.path.join(ROOT, "configs", SCENES[args.scene]["config"]))
    t0 = time.perf_counter()
    _, summary = run_dataset(args.scene_dir, cfg, output_dir=args.out, dtype=jnp.float64,
                             limit_frames=args.frames)
    print(json.dumps({"run": "jax", "scene": args.scene, "frames": summary["frames"],
                      "healthy": summary["healthy"], "scene_build_s": build_s,
                      "run_s": time.perf_counter() - t0}), flush=True)


def ground_truth(scene: str, stamps):
    """The scene's true positions at ``stamps`` (the simulator the generators
    build, without rendering)."""
    import numpy as np
    import torch

    from eqvio_tpu_torch.sim import Simulator

    s = SCENES[scene]
    sim = Simulator.create(kind=s["kind"], end_time=s["end_time"] + 1.0, num_points=s["num_points"], num_walls=6,
                           seed=s["seed"], wall_distance=s["wall_distance"])
    gt_times = np.arange(0.2, s["end_time"], 0.01)  # the generators' 100 Hz ground truth
    pose, _ = sim.true_pose_velocity(torch.as_tensor(gt_times, dtype=torch.float64))
    gp = pose.x.numpy()
    return np.stack([np.interp(stamps, gt_times, gp[:, i]) for i in range(3)], -1)


def compare(args) -> None:
    import numpy as np

    from eqvio_tpu_torch.runner import ate_rmse

    def load(path):
        d = np.genfromtxt(path, delimiter=",", skip_header=1)
        return d[:, 0], d[:, 1:4]

    t_ref, p_ref = load(committed_csv(args.scene))
    gt = ground_truth(args.scene, t_ref)
    rmse, scale = ate_rmse(p_ref, gt)
    print(json.dumps({"csv": os.path.relpath(committed_csv(args.scene), ROOT), "frames": len(t_ref),
                      "rmse_m": rmse, "scale": scale}), flush=True)
    for path in args.csvs:
        t, p = load(path)
        n = min(len(t), len(t_ref))
        if not np.allclose(t[:n], t_ref[:n], atol=1e-6):
            sys.exit(f"{path}: its stamps differ from the committed run's")
        d = np.abs(p[:n] - p_ref[:n]).max(1)
        over = np.nonzero(d > 1e-3)[0]
        line = {"csv": path, "frames": n, "rmse_m": ate_rmse(p[:n], gt[:n])[0], "scale": ate_rmse(p[:n], gt[:n])[1],
                "committed_rmse_same_frames_m": ate_rmse(p_ref[:n], gt[:n])[0],
                "max_dpos_m_first": {str(b): float(d[:b].max()) for b in BLOCKS if b <= n} | {str(n): float(d.max())},
                "first_frame_over_1mm": int(over[0]) if len(over) else None}
        print(json.dumps(line), flush=True)
    if len(args.csvs) == 2:  # the two fresh runs against each other
        (ta, pa), (tb, pb) = load(args.csvs[0]), load(args.csvs[1])
        n = min(len(ta), len(tb))
        d = np.abs(pa[:n] - pb[:n]).max(1)
        over = np.nonzero(d > 1e-3)[0]
        print(json.dumps({"pair": args.csvs, "frames": n,
                          "max_dpos_m_first": {str(b): float(d[:b].max()) for b in BLOCKS if b <= n}
                          | {str(n): float(d.max())},
                          "first_frame_over_1mm": int(over[0]) if len(over) else None}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["port", "jax", "compare"])
    ap.add_argument("scene", choices=sorted(SCENES))
    ap.add_argument("csvs", nargs="*", help="compare: IMUState.csv files of fresh runs")
    ap.add_argument("--out", help="port, jax: the output directory")
    ap.add_argument("--frames", type=int, default=None, help="port, jax: run only the first N frames")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"], help="port: the device")
    ap.add_argument("--f32", action="store_true", help="port: float32 (square-root covariance)")
    ap.add_argument("--scene-dir", help="jax: the JAX generator's tree (written if absent)")
    args = ap.parse_args()
    {"port": run_port, "jax": run_jax, "compare": compare}[args.what](args)


if __name__ == "__main__":
    main()
