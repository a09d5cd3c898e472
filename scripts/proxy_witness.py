#!/usr/bin/env python3
"""Frame-by-frame witness for a EuRoC proxy's accuracy: fresh runs of the
V1_01 or MH_03 proxy held against the JAX package's committed CPU float64
run (``results/proxy_cpu_f64/<scene>_proxy/IMUState.csv``).

    python scripts/proxy_witness.py port v101 --out DIR [--frames N] [--device cpu|cuda] [--f32]
    JAX_PLATFORMS=cpu python scripts/proxy_witness.py jax v101 --out DIR --scene-dir DIR [--frames N]
    python scripts/proxy_witness.py compare v101 [DIR/IMUState.csv ...]
    python scripts/proxy_witness.py ids v101 DIR_A DIR_B [--frames N]
    JAX_PLATFORMS=cpu python scripts/proxy_witness.py tracker v101 --scene-dir DIR [--frames N]

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

``ids``: two runs' output directories (``committed`` names the committed
run) frame by frame: the first frame whose tracked id sets
(``features.csv``) differ and the ids each run alone tracks there, the
largest position gap (``IMUState.csv``) and tracked-pixel gap before that
frame, the first frame whose tracked pixels differ by more than 2e-3 px,
and the first frames whose positions differ by more than 1e-5 m (above the
CSVs' digits) and 1 mm.  ``tracker``: the two packages'
trackers alone (the proxies' configs run without feature predictions, so
the tracker does not see the filter) on the JAX generator's files, float32,
frame by frame; at the first frame whose ids or tracked masks differ it
holds each slot that differs to the gates that decide it: the KLT's mean
residual against ``maxError`` and the image margin, the RANSAC gate and the
refill from the detector, from each package's own previous state; for the
RANSAC gate also the port's gate on the JAX package's inputs and in
float64, which tell a decision that rounding flips from one that differs
in exact arithmetic.  One JSON line.
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
                           seed=s["seed"], wall_distance=s["wall_distance"], device="cpu")
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


def run_dir(scene: str, spec: str) -> str:
    return os.path.dirname(committed_csv(scene)) if spec == "committed" else spec


def load_features(path: str) -> list[dict]:
    """``features.csv`` as one ``{id: (x, y)}`` per frame."""
    frames = []
    with open(path) as f:
        next(f)
        for line in f:
            vals = [v.strip() for v in line.split(",")[1:] if v.strip()]
            frames.append({int(float(vals[j])): (float(vals[j + 1]), float(vals[j + 2]))
                           for j in range(0, len(vals), 3)})
    return frames


def compare_ids(args) -> None:
    import numpy as np

    a, b = (run_dir(args.scene, d) for d in args.csvs)
    fa, fb = load_features(os.path.join(a, "features.csv")), load_features(os.path.join(b, "features.csv"))
    pa, pb = (np.genfromtxt(os.path.join(d, "IMUState.csv"), delimiter=",", skip_header=1)[:, 1:4] for d in (a, b))
    n = min(len(fa), len(fb), len(pa), len(pb), args.frames or 10**9)
    first = next((k for k in range(n) if set(fa[k]) != set(fb[k])), None)
    end = n if first is None else first
    dpos = np.abs(pa[:n] - pb[:n]).max(1)
    dpx = [max((abs(fa[k][i][0] - fb[k][i][0]) + abs(fa[k][i][1] - fb[k][i][1]) for i in fa[k]), default=0.0)
           for k in range(end)]
    over = lambda tol: next((int(k) for k in np.nonzero(dpos > tol)[0]), None)  # noqa: E731
    # pixels are written to 6 digits: 1e-3 px at 100-999 px
    px_first = next((k for k, d in enumerate(dpx) if d > 2e-3), None)
    line = {"pair": args.csvs, "scene": args.scene, "frames": n, "first_frame_ids_differ": first,
            "max_dpos_m_before": float(dpos[:end].max()) if end else 0.0,
            "max_dpx_before": max(dpx, default=0.0), "first_frame_dpx_over_2e-3": px_first,
            "first_frame_dpos_over_1e-5_m": over(1e-5), "first_frame_dpos_over_1mm": over(1e-3)}
    if first is not None:
        line.update(only_a=sorted(set(fa[first]) - set(fb[first])), only_b=sorted(set(fb[first]) - set(fa[first])),
                    tracked_a=len(fa[first]), tracked_b=len(fb[first]),
                    dpos_m_at=float(dpos[first]))
    print(json.dumps(line), flush=True)


def ransac_detail(mod, uniform, prev, curr, mask, key, threshold, hypotheses, xp) -> dict:
    """The epipolar gate's inner numbers in one package (``mod``: its
    ransac module, ``xp``: torch or jax.numpy), in the gate's own order:
    every hypothesis's truncated cost, the best one, its inliers, and per
    slot the squared Sampson
    distance over the threshold under the best hypothesis and under the
    refit (a ratio below 1 keeps the track)."""
    import numpy as np

    p1n, s1 = mod._normalize(prev, mask)
    p2n, s2 = mod._normalize(curr, mask)
    scores = xp.where(mask[None, :], uniform(key, (hypotheses, prev.shape[0])), float("inf"))
    idx = np.argsort(np.asarray(scores), axis=1, kind="stable")[:, :8]
    F = mod._eight_point(p1n[idx], p2n[idx])
    d2 = mod._sampson(F, p1n, p2n)
    thr2 = threshold**2 * s1 * s2
    rho = xp.where(mask[None, :], xp.minimum(d2, thr2), xp.zeros_like(d2))
    best = int(np.argmax(-np.asarray(rho.sum(-1))))
    w = ((d2[best] < thr2) & mask) * xp.ones_like(p1n[:, 0])
    A = mod._constraint_rows(p1n, p2n)
    G2 = xp.einsum("ni,nj->ij", A * w[:, None], A)
    F_lo = mod._rank2(mod.smallest_eigvec(G2[None]).reshape(1, 3, 3))
    d2_lo = mod._sampson(F_lo, p1n, p2n)[0]
    thr = float(np.asarray(thr2))
    return {"best": best, "inliers_best": int(np.asarray(w).sum()), "cost": np.asarray(rho.sum(-1)).tolist(),
            "best_ratio": (np.asarray(d2[best]) / thr).tolist(), "refined_ratio": (np.asarray(d2_lo) / thr).tolist()}


def compare_trackers(args) -> None:
    """Both packages' trackers alone, frame by frame (see the docstring)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from eqvio_tpu.frontend import klt as jklt
    from eqvio_tpu.frontend import ransac as jransac
    from eqvio_tpu.frontend import tracker as jtracker
    from eqvio_tpu.io.config import tracker_config_from_config as jax_tcfg
    from eqvio_tpu_torch.data import create_dataset_reader
    from eqvio_tpu_torch.frontend import build_pyramid, ransac, tracker
    from eqvio_tpu_torch.frontend.prng import fold_in, prng_key
    from eqvio_tpu_torch.frontend.prng import uniform as uniform_t
    from eqvio_tpu_torch.io import load_config, tracker_config_from_config
    from eqvio_tpu_torch.kernels.klt import klt_track_pyramid

    torch.set_num_threads(4)
    cfg = load_config(os.path.join(ROOT, "configs", SCENES[args.scene]["config"]))
    tc_t, tc_j = tracker_config_from_config(cfg), jax_tcfg(cfg)
    reader = create_dataset_reader("asl", args.scene_dir)
    h, w = reader.load_image_u8(0).shape
    st_t = tracker.tracker_init(tc_t, (h, w), "cpu")
    st_j = jtracker.tracker_init(tc_j, (h, w))
    step_j = jax.jit(lambda s, im: jtracker.tracker_step(s, im, tc_j))
    n = min(args.frames or 10**9, len(reader.images.stamps))
    max_dpx = 0.0
    for k in range(n):
        im = reader.load_image_u8(k).astype(np.float32) / np.float32(255.0)
        prev_t, prev_j = st_t, st_j
        st_t = tracker.tracker_step(st_t, torch.as_tensor(im), tc_t)
        st_j = step_j(st_j, jnp.asarray(im))
        ids_t, mask_t = st_t.ids.numpy(), st_t.mask.numpy()
        ids_j, mask_j = np.asarray(st_j.ids), np.asarray(st_j.mask)
        if np.array_equal(mask_t, mask_j) and np.array_equal(ids_t[mask_t], ids_j[mask_j]):
            both = mask_t & mask_j
            if both.any():
                max_dpx = max(max_dpx, float(np.abs(st_t.positions.numpy()[both] - np.asarray(st_j.positions)[both]).max()))
            continue
        # the first frame that differs: every gate of each package, from its own previous state
        pyr_t = build_pyramid(torch.as_tensor(im), tc_t.max_level + 1)
        new_t, err_t = klt_track_pyramid(list(prev_t.pyramid), pyr_t, prev_t.positions, prev_t.positions,
                                         tc_t.win_size, 8)
        pyr_j = jtracker.build_pyramid(jnp.asarray(im), tc_j.max_level + 1)

        def track_one(pos):
            p, err = pos / 2.0 ** tc_j.max_level, jnp.asarray(0.0, jnp.float32)
            for lvl in range(tc_j.max_level, -1, -1):
                p = p * (2.0 if lvl < tc_j.max_level else 1.0)
                p, err = jklt._track_level(prev_j.pyramid[lvl], pyr_j[lvl], pos / 2.0**lvl, p, tc_j.win_size, 8,
                                           jnp.float32)
            return p, err

        new_j, err_j = (np.asarray(x) for x in jax.vmap(track_one)(prev_j.positions))
        margin = (tc_t.win_size - 1) / 2 + 2
        inside = lambda p: (p[:, 0] >= margin) & (p[:, 0] < w - margin) & (p[:, 1] >= margin) & (p[:, 1] < h - margin)  # noqa: E731
        klt_t = prev_t.mask.numpy() & inside(new_t.numpy()) & (err_t.numpy() < tc_t.max_error)
        klt_j = np.asarray(prev_j.mask) & inside(new_j) & (err_j < tc_j.max_error)
        gate_t, gate_j = klt_t, klt_j
        if tc_t.ransac_inlier_threshold > 0:
            key_t = fold_in(prng_key(tracker.ransac_seed(), "cpu"), prev_t.next_id)
            gate_t = ransac.ransac_epipolar_mask(prev_t.positions, new_t, torch.as_tensor(klt_t), key_t,
                                                 threshold=tc_t.ransac_inlier_threshold,
                                                 hypotheses=tc_t.ransac_hypotheses,
                                                 min_inliers=tc_t.ransac_min_inliers).numpy()
            key_j = jax.random.fold_in(jax.random.PRNGKey(np.uint32(tracker.ransac_seed())), prev_j.next_id)
            gate_j = np.asarray(jransac.ransac_epipolar_mask(
                prev_j.positions, jnp.asarray(new_j), jnp.asarray(klt_j), key_j,
                threshold=tc_j.ransac_inlier_threshold, hypotheses=tc_j.ransac_hypotheses,
                min_inliers=tc_j.ransac_min_inliers))
        ran_t = ran_j = None
        if tc_t.ransac_inlier_threshold > 0:
            ran_t = ransac_detail(ransac, uniform_t, prev_t.positions, new_t, torch.as_tensor(klt_t), key_t,
                                  tc_t.ransac_inlier_threshold, tc_t.ransac_hypotheses, torch)
            ran_j = ransac_detail(jransac, lambda k, shape: jax.random.uniform(k, shape, dtype=jnp.float32),
                                  prev_j.positions, jnp.asarray(new_j), jnp.asarray(klt_j), key_j,
                                  tc_j.ransac_inlier_threshold, tc_j.ransac_hypotheses, jnp)
            # the port's gate on the JAX package's inputs, and in float64 on its own
            as_t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
            on_j = ransac_detail(ransac, uniform_t, as_t(prev_j.positions), as_t(new_j), as_t(klt_j), key_t,
                                 tc_t.ransac_inlier_threshold, tc_t.ransac_hypotheses, torch)
            f64 = ransac_detail(ransac, lambda k, shape: uniform_t(k, shape).double(), prev_t.positions.double(),
                                new_t.double(), torch.as_tensor(klt_t), key_t, tc_t.ransac_inlier_threshold,
                                tc_t.ransac_hypotheses, torch)
        slots = [int(i) for i in np.nonzero((mask_t != mask_j) | (ids_t != ids_j))[0]]
        prev_dpx = float(np.abs(prev_t.positions.numpy() - np.asarray(prev_j.positions))[prev_t.mask.numpy()].max())
        print(json.dumps({
            "scene": args.scene, "first_frame_differ": k, "frames_equal_before": k,
            "max_dpx_before": max_dpx, "max_error": tc_t.max_error, "margin_px": margin,
            "tracked": [int(mask_t.sum()), int(mask_j.sum())], "next_id": [int(st_t.next_id), int(st_j.next_id)],
            "searched": [bool(st_t.searched), bool(st_j.searched)], "prev_max_dpx": prev_dpx,
            "ransac": None if ran_t is None else {
                "best": [ran_t["best"], ran_j["best"]], "inliers_best": [ran_t["inliers_best"], ran_j["inliers_best"]],
                # the truncated (MSAC) cost of each package's best hypothesis, in both packages
                "msac_cost": {str(h): [ran_t["cost"][h], ran_j["cost"][h]] for h in {ran_t["best"], ran_j["best"]}},
                # the port's gate on the JAX package's float32 inputs, and in float64 on the port's inputs
                "port_on_jax_inputs": {"best": on_j["best"],
                                       "msac_cost": {str(h): on_j["cost"][h] for h in {ran_t["best"], ran_j["best"]}}},
                "port_float64": {"best": f64["best"],
                                 "msac_cost": {str(h): f64["cost"][h] for h in {ran_t["best"], ran_j["best"]}}}},
            "slots": [{"slot": i, "prev_id": int(prev_t.ids[i]), "ids": [int(ids_t[i]), int(ids_j[i])],
                       "mask": [bool(mask_t[i]), bool(mask_j[i])],
                       "klt_err": [float(err_t[i]), float(err_j[i])],
                       "klt_pos": [new_t[i].tolist(), new_j[i].tolist()],
                       "klt_kept": [bool(klt_t[i]), bool(klt_j[i])], "gate_kept": [bool(gate_t[i]), bool(gate_j[i])],
                       "pos": [st_t.positions[i].tolist(), np.asarray(st_j.positions)[i].tolist()],
                       "sampson_over_threshold": None if ran_t is None else {
                           "best": [ran_t["best_ratio"][i], ran_j["best_ratio"][i]],
                           "refined": [ran_t["refined_ratio"][i], ran_j["refined_ratio"][i]]}}
                      for i in slots],
        }), flush=True)
        return
    print(json.dumps({"scene": args.scene, "first_frame_differ": None, "frames_equal": n, "max_dpx": max_dpx}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["port", "jax", "compare", "ids", "tracker"])
    ap.add_argument("scene", choices=sorted(SCENES))
    ap.add_argument("csvs", nargs="*", help="compare: IMUState.csv files of fresh runs; ids: two output "
                                            "directories (or committed)")
    ap.add_argument("--out", help="port, jax: the output directory")
    ap.add_argument("--frames", type=int, default=None, help="port, jax, ids, tracker: only the first N frames")
    ap.add_argument("--device", default="cpu", choices=["cpu", "cuda"], help="port: the device")
    ap.add_argument("--f32", action="store_true", help="port: float32 (square-root covariance)")
    ap.add_argument("--scene-dir", help="jax: the JAX generator's tree (written if absent); tracker: that tree")
    args = ap.parse_args()
    {"port": run_port, "jax": run_jax, "compare": compare, "ids": compare_ids,
     "tracker": compare_trackers}[args.what](args)


if __name__ == "__main__":
    main()
