#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``eqvio_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits nonzero before the result:

1. device: needs ``torch.cuda.is_available()``; prints ``nvidia-smi``'s card
   name and power limit.
2. build: compiles ``eqvio_tpu_torch/csrc/klt_cuda.cu`` with nvcc (sm_90a).
3. kernel: on a frame pair of the in-memory benchmark scene (752x480,
   4-level pyramids, 30 detected corners plus 8 within 12 px of the
   borders) the CUDA KLT kernel against its plain PyTorch version on the
   card in float32: max |dpos| <= 2e-4 px over tracked features, identical
   tracked masks; both timed with CUDA events.
4. slice: ``run_dataset`` on ``cuda`` (float32) over the benchmark scene cut
   to 8 s (>= 100 frames): finite and healthy, >= 10 landmarks, one KLT
   launch per frame tracked; prints ms/frame and the position RMSE against
   ground truth after a similarity alignment.
5. cpu: the same run on the CPU in float64 for the first 20 frames; the
   largest per-frame position difference to the card run must stay <= 0.05 m.

Then one JSON line with the kernels' numbers and, last, the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SCENE_SECONDS = 8.0
CPU_FRAMES = 20
KERNEL_TOL_PX = 2e-4
CPU_TOL_M = 0.05


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def umeyama_rmse(est, gt) -> float:
    """Position RMSE after the least-squares similarity alignment of est onto gt."""
    import numpy as np

    mu_e, mu_g = est.mean(0), gt.mean(0)
    E, G = est - mu_e, gt - mu_g
    U, S, Vt = np.linalg.svd(G.T @ E / len(est))
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    var_e = (E**2).sum() / len(est)
    s = float(np.trace(np.diag(S) @ D) / var_e) if var_e > 0 else 1.0
    aligned = s * est @ R.T + (mu_g - s * R @ mu_e)
    return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))


def cuda_ms(fn, reps: int = 50) -> float:
    import torch

    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not os.path.isdir(os.path.join(HERE, "eqvio_tpu_torch")):
        fail("eqvio_tpu_torch/ is not beside this script: run it from a checkout of the repository")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    # ---- 1. device --------------------------------------------------------
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi could not read the card's name and power limit: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"device: {kind}, {torch.cuda.device_count()} visible, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)

    from eqvio_tpu_torch.app.run_opt import run_dataset
    from eqvio_tpu_torch.data import bench_scene
    from eqvio_tpu_torch.frontend import build_pyramid, detect_features
    from eqvio_tpu_torch.io import bench_config, tracker_config_from_config
    from eqvio_tpu_torch.kernels import klt as K
    from eqvio_tpu_torch.runtime import configure_runtime

    dev, _ = configure_runtime("cuda")

    # ---- 2. build ---------------------------------------------------------
    build_s = K.build_kernel()
    print(f"build: klt_cuda.cu -> {os.path.relpath(K.build.BUILD_DIR, HERE)} in {build_s:.2f} s", flush=True)

    # ---- 3. kernel against plain, on the card -----------------------------
    reader = bench_scene(SCENE_SECONDS)
    cfg = bench_config()
    tcfg = tracker_config_from_config(cfg)
    levels, win = tcfg.max_level + 1, tcfg.win_size
    f0, f1 = (torch.tensor(reader.load_image_u8(i), device=dev).float() * (1.0 / 255.0) for i in (100, 101))
    pyr0, pyr1 = build_pyramid(f0, levels), build_pyramid(f1, levels)
    corners, valid = detect_features(f0, tcfg.max_features, min_dist=tcfg.feature_dist, border=win)
    H, W = f0.shape
    border = torch.tensor([[6.0, 240.0], [W - 7.0, 100.0], [376.0, 5.0], [300.0, H - 6.0], [10.0, 10.0],
                           [W - 11.0, H - 11.0], [8.0, 400.0], [700.0, 8.0]], device=dev)
    pos = torch.cat([corners[valid], border]).contiguous()
    if int(valid.sum()) < tcfg.max_features:
        fail(f"only {int(valid.sum())} corners detected on the benchmark frame")

    def gate(p, err):
        margin = (win - 1) / 2 + 2
        inside = (p[:, 0] >= margin) & (p[:, 0] < W - margin) & (p[:, 1] >= margin) & (p[:, 1] < H - margin)
        return inside & (err < tcfg.max_error)

    K.klt_track_pyramid.launches = 0
    pos_k, err_k = K.klt_track_pyramid(pyr0, pyr1, pos, pos, win, 8)
    torch.cuda.synchronize()
    cmp_launches = K.klt_track_pyramid.launches
    pos_p, err_p = K.klt_track_pyramid_plain(pyr0, pyr1, pos, pos, win, 8)
    ok_k, ok_p = gate(pos_k, err_k), gate(pos_p, err_p)
    if not torch.equal(ok_k, ok_p):
        fail(f"tracked masks differ: kernel {ok_k.tolist()} plain {ok_p.tolist()}")
    if int(ok_k.sum()) < 20:
        fail(f"only {int(ok_k.sum())} of {len(pos)} features tracked on the benchmark frame pair")
    max_err = float((pos_k - pos_p).abs()[ok_k].max())
    if not np.isfinite(max_err) or max_err > KERNEL_TOL_PX or cmp_launches < 1:
        fail(f"kernel vs plain: max |dpos| {max_err} px (limit {KERNEL_TOL_PX}), launches {cmp_launches}")
    ms_kernel = cuda_ms(lambda: K.klt_track_pyramid(pyr0, pyr1, pos, pos, win, 8))
    ms_plain = cuda_ms(lambda: K.klt_track_pyramid_plain(pyr0, pyr1, pos, pos, win, 8))
    print(f"kernel: klt {len(pos)} features x {levels} levels at {W}x{H}: max |dpos| {max_err:.3g} px, "
          f"{int(ok_k.sum())} tracked, masks equal; kernel {ms_kernel:.4f} ms, plain {ms_plain:.4f} ms "
          f"({card})", flush=True)

    # ---- 4. the slice on the card ----------------------------------------
    run_dataset(reader, cfg, device="cuda", limit_frames=5)  # warm-up: library handles, allocator
    K.klt_track_pyramid.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, summary = run_dataset(reader, cfg, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.klt_track_pyramid.launches
    frames = summary["frames"]
    finite = all(bool(torch.isfinite(t).all()) for t in (state.Sigma, state.X.A.R, state.X.A.x, state.X.Q.a,
                                                          state.xi0.landmarks))
    if frames < 100 or not finite or not summary["healthy"] or summary["landmarks"] < 10:
        fail(f"slice: frames {frames}, finite {finite}, healthy {summary['healthy']}, "
             f"landmarks {summary['landmarks']}")
    if launches != frames:
        fail(f"slice: {launches} KLT kernel launches for {frames} tracked frames")
    gt = reader.groundtruth
    gt_pos = np.stack([np.interp(summary["stamps"], gt.stamps, gt.position[:, i]) for i in range(3)], -1)
    rmse = umeyama_rmse(summary["positions"], gt_pos)
    ms_frame = wall * 1e3 / frames
    print(f"slice: {frames} frames on cuda f32, {ms_frame:.2f} ms/frame, {summary['landmarks']} landmarks, "
          f"position RMSE {rmse:.4f} m (sim(3)-aligned), KLT launches {launches} ({card})", flush=True)

    # ---- 5. card against CPU ---------------------------------------------
    _, cpu = run_dataset(reader, cfg, device="cpu", limit_frames=CPU_FRAMES)
    n = min(CPU_FRAMES, len(cpu["positions"]))
    if n < CPU_FRAMES or not np.array_equal(cpu["stamps"][:n], summary["stamps"][:n]):
        fail("cpu: the float64 run did not cover the card run's first frames")
    diff = float(np.abs(cpu["positions"][:n] - summary["positions"][:n]).max())
    if not np.isfinite(diff) or diff > CPU_TOL_M:
        fail(f"cpu: max per-frame position difference {diff} m (limit {CPU_TOL_M})")
    print(f"cpu: first {n} frames, cpu f64 vs cuda f32 max position difference {diff:.3g} m", flush=True)

    print(json.dumps({"kernels": [{
        "name": "klt_track_pyramid",
        "route": "cuda",
        "source": "eqvio_tpu_torch/csrc/klt_cuda.cu",
        "replaces": "eqvio_tpu/frontend/pallas_klt.py:106",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms_kernel,
        "plain_ms": ms_plain,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
