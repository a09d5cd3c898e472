#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``eqvio_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits nonzero before the result:

1. device: needs ``torch.cuda.is_available()``; prints ``nvidia-smi``'s card
   name and power limit.
2. build: compiles ``eqvio_tpu_torch/csrc/klt_cuda.cu`` with nvcc (sm_90a),
   or loads the library an earlier run built; prints ptxas's registers and
   spills per kernel instantiation, kept beside the library.
3. kernel: the CUDA KLT kernel against its plain PyTorch version on the
   card in float32, max |dpos| <= 2e-4 px over tracked features and
   identical tracked masks, on (a) a frame pair of the in-memory benchmark
   scene (752x480, 4-level pyramids, 30 detected corners plus 8 within 12 px
   of the borders, ``eqvio_tpu_torch/kernels/klt_bench.py``) and (b) a
   textured pair moved by (48, -40) px tracked from a zero-motion guess,
   whose coarsest-level iterates travel more than 3 px.  Then, at the main
   path's shape (the 30 corners): the kernel's device time per launch from
   ``torch.profiler`` (and from the replay of 50 launches captured in one
   CUDA graph), the wrapper's host time per call, the plain version's time,
   and the bound.
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
TRAVEL_PX = 3  # coarsest-level travel of the moved pair's tracks


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
    from eqvio_tpu_torch.data import bench_scene, shifted_texture_pair
    from eqvio_tpu_torch.frontend import build_pyramid
    from eqvio_tpu_torch.io import bench_config
    from eqvio_tpu_torch.kernels import klt as K
    from eqvio_tpu_torch.kernels import klt_bench as B
    from eqvio_tpu_torch.runtime import configure_runtime

    dev, _ = configure_runtime("cuda")

    # ---- 2. build ---------------------------------------------------------
    build_s = K.build_kernel()
    print(f"build: klt_cuda.cu -> {os.path.relpath(K.build.BUILD_DIR, HERE)} in {build_s:.2f} s", flush=True)
    ptxas = K.build.ptxas_summary(K._SOURCE)
    print("ptxas: " + ("; ".join(f"{name}: {p['registers']} registers, {p['spill_bytes']} B spilled, "
                                 f"{p['smem_bytes']} B static smem" for name, p in ptxas.items())
                       or "no report beside the library"), flush=True)

    # ---- 3. kernel against plain, on the card -----------------------------
    reader = bench_scene(SCENE_SECONDS)
    cfg = bench_config()
    case = B.klt_case(dev, reader)
    pyr0, pyr1, main_pos, pos, win, iters = case.pyr0, case.pyr1, case.main, case.pair, case.win, case.iters
    levels = len(pyr0)
    H, W = pyr0[0].shape
    shift = (48, -40)
    t0_img, t1_img = shifted_texture_pair(H, W, shift, device=dev)
    tpyr0, tpyr1 = build_pyramid(t0_img, levels), build_pyramid(t1_img, levels)
    far = torch.tensor(np.random.default_rng(4).uniform([120, 100], [W - 120, H - 100], (30, 2)),
                       dtype=torch.float32, device=dev)

    def gate(p, err):
        margin = (win - 1) / 2 + 2
        inside = (p[:, 0] >= margin) & (p[:, 0] < W - margin) & (p[:, 1] >= margin) & (p[:, 1] < H - margin)
        return inside & (err < case.max_error)

    def hold(name, p0, p1, p, guess, min_tracked, truth=None):
        """Kernel against plain: equal tracked masks; positions within
        KERNEL_TOL_PX where tracked (and, given ``truth``, where the plain
        track follows it within 0.05 px: a lost track that passes the
        residual gate moves by round-off alone).  Returns the error, the
        held mask, and for the tracked ones left out the kernel's and the
        float32 plain version's largest distance to the float64 plain one."""
        pos_k, err_k = K.klt_track_pyramid(p0, p1, p, guess, win, iters)
        torch.cuda.synchronize()
        pos_p, err_p = K.klt_track_pyramid_plain(p0, p1, p, guess, win, iters)
        ok_k, ok_p = gate(pos_k, err_k), gate(pos_p, err_p)
        if not torch.equal(ok_k, ok_p):
            fail(f"{name}: tracked masks differ: kernel {ok_k.tolist()} plain {ok_p.tolist()}")
        held = ok_k if truth is None else ok_k & ((pos_p - truth).norm(dim=1) < 0.05)
        if int(held.sum()) < min_tracked:
            fail(f"{name}: only {int(held.sum())} of {len(p)} features tracked")
        err = float((pos_k - pos_p).abs()[held].max())
        if not np.isfinite(err) or err > KERNEL_TOL_PX:
            fail(f"{name}: kernel vs plain max |dpos| {err} px (limit {KERNEL_TOL_PX})")
        out = ok_k & ~held
        spread = (0.0, 0.0)
        if bool(out.any()):
            pos_64, _ = K.klt_track_pyramid_plain([t.double() for t in p0], [t.double() for t in p1],
                                                  p.double(), guess.double(), win, iters)
            spread = tuple(float((q.double() - pos_64).abs()[out].max()) for q in (pos_k, pos_p))
        return err, held, int(out.sum()), spread

    K.klt_track_pyramid.launches = 0
    err_bench, ok_bench, _, _ = hold("benchmark pair", pyr0, pyr1, pos, pos, 20)
    truth = far + torch.tensor(shift, dtype=torch.float32, device=dev)
    err_far, ok_far, n_out, spread = hold("moved pair", tpyr0, tpyr1, far, far, 20, truth)
    if K.klt_track_pyramid.launches != 2:
        fail(f"kernel: {K.klt_track_pyramid.launches} launches for 2 calls")
    top = levels - 1
    coarse, _ = K.track_level(tpyr0[top], tpyr1[top], far / 2**top, far / 2**top, win, iters)
    travelled = int((ok_far & ((coarse - far / 2**top).abs().max(1).values > TRAVEL_PX)).sum())
    if travelled < 10:
        fail(f"moved pair: only {travelled} tracked features travelled more than {TRAVEL_PX} px")
    max_err = max(err_bench, err_far)

    run_main = lambda: K.klt_track_pyramid(pyr0, pyr1, main_pos, main_pos, win, iters)  # noqa: E731
    run_pair = lambda: K.klt_track_pyramid(pyr0, pyr1, pos, pos, win, iters)  # noqa: E731
    ms_graph = B.graph_ms(run_main)
    ms_prof = B.profiler_ms(run_main, "klt_pyramid_kernel")
    ms_device = ms_prof if ms_prof is not None else ms_graph
    ms_host = B.host_ms(run_main)
    ms_plain = B.cuda_ms(lambda: K.klt_track_pyramid_plain(pyr0, pyr1, main_pos, main_pos, win, iters))
    pair_prof = B.profiler_ms(run_pair, "klt_pyramid_kernel")
    level_shapes = [tuple(p.shape) for p in pyr0]
    ms_bound, bound_by = K.bound_ms(len(main_pos), level_shapes, win, iters)
    print(f"kernel: max |dpos| {err_bench:.3g} px over {int(ok_bench.sum())} of {len(pos)} on the benchmark "
          f"pair, {err_far:.3g} px over {int(ok_far.sum())} of {len(far)} on the moved pair ({travelled} travel "
          f"more than {TRAVEL_PX} px at the coarsest level), masks equal; {n_out} tracked on the moved pair "
          f"lie more than 0.05 px off the truth and are held by mask only (distance to the float64 plain "
          f"version: kernel {spread[0]:.3g} px, float32 plain {spread[1]:.3g} px)", flush=True)
    print(f"kernel: {len(main_pos)} features x {levels} levels at {W}x{H}: device {ms_device:.5f} ms "
          f"(profiler {ms_prof}, graph replay {ms_graph:.5f}), host {ms_host:.5f} ms/call, plain "
          f"{ms_plain:.4f} ms, bound {ms_bound:.6f} ms ({bound_by}); {len(pos)} features: profiler "
          f"{pair_prof} ms ({card})", flush=True)

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
        "ms": ms_device,
        "device_ms": ms_device,
        "graph_ms": ms_graph,
        "host_ms": ms_host,
        "plain_ms": ms_plain,
        "bound_ms": ms_bound,
        "bound_by": bound_by,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
