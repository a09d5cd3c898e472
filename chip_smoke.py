#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``eqvio_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing one line; any failure exits nonzero before the result:

1. device: needs ``torch.cuda.is_available()``; prints ``nvidia-smi``'s card
   name and power limit.
2. build: compiles ``eqvio_tpu_torch/csrc/klt_cuda.cu`` and
   ``ransac_cuda.cu`` with nvcc (sm_90a), or loads the libraries an earlier
   run built; prints ptxas's registers and spills per kernel instantiation,
   kept beside each library.
3. kernel: the CUDA KLT kernel against its plain PyTorch version on the
   card in float32, max |dpos| <= 2e-4 px over tracked features and
   identical tracked masks, on (a) a frame pair of the in-memory benchmark
   scene (752x480, 4-level pyramids, 30 detected corners plus 8 within 12 px
   of the borders, ``eqvio_tpu_torch/kernels/klt_bench.py``), (b) a
   textured pair moved by (48, -40) px tracked from a zero-motion guess,
   whose coarsest-level iterates travel more than 3 px, and (c) frames 100
   and 101 of the racing proxy (``data.racing_proxy``: 640x480 fisheye,
   equalised) with its 40 detected corners and ``maxError`` 100, and (d)
   frames 100 and 101 of the MH_03 proxy (``data.mh03_proxy``: 752x480
   through the EuRoC cam0 calibration) with 40 corners detected at the
   spacing the tracker keeps its live tracks (``trackedFeatureDist``, 30 px;
   one detection at ``featureDist``, 79 px, finds 14 there, and the tracker
   fills its 40 slots over several frames) and ``maxError`` 76.  Then, at the main path's shape (the 30 corners): the
   kernel's device time per launch from ``torch.profiler`` (and from the
   replay of 50 launches captured in one CUDA graph), the wrapper's host
   time per call, the plain version's time, and the bound; and the same at
   the racing and MH_03 shapes.  (e) The sequence batch's shape: 8 lanes
   of the benchmark pair, each with its own pixel noise, tracked in one
   launch of 8 x 30 blocks: within 2e-4 px of the plain version with equal
   masks, and every lane bitwise equal to its own single-lane launch; its
   device, host, plain and bound times.  (f) The RANSAC gate kernel
   (``csrc/ransac_cuda.cu``) against its plain version on the inputs the
   tracker hands it over the first 220 frames of the MH_03 proxy (its
   config's gate: 34 hypotheses) and of the racing proxy
   (``configs/config_UZHFPV.yaml``'s gate: 20 hypotheses), with each
   config's ``min_inliers`` and with 0: masks bitwise the kernel's numpy
   mirror's, and the plain version's or near ties, counted
   (:func:`phase_gate`); the kernel's device and host time at both shapes
   and at 8 lanes in one launch (every lane bitwise its single-lane launch)
   against the plain version's, eager and replayed from a graph.  The racing
   scene (60 s, 1800 frames) and the MH_03 scene (132 s, 2,635 frames) are
   built once, before this phase, and shared with phases 7 and 10.
4. slice: the eager per-frame ``run_dataset(chunk_size=1)`` on ``cuda``
   (float32) over the benchmark scene cut
   to 8 s (>= 100 frames): finite and healthy, >= 10 landmarks, one KLT
   launch per frame tracked; prints ms/frame and the position RMSE against
   ground truth after a similarity alignment.
5. cpu: the same run on the CPU in float64 for the first 20 frames; the
   largest per-frame position difference to the card run must stay <= 0.05 m.
6. fused: ``run_dataset(chunk_size=16)`` on ``cuda`` over the same scene,
   the frame step captured once as a CUDA graph and replayed per frame, with
   ``--timing`` and ``trace`` (the step stamps its stages): finite and
   healthy, >= 10 landmarks; over the first 20 frames the same tracked ids
   as the eager card run (phase 4) with positions within 1e-4 m, and within
   0.05 m of the CPU float64 run (phase 5).  The stamps (:func:`check_stamps`)
   of consecutive frames never decrease, each frame lies between the start
   of its chunk's dispatch and the moment its row was in hand, and the
   stage sections of ``device_sections_ms`` sum to the frames' mean span
   from ``frame_begin`` to ``vision_end``.  The run traces its chunk
   ``PROFILE_CHUNK`` alone (``profile_chunk``: from an idle card to the end
   of its device work); the trace must show ``klt_pyramid_kernel`` and
   ``ransac_gate_kernel`` once and ``frame_stamp_kernel`` eight times in
   each graph launch that the tracer recorded whole (:func:`traced_chunk`),
   the summary's ``ransac_kernels_per_step`` must read 1, and the KLT
   wrapper, which does not count calls made under capture, must count the
   eager warm-ups before each capture and nothing else.  Prints fused and
   eager ms/frame, the device ms/frame and host decomposition, and from the
   traced chunk the CUDA runtime calls per frame (against those of an eager
   run), the device's idle share over the chunk's device span (the tracer
   slows the host's graph launches) and against the same chunk's untraced
   device time per frame, the host's untraced enqueue time per frame, the KLT
   kernel's device time inside the graph and the largest device kernels per
   frame; the detector's device time, and the capture's seconds and
   graph-pool bytes.

7. fisheye: the full 60 s racing proxy through ``run_dataset(chunk_size=16)``
   on ``cuda`` in float32 (square-root covariance auto-enabled) with the
   racing config (``io.racing_proxy_config``, ``configs/config_racing_proxy.yaml``),
   unstamped as users run it: finite and healthy, >= 10 landmarks,
   position RMSE <= 0.256 m after a similarity alignment; over the first 20
   frames the same tracked ids as an eager card run with positions within
   1e-4 m, and within 0.05 m of a CPU float64 run; one ``klt_pyramid_kernel``
   and no ``frame_stamp_kernel`` or ``ransac_gate_kernel`` (the config's gate
   is off) per whole graph launch in its traced chunk.
   The KLT wrapper's count is zeroed
   before each card run: one launch per frame in the eager run, and in the
   fused run exactly the eager warm-ups before its capture.  Prints
   fused ms/frame and device ms/frame.
8. filter modes, on the benchmark scene with ``configs/config_template.yaml``'s
   switches (Euclidean, accurate Riccati, discrete innovation lift, median
   depth), fused on ``cuda``: (a) float64 with dense covariance over 32
   frames, the first 20 against the CPU float64 run (same ids, positions
   within 1e-4 m), with chunk 1 traced: one ``klt_pyramid_kernel`` per whole
   graph launch; (b) float32 (square-root auto-enabled) over all 155 frames with
   ``--timing``: finite and healthy, ms/frame printed; (c)
   the Normal suite and the discrete Riccati (``useDiscreteStateMatrix``),
   20 frames each in float32: finite and healthy.  The KLT wrapper, zeroed
   before each run, must count exactly the eager warm-ups before its
   capture.

9. simulation: the ``eqvio_sim`` runner (``eqvio_tpu_torch.runner``), its
   frame step captured once as a CUDA graph and replayed per frame, on the
   ``wave`` trajectory for 30 s (595 frames, 200 Hz IMU, capacity 32, 30
   features, 1,000 points on 4 walls): (a) one sequence in float64,
   landmarks augmented at truth, with the consistency outputs: finite, ATE
   < 0.01 m, the first 20 frames within 1e-6 m and NEES 1e-6 relative of the
   CPU float64 run; (b) 128 lanes of one sequence in float32 (InvDepth, fast
   Riccati, self-initialised): every lane finite with ATE below 1.2x the JAX
   package's CPU float32 result (``scripts/sim_reference.py``), lane 0 within
   1e-4 m of a single-lane card run over 20 frames, and the device events
   per batched frame at most 64 above one lane's (a library loop over the
   128 lanes in one operation would add at least 127); (c) a fleet of 32
   different sequences with input and output noise: finite, lanes 0, 1 and
   31 within 5e-3 m of a CPU float64 fleet of the same three sequences over
   40 frames, while those sequences' CPU runs differ from each other by more
   than twice that, so a lane fed another lane's inputs fails.  Each traces 16 frames:
   one graph launch per frame, and the idle share against the same frames'
   untraced device time.  Prints ms/frame, device ms/frame, aggregate
   frames/s, NEES median and mean, attitude RMSE and lane ATEs.
10. MH_03: the full 132 s MH_03 proxy (``data.mh03_proxy``, 752x480 EuRoC
   cam0 calibration, IMU noise and bias walks) through ``run_dataset``
   fused on ``cuda`` in float32 with ``io.mh03_proxy_config``: position
   RMSE <= 0.056 m and scale within 0.05 of 1; over the first 20 frames the
   same tracked ids as an eager card run with positions within 1e-4 m, and
   within 0.05 m of a CPU float64 run; one ``klt_pyramid_kernel`` and one
   ``ransac_gate_kernel`` per whole graph launch in its traced chunk.  The
   KLT wrapper's count is zeroed before each card run: one launch per frame
   in the eager run, and in the fused run exactly the eager warm-ups before
   its one capture.  Prints ms/frame, device ms/frame, the idle share and
   RMSE.

11. sequence batch: ``bench_batch_full_frame`` (``app/run_opt.py``) on the
   benchmark scene cut at 30 s (a shorter cut renders other frames), its
   first 224 frames, 8 lanes with their own pixel noise, chunks of 32,
   float32: every lane finite, the KLT wrapper counting exactly the eager
   warm-ups before the capture and the counted step; lanes 0 and 7 over 20
   frames against their own single-sequence ``ChunkRunner`` runs on the
   same noised frames (ids equal, positions within 1e-4 m, pixels within
   1e-3 px), those two runs more than 2e-3 px apart; 16 traced batched
   frames with one ``klt_pyramid_kernel`` and one ``ransac_gate_kernel`` per
   whole graph launch and device events per batched frame at most 64 above
   one lane's.  Prints
   ``full_frame_batch_fps``, per-sequence frames/s and
   ``full_frame_batch_gflops_per_s``, device ms per batched frame against one
   lane's, the batched KLT's time in the graph, and the counted operations
   and bytes per batched frame.

12. files: the file path on ``cuda`` in float32.  (a) Phase 10's MH_03
   reader written as an ASL tree (``data.generate_mh03_proxy``: 2,635 PNG
   frames) and run through ``app.batch.run_batch`` (no figures, no timing,
   a checkpoint every 1,024 frames) with (c) the racing proxy's first 5 s
   written as a UZH-FPV tree (``generate_racing_proxy``, ``gt_format:
   uzhfpv``): MH_03's IMUState.csv must equal phase 10's in-memory run's
   (which phase 10 writes for this), its ``results.yaml`` RMSE <= 0.056 m
   with the scale within 0.05 of 1, ``summary.yaml`` must roll up both
   sequences; the KLT wrapper, zeroed first, counts the eager warm-ups and
   the counted step of each run, and each run's graph launches, less those
   that timed its first chunk, are its frames padded to whole chunks (the
   graph holds one KLT, as phase 10's trace of it shows).  (b) A run of the
   tree stopped at its checkpoint at frame 1,024 and a run resumed from
   it: their IMUState.csv rows, stitched, equal (a)'s.  (d) The benchmark
   scene's first 100 frames written into a bag with ``data.BagWriter`` and
   run with ``mode="rosbag"``, against the same frames' ASL tree: the same
   tracked ids, positions within 1e-6 m.  Prints the decoder each run used,
   the decoding thread's ms/frame and the main thread's ``iter_wait`` beside
   phase 10's, frames/s and the checkpoint's ms per save.  The trees go to
   ``build/smoke_files`` and are removed after the phase.

13. parallel: the slice of ``eqvio_tpu_torch/parallel`` (``parallel.dryrun``).
   (a) In this process, a one-rank NCCL group: phase 9(b)'s 128 lanes
   through ``build_sim_runner(batch=128, mesh={"seq": 1})``, their
   positions bitwise equal to phase 9(b)'s (the same graph over the same
   lanes), and the landmark-sharded update on ``{"lm": 1}`` in the JAX dry
   run's cases 2, 2b and 2c (float32 dense and square root at capacity 16
   over 6 frames, square root at capacity 256 over 2 frames: a 1,301 x 1,301
   pre-array), each within 1e-3 m of the local update's trajectory and 1e-2
   of its Sigma in the same eager loop; the group is destroyed after.  (b)
   The same cases in two processes that share the card over gloo (NCCL
   refuses two ranks on one card): ``{"seq": 2}``, 64 lanes a rank, within
   1e-3 m of phase 9(b), and ``{"lm": 2}`` within the same bounds.  (c) Two
   ``dist_worker`` processes on the card over gloo: process 0 prints
   ``DIST_OK``.  Each process has a time limit.  Prints the largest errors,
   the backend, ``staged=none`` (gloo carries the collectives of CUDA
   tensors) and the wall seconds; with two processes on one card they
   measure the split's overhead, not scaling.

14. surface: the public entries that once defaulted to the CPU, called with
   no ``device`` (``checkpoint.load_checkpoint`` and ``state_from_csv_line``,
   ``sim.trajectory_poses``, ``Simulator.create`` and ``from_poses``,
   ``sim.slot_tracker_init``, ``runner.default_sim_camera``,
   ``camera.default_test_camera`` and ``data.shifted_texture_pair`` at
   752x480): every output tensor on the card.  ``run_dataset`` on the
   benchmark scene, its default device, chunks of 16, 64 frames, three
   times: with no override, with ``imu_window`` equal to the derived value
   and with ``camera_lag`` equal to the config's: identical ``IMUState.csv``
   rows; a fourth run with a window 16 samples larger: finite and healthy
   and within 0.05 m of phase 5's CPU float64 run over its frames.  The KLT
   wrapper, zeroed before each run, counts the eager warm-ups before the
   capture and the counted step.  A checkpoint of phase 6's final state
   with an ``rng_key`` made on the card is saved and loaded back: the same
   state and key.  Prints the phase's seconds.

15. bench: the port's benchmark programs as a user runs them, each in its
   own process: ``python -m eqvio_tpu_torch.bench`` with ``BENCH_REPS=3``
   (the 30 s benchmark tree written to ``build/`` and read from files, the
   KLT gate on its frames 40 and 41, the 8-lane batch, the simulation at 1
   and 128 lanes; the other sizes at their defaults), then ``python -m
   eqvio_tpu_torch.bench_kernels``.  Each must exit 0 with every number of
   its line finite and ``device_kind`` naming the card and its power limit
   as ``nvidia-smi`` prints them; the bench's line must be healthy, its
   gate within 2e-4 px of the plain version with equal masks and one
   kernel launch.  Prints both lines and the phase's seconds; the tree is
   removed after the phase.

Every fused run also counts one eager frame step's operations and bytes
(``cost.py``; the summary's ``flops_per_frame``): the KLT wrapper counts that
step's launch beside the warm-ups before each capture.

Then one JSON line with the kernels' numbers and, last, the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SCENE_SECONDS = 8.0
RACING_SECONDS = 60.0
RACING_GATE_M = 0.256  # 1.2x the JAX package's committed f32 square-root result, tests/test_proxy_slow.py
MODE_FRAMES = 20  # frames of the phase-8 mode runs held against the CPU or checked for health
CPU_FRAMES = 20
KERNEL_TOL_PX = 2e-4
CPU_TOL_M = 0.05
CHUNK = 16
FUSED_FRAMES = 20  # frames compared against the eager card run and the CPU run
FUSED_TOL_M = 1e-4  # the same float32 kernels in and outside the graph; round-off only
EAGER_PROFILE_FRAMES = 8
# host runtime calls that put work on the card: kernel and graph launches, copies, fills
LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync"}
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}  # a chrome trace's device work
TRAVEL_PX = 3  # coarsest-level travel of the moved pair's tracks
PROFILE_CHUNK = 2  # the fused run's chunk that is traced (chunk 0 holds the capture)
SIM_SECONDS = 30.0  # phase 9: the wave trajectory, 200 Hz IMU, 20 Hz frames
SIM_FRAMES = 595
SIM_SCENE = dict(capacity=32, max_features=30, end_time=SIM_SECONDS, imu_freq=200.0, frame_freq=20.0, num_walls=4,
                 num_points=1000)
SIM_BATCH = 128
SIM_FLEET = 32
SIM_CMP_FRAMES = 20  # frames held against the cpu float64 run or the single-lane card run
SIM_ATE_A_M = 0.01  # (a): augmented at truth, float64
SIM_F64_TOL_M = 1e-6  # (a) on the card against the cpu, both float64
SIM_F64_NEES_RTOL = 1e-6
SIM_LANE_TOL_M = 1e-4  # (b) lane 0 against one lane, both float32 on the card
# (b): the JAX package's CPU float32 ATE for this configuration (scripts/sim_reference.py)
SIM_BATCH_JAX_CPU_ATE_M = 0.0293248825413213
SIM_BATCH_ATE_FACTOR = 1.2
# device events per batched frame at most this many above one lane's: a loop
# over the lanes inside one library call would add at least SIM_BATCH - 1
SIM_LAUNCH_SLACK = 64
SIM_FLEET_CMP_FRAMES = 40  # (c): frames held against the cpu float64 fleet
SIM_FLEET_TOL_M = 5e-3  # (c): float32 card against float64 cpu, about 1e-3 m over 20 frames on an H100
SIM_WINDOW, SIM_WINDOW_START = 16, 100  # the traced frames of each simulation run
MH03_SECONDS = 132.0
GATE_FRAMES = 220  # phase 3(f): frames of each proxy whose gate inputs hold the RANSAC kernel to its plain version
GATE_LANES = 8
MH03_GATE_M = 0.056  # tests/test_proxy_slow.py:MH03_GATE
MH03_SCALE_TOL = 0.05
PROFILE_DIR = os.path.join(HERE, "build", "smoke_profile")  # build/ is git-ignored
RACING_PROFILE_DIR = os.path.join(PROFILE_DIR, "racing")
MH03_PROFILE_DIR = os.path.join(PROFILE_DIR, "mh03")
# phase 11: bench.py's full-frame batch cell (bench.py:303-327)
BATCH_SECONDS = 30.0  # the benchmark scene's cut: a shorter one renders other frames
BATCH_LANES = 8
BATCH_FRAMES = 224
BATCH_CHUNK = 32
BATCH_REPS = 3
BATCH_CMP_FRAMES = 20  # frames of lanes 0 and 7 held against their single-sequence runs
BATCH_CHECK_LANES = (0, 7)
# the tracker's pixels: the batched KLT launch is bitwise a single lane's, so only a
# differing gate decision could move them
BATCH_PX_TOL = 1e-3
BATCH_WINDOW = 16  # traced batched frames
BATCH_LAUNCH_SLACK = 64  # device events per batched frame above one lane's, as SIM_LAUNCH_SLACK
DENSE_PROFILE_DIR = os.path.join(PROFILE_DIR, "dense")
# phase 12: the file path
FILES_DIR = os.path.join(HERE, "build", "smoke_files")  # build/ is git-ignored; removed after the phase
MH03_OUT_DIR = os.path.join(FILES_DIR, "mh03_memory")  # phase 10's CSVs, held against phase 12's
FILES_CKPT_EVERY = 1024
FILES_RACING_SECONDS = 5.0
BAG_FRAMES = 100
BAG_TOL_M = 1e-6
# phase 13: the parallel slice
MESH_DIR = os.path.join(HERE, "build", "smoke_mesh")  # build/ is git-ignored
MESH_TIMEOUT_S = 300  # each process of (b) and (c)
MESH_SEQ_TOL_M = 1e-3  # (b) against phase 9(b): the JAX dry run's bound for a sharded run
MESH_LM_CASES = ("lm", "lm_sqrt", "lm_big")  # the dry run's cases 2, 2b and 2c


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


def launch_calls(fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` (CPU and CUDA activity) and
    return its host launch and copy calls by name; the caller synchronises
    inside ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    calls: dict = {}
    for ev in prof.events():
        if ev.name in LAUNCH_CALLS:
            calls[ev.name] = calls.get(ev.name, 0) + 1
    return calls


def trace_counts(path: str):
    """From a ``torch.profiler`` chrome trace: ``(host launch and copy calls
    by name, device events [(name, start_us, end_us, correlation id)], the
    correlation ids of the graph launches in order, host span in us from
    the first launch or copy call's start to the last one's end)``.  A
    graph's kernels carry the correlation id of the launch that ran them."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    calls, device, host, graphs = {}, [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        start, end = float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0))
        corr = (ev.get("args") or {}).get("correlation")
        if ev.get("cat") in DEVICE_CATS:
            device.append((ev["name"], start, end, corr))
        elif ev["name"] in LAUNCH_CALLS:
            calls[ev["name"]] = calls.get(ev["name"], 0) + 1
            host.append((start, end))
            if ev["name"] == "cudaGraphLaunch":
                graphs.append((start, corr))
    if not device or not host:
        fail(f"{path}: {len(device)} device events and {len(host)} launch calls; categories "
             f"{sorted({str(ev.get('cat')) for ev in events})}")
    return calls, device, [c for _, c in sorted(graphs)], max(b for _, b in host) - min(a for a, _ in host)


def klt_in_graph_launches(device_events, replays):
    """Per graph launch of a trace (a graph's kernels carry its launch's
    correlation id): ``[device events, klt_pyramid_kernel launches]``, and
    the KLT kernels' durations in us."""
    per_replay = {c: [0, 0] for c in replays}
    for name, _, _, c in device_events:
        if c in per_replay:
            per_replay[c][0] += 1
            per_replay[c][1] += "klt_pyramid_kernel" in name
    klt = [b - a for name, a, b, _ in device_events if "klt_pyramid_kernel" in name]
    return list(per_replay.values()), klt


def traced_chunk(name, summary, trace_dir, chunk, stamps=0, gates=1):
    """A fused run's chunk ``chunk`` traced alone (``profile_chunk``): it
    must hold CHUNK frames and CHUNK graph launches.  Every launch replays
    the one captured graph, so a launch whose trace holds the most device
    events of any launch is complete, and each complete launch must show one
    ``klt_pyramid_kernel``, ``gates`` ``ransac_gate_kernel`` (one with the
    RANSAC gate on, none with it off) and ``stamps`` ``frame_stamp_kernel``
    (eight in a stamped step, none in one built without stamps).  The tracer can lose
    the records at the start of a trace (on the H100, up to 1,235 events of
    the first two launches), so launches short of that count may lead the
    chunk, at most half of it, with at most one KLT and ``stamps`` stamps
    each.  Returns the host launch and copy calls by
    name, the device events, ``[device events, KLT launches]`` per graph
    launch, the KLT kernels' durations in us, the host calls' span in us,
    and a note of the complete launches and the events lost."""
    prof = summary.get("profile") or {}
    if prof.get("chunk") != chunk or prof.get("frames") != CHUNK:
        fail(f"{name}: chunk {chunk} of {CHUNK} frames was not traced ({prof})")
    calls, events, replays, host_us = trace_counts(os.path.join(trace_dir, "trace.json"))
    per_replay, klt = klt_in_graph_launches(events, replays)
    stamped = dict.fromkeys(replays, 0)
    for ev_name, _, _, c in events:
        if c in stamped and "frame_stamp_kernel" in ev_name:
            stamped[c] += 1
    stamped = list(stamped.values())
    gated = dict.fromkeys(replays, 0)
    for ev_name, _, _, c in events:
        if c in gated and "ransac_gate_kernel" in ev_name:
            gated[c] += 1
    gated = list(gated.values())
    full = max((n for n, _ in per_replay), default=0)
    lead = next((i for i, (n, _) in enumerate(per_replay) if n == full), 0)
    complete = per_replay[lead:]
    if len(replays) != CHUNK or lead > CHUNK // 2 or any(n != full or k != 1 for n, k in complete) or \
            any(k > 1 for _, k in per_replay[:lead]) or any(m != stamps for m in stamped[lead:]) or \
            any(m > stamps for m in stamped[:lead]) or any(m != gates for m in gated[lead:]) or \
            any(m > gates for m in gated[:lead]):
        fail(f"{name}: the trace shows {len(replays)} graph launches for {CHUNK} frames, klt_pyramid_kernel "
             f"launches per graph launch {[k for _, k in per_replay]}, {len(klt)} in all, frame_stamp_kernel "
             f"{stamped} (expected {stamps}), ransac_gate_kernel {gated} (expected {gates}) (device events per "
             f"graph launch {[n for n, _ in per_replay]}, "
             f"calls {calls})")
    lost = [full - n for n, _ in per_replay[:lead]]
    note = (f"klt_pyramid_kernel once, ransac_gate_kernel {gates} times and frame_stamp_kernel {stamps} times in "
            f"each of the {len(complete)} whole graph launches of {CHUNK} ({full} device events each)")
    if lead:
        note += (f"; the tracer lost {lost} events at the start of the first {lead}, which show "
                 f"{[k for _, k in per_replay[:lead]]} KLT launches")
    return calls, events, per_replay, klt, host_us, note


def check_stamps(name, summary):
    """A traced run's stamps (its summary's ``trace`` block, on the host
    clock): consecutive frames, each frame's stamps and the next frame's
    never decreasing, each frame between the start of its chunk's
    ``dispatch`` span and the moment its row was in hand (within the clock
    offset's half width and its drift over the run), and the summary's
    ``device_sections_ms`` (features, propagation, preprocessing and
    correction, in ms rounded to 3 places) summing to within 0.005 ms of
    the frames' mean span from ``frame_begin`` to ``vision_end``.  Returns
    a note."""
    import numpy as np

    tb = summary["trace"]
    col = {f: i for i, f in enumerate(tb["frame_fields"])}
    rows = np.asarray(tb["frames"], dtype=np.int64)
    st = rows[:, col["frame_begin"]:col["frame_end"] + 1]
    if len(rows) != summary["frames"] or not np.array_equal(rows[:, col["frame"]], np.arange(len(rows))):
        fail(f"{name}: the trace block holds frames {rows[:5, col['frame']]}... for {summary['frames']} frames")
    if (np.diff(st.reshape(-1)) < 0).any():
        bad = int(np.argmax(np.diff(st.reshape(-1)) < 0)) // st.shape[1]
        fail(f"{name}: the stamps decrease at frame {bad}: {st[bad].tolist()}")
    slack = tb["clock"]["width_ns"] // 2 + abs(tb["clock"]["drift_ns"])
    dispatch = {sp[3]: sp[1] for sp in tb["spans"] if sp[0] == "dispatch"}
    after = st[:, 0] - np.asarray([dispatch[k] for k in rows[:, col["chunk"]]])
    before = rows[:, col["in_hand_ns"]] - st[:, -1]
    if after.min() < -slack or before.min() < -slack:
        fail(f"{name}: a frame begins {after.min()} ns after its chunk's dispatch began and ends {before.min()} "
             f"ns before its row was in hand (clock slack {slack} ns)")
    sec = summary["device_sections_ms"]
    summed = sum(sec[k] for k in ("features", "propagation", "preprocessing", "correction"))
    span = float(np.mean(st[:, col["vision_end"] - col["frame_begin"]] - st[:, 0])) * 1e-6
    if abs(summed - span) > 0.005:
        fail(f"{name}: device_sections_ms sum to {summed:.4f} ms/frame, the stamps' begin to vision end "
             f"{span:.4f} ({sec})")
    return (f"stamps of {len(rows)} frames in order, each frame >= {after.min() / 1e3:.1f} us after its "
            f"chunk's dispatch began and >= {before.min() / 1e3:.1f} us before its row was in hand (clock "
            f"slack {slack / 1e3:.1f} us); sections sum {summed:.3f} ms/frame against the stamps' {span:.4f}")


def check_run(name, state, summary, frames=None, min_landmarks=10):
    """Finite state, healthy summary, enough landmarks (and ``frames`` frames)."""
    import torch

    finite = all(bool(torch.isfinite(t).all()) for t in (state.Sigma, state.X.A.R, state.X.A.x, state.X.Q.a,
                                                         state.xi0.landmarks))
    if not finite or not summary["healthy"] or summary["landmarks"] < min_landmarks or \
            (frames is not None and summary["frames"] != frames):
        fail(f"{name}: frames {summary['frames']} (expected {frames}), finite {finite}, healthy "
             f"{summary['healthy']}, landmarks {summary['landmarks']}")


def kernel_label(name: str) -> str:
    """A short label for a kernel's demangled name: its functor (``MulFunctor``)
    or the host function that launched it (``direct_copy_kernel_cuda``) where
    the name holds one, else the name's start."""
    functors = [f for f in re.findall(r"\w*[Ff]unctor\w*", name)
                if f not in ("BinaryFunctor", "AUnaryFunctor", "BUnaryFunctor")]
    if functors:
        return functors[0]
    launcher = re.search(r"(\w+)\((?:at::)?TensorIterator", name)
    if launcher:
        return launcher.group(1)
    bare = re.sub(r"^void |at::native::|\(anonymous namespace\)::", "", name.split("::type ")[-1])
    return re.split(r"[(<]", bare)[0] or name[:60]


def largest_kernels(device_events, frames: int, k: int) -> str:
    """The ``k`` kernel labels with the most device time per frame, with
    their launches per frame."""
    by_label: dict = {}
    for name, a, b, _ in device_events:
        ms, count = by_label.get(kernel_label(name), (0.0, 0))
        by_label[kernel_label(name)] = (ms + (b - a) / 1e3 / frames, count + 1)
    top = sorted(by_label.items(), key=lambda kv: -kv[1][0])[:k]
    return "; ".join(f"{label} {ms:.3f} ms ({count / frames:.1f}x)" for label, (ms, count) in top)


def busy_us(device_events) -> float:
    """Union of the device events' intervals, in us."""
    total, end = 0.0, None
    for _, a, b, _ in sorted(device_events, key=lambda e: e[1]):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def sim_timed(runner):
    """One run of a simulation runner to capture, then its host wall time
    per frame (the run, its one synchronisation and the copy of the outputs)
    and its device time per frame (CUDA events around the replays of a
    second run); returns ``(wall ms/frame, device ms/frame, result)``."""
    import torch

    runner()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = runner()
    wall = time.perf_counter() - t0
    runner.reset()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    runner.replay(runner.frames)
    end.record()
    end.synchronize()
    return wall * 1e3 / runner.frames, start.elapsed_time(end) / runner.frames, res


def replay_window(name, replay, snapshot, restore, trace_dir, dev, n) -> dict:
    """``n`` frames of a captured step: their untraced device time (CUDA
    events, best of two replays from one snapshot of the carry), then the
    same frames from the same snapshot under a trace.  The trace must show
    one graph launch per frame; a launch whose trace holds the most device
    events is whole.  Returns the device events per whole launch, the KLT
    launches and durations (us) and the RANSAC gate launches per graph
    launch, the idle share against
    the untraced device time, the largest kernels and a note."""
    import torch

    from eqvio_tpu_torch.app import run_opt as R

    snap = snapshot()
    secs = R._best_of(R._device_timer(dev), replay, lambda: restore(snap))
    torch.cuda.synchronize()
    with R._profiling(trace_dir, sync=dev):
        replay()
    calls, events, replays, _ = trace_counts(os.path.join(trace_dir, "trace.json"))
    per_replay, klt = klt_in_graph_launches(events, replays)
    if calls.get("cudaGraphLaunch") != n or len(replays) != n:
        fail(f"{name}: the trace shows {calls.get('cudaGraphLaunch')} graph launches for {n} frames ({calls})")
    full = max(e for e, _ in per_replay)
    busy = busy_us(events) / 1e3 / n
    untraced = secs * 1e3 / n
    gates = dict.fromkeys(replays, 0)
    for ev_name, _, _, c in events:
        if c in gates and "ransac_gate_kernel" in ev_name:
            gates[c] += 1
    return {
        "events_per_launch": full,
        "klt_per_launch": [k for _, k in per_replay],
        "gate_per_launch": list(gates.values()),
        "whole": [e == full for e, _ in per_replay],
        "klt_us": klt,
        "device_ms_per_frame": untraced,
        "largest": largest_kernels(events, n, 6),
        "note": (f"one graph launch per frame, {full} device events per whole launch "
                 f"({sum(e == full for e, _ in per_replay)} of {n} whole), runtime calls per frame "
                 f"{sum(calls.values()) / n:.2f}, device busy {busy:.3f} ms/frame, idle share "
                 f"{1.0 - busy / untraced:.3f} against the same frames' untraced {untraced:.3f} ms/frame"),
    }


def sim_window(name, runner, trace_dir, dev) -> dict:
    """``SIM_WINDOW`` frames of a simulation runner from frame
    ``SIM_WINDOW_START`` through :func:`replay_window`."""
    runner.reset()
    runner.replay(SIM_WINDOW_START)
    win = replay_window(name, lambda: runner.replay(SIM_WINDOW), runner.step.snapshot, runner.step.restore,
                        trace_dir, dev, SIM_WINDOW)
    win["note"] = f"traced frames {SIM_WINDOW_START}-{SIM_WINDOW_START + SIM_WINDOW - 1}: {win['note']}"
    return win


def phase_sim(dev, card):
    """Phase 9: the simulation runner on the card, (a) one sequence in
    float64 with the consistency outputs, (b) SIM_BATCH lanes of one
    sequence in float32, (c) a fleet of SIM_FLEET sequences in float32.
    Returns (b)'s positions ``[SIM_BATCH, T, 3]``, which phase 13 holds its
    sharded runs to."""
    import numpy as np
    import torch

    from eqvio_tpu_torch import filter as F
    from eqvio_tpu_torch import runner as SR

    f64, f32 = torch.float64, torch.float32

    # (a) one sequence, float64, landmarks augmented at truth, consistency outputs
    settings_a = F.Settings(measurement_noise=0.5)
    inputs_a = SR.prepare_sim_inputs(settings_a, dtype=f64, **SIM_SCENE)
    run_a = SR.build_sim_runner(settings_a, inputs_a, consistency=True, device="cuda")
    ms_a, dev_a, res_a = sim_timed(run_a)
    T = run_a.frames
    est_a, gt_a = res_a.est_position.numpy(), res_a.true_position.numpy()
    ate_a, scale_a = SR.ate_rmse(est_a, gt_a)
    att_a = SR.attitude_rmse(res_a.est_attitude.numpy(), res_a.true_attitude.numpy())
    nees_a = res_a.nees.numpy()
    if T != SIM_FRAMES or not np.isfinite(est_a).all() or not np.isfinite(nees_a).all() or ate_a >= SIM_ATE_A_M:
        fail(f"sim (a): {T} frames (expected {SIM_FRAMES}), finite {np.isfinite(est_a).all()} and "
             f"{np.isfinite(nees_a).all()}, ATE {ate_a} m (limit {SIM_ATE_A_M})")
    cpu_a = SR.build_sim_runner(settings_a, inputs_a, consistency=True, device="cpu")
    cpu_a.replay(SIM_CMP_FRAMES)
    ref_a = cpu_a.result()
    n = SIM_CMP_FRAMES
    d_pos_a = float(np.abs(est_a[:n] - ref_a.est_position[:n].numpy()).max())
    d_nees_a = float(np.max(np.abs(nees_a[:n] - ref_a.nees[:n].numpy()) / np.abs(ref_a.nees[:n].numpy())))
    if not d_pos_a <= SIM_F64_TOL_M or not d_nees_a <= SIM_F64_NEES_RTOL:
        fail(f"sim (a): against the cpu float64 run over {n} frames: positions {d_pos_a} m (limit "
             f"{SIM_F64_TOL_M}), NEES {d_nees_a} relative (limit {SIM_F64_NEES_RTOL})")
    win_a = sim_window("sim (a)", run_a, os.path.join(PROFILE_DIR, "sim_a"), dev)
    print(f"sim (a): wave {SIM_SECONDS:.0f} s, {T} frames, float64 dense, augmented at truth, consistency: "
          f"{ms_a:.3f} ms/frame, device {dev_a:.3f} ms/frame; ATE {ate_a:.5f} m (scale {scale_a:.4f}), attitude "
          f"RMSE {att_a:.4f} deg, NEES median {np.median(nees_a):.4f} mean {np.mean(nees_a):.4f}; first {n} frames "
          f"within {d_pos_a:.3g} m and NEES {d_nees_a:.3g} relative of the cpu float64 run; {win_a['note']} ({card})",
          flush=True)

    # (b) B lanes of one sequence, float32, self-initialised (the bench's sim settings)
    settings_b = F.Settings(measurement_noise=0.5, coordinate_choice="invdepth", fast_riccati=True,
                            use_discrete_innovation_lift=False, use_median_depth=False, initial_scene_depth=2.5)
    inputs_b = SR.prepare_sim_inputs(settings_b, dtype=f32, **SIM_SCENE)
    opts_b = dict(augment_true_landmarks=False, compute_nees=False, device="cuda")
    run_b = SR.build_sim_runner(settings_b, inputs_b, batch=SIM_BATCH, **opts_b)
    ms_b, dev_b, res_b = sim_timed(run_b)
    est_b, gt_b = res_b.est_position.numpy(), res_b.true_position.numpy()
    ates_b = [SR.ate_rmse(e, g)[0] for e, g in zip(est_b, gt_b)]
    gate_b = SIM_BATCH_ATE_FACTOR * SIM_BATCH_JAX_CPU_ATE_M
    if est_b.shape != (SIM_BATCH, SIM_FRAMES, 3) or not np.isfinite(est_b).all() or max(ates_b) >= gate_b:
        fail(f"sim (b): shape {est_b.shape}, finite {np.isfinite(est_b).all()}, worst lane ATE {max(ates_b)} m "
             f"(gate {gate_b})")
    one_b = SR.build_sim_runner(settings_b, inputs_b, **opts_b)
    res_1 = one_b()
    d_lane0 = float(np.abs(est_b[0, :n] - res_1.est_position[:n].numpy()).max())
    if not d_lane0 <= SIM_LANE_TOL_M:
        fail(f"sim (b): lane 0 against the single-lane card run over {n} frames: {d_lane0} m "
             f"(limit {SIM_LANE_TOL_M})")
    win_b = sim_window("sim (b)", run_b, os.path.join(PROFILE_DIR, "sim_b"), dev)
    win_1 = sim_window("sim (b) one lane", one_b, os.path.join(PROFILE_DIR, "sim_b1"), dev)
    per_b, per_1 = win_b["events_per_launch"], win_1["events_per_launch"]
    if per_b > per_1 + SIM_LAUNCH_SLACK:
        fail(f"sim (b): {per_b} device events per batched frame against {per_1} for one lane (limit "
             f"+{SIM_LAUNCH_SLACK}): the launches grow with the {SIM_BATCH} lanes")
    print(f"sim (b): {SIM_BATCH} lanes x {T} frames, float32 dense, self-initialised: {SIM_BATCH * T / (ms_b * T / 1e3):.1f} "
          f"frames/s aggregate ({ms_b:.3f} ms per batched frame on the host clock), device {dev_b:.3f} ms per batched "
          f"frame; lane ATE median {np.median(ates_b):.5f} worst {max(ates_b):.5f} m (gate {gate_b:.5f} = "
          f"{SIM_BATCH_ATE_FACTOR} x the JAX package's CPU float32 {SIM_BATCH_JAX_CPU_ATE_M}); lane 0 within "
          f"{d_lane0:.3g} m of the single-lane card run over {n} frames; device events per frame {per_b} batched "
          f"against {per_1} for one lane and {win_a['events_per_launch']} for (a); one lane's device time "
          f"{win_1['device_ms_per_frame']:.3f} ms/frame over the same frames; {win_b['note']} ({card})",
          flush=True)
    print(f"sim (b): largest device kernels per batched frame: {win_b['largest']}; one lane: {win_1['largest']} "
          f"({card})", flush=True)

    # (c) a fleet of K different sequences, float32, input and output noise
    t0 = time.perf_counter()
    noisy = dict(SIM_SCENE, input_noise=True, output_noise=True)
    inputs_c = [SR.prepare_sim_inputs(settings_b, seed=i, noise_seed=i + 1, dtype=f32, **noisy)
                for i in range(SIM_FLEET)]
    prep_c = time.perf_counter() - t0
    run_c = SR.build_fleet_runner(settings_b, inputs_c, device="cuda")
    ms_c, dev_c, res_c = sim_timed(run_c)
    est_c, gt_c = res_c.est_position.numpy(), res_c.true_position.numpy()
    if est_c.shape != (SIM_FLEET, SIM_FRAMES, 3) or not np.isfinite(est_c).all():
        fail(f"sim (c): shape {est_c.shape}, finite {np.isfinite(est_c).all()}")
    ates_c = [SR.ate_rmse(e, g)[0] for e, g in zip(est_c, gt_c)]
    # the cpu float64 fleet of lanes 0, 1 and K-1: each card lane must lie within
    # the tolerance of its own sequence, and the sequences more than twice it
    # apart, so that no lane can pass on another lane's inputs or state
    lanes_c, m = (0, 1, SIM_FLEET - 1), SIM_FLEET_CMP_FRAMES
    cpu_c = SR.build_fleet_runner(settings_b, [SR.prepare_sim_inputs(settings_b, seed=i, noise_seed=i + 1,
                                                                     dtype=f64, **noisy) for i in lanes_c],
                                  device="cpu")
    cpu_c.replay(m)
    ref_c = cpu_c.result().est_position[:, :m].numpy()
    d_fleet = float(np.abs(est_c[list(lanes_c), :m] - ref_c).max())
    apart_c = min(float(np.abs(ref_c[i] - ref_c[j]).max()) for i in range(3) for j in range(i + 1, 3))
    if not d_fleet <= SIM_FLEET_TOL_M or not apart_c > 2 * SIM_FLEET_TOL_M:
        fail(f"sim (c): lanes {lanes_c} against the cpu float64 fleet over {m} frames: {d_fleet} m (limit "
             f"{SIM_FLEET_TOL_M}); the cpu sequences lie {apart_c} m apart (must exceed {2 * SIM_FLEET_TOL_M})")
    print(f"sim (c): fleet of {SIM_FLEET} sequences (seeds 0-{SIM_FLEET - 1}, noise seeds 1-{SIM_FLEET}) x {T} frames, "
          f"float32, input and output noise: {SIM_FLEET * T / (ms_c * T / 1e3):.1f} frames/s aggregate, device "
          f"{dev_c:.3f} ms per batched frame; lane ATE median {np.median(ates_c):.5f} worst {max(ates_c):.5f} m; "
          f"lanes {lanes_c} within {d_fleet:.3g} m of the cpu float64 fleet over {m} frames (limit "
          f"{SIM_FLEET_TOL_M}), whose sequences lie at least {apart_c:.3g} m apart; inputs prepared on the host "
          f"in {prep_c:.1f} s ({card})", flush=True)
    return est_b


def phase_gate(dev, mh03, cfg_mh03, racing, card) -> list:
    """Phase 3(f): the RANSAC gate kernel against its plain version on the
    inputs the tracker hands it over the first GATE_FRAMES frames of each
    proxy with its benchmark cell's gate (MH_03: 34 hypotheses, 30 inliers;
    racing: ``configs/config_UZHFPV.yaml``'s 20 hypotheses, 37 inliers),
    once with the configuration's ``min_inliers`` and once with 0 (every
    refit shows): the kernel's mask bit for bit its numpy mirror's
    (``ransac_bench.kernel_mirror``), and the plain version's or a near tie
    (``ransac_bench.near_tie``), counted by kind.  Then, on the frame with the most tracked slots, the
    kernel alone (profiler, graph replay, host per call) against the plain
    version (eager, and replayed from a graph as it runs in the frame step),
    at both shapes, and at GATE_LANES lanes of MH_03 frames in one launch
    (every lane bitwise its single-lane launch) against the plain version
    under ``torch.func.vmap``.  Returns the kernel rows of the result JSON."""
    import torch

    from eqvio_tpu_torch.io import load_config
    from eqvio_tpu_torch.kernels import klt_bench as B
    from eqvio_tpu_torch.kernels import ransac as RK
    from eqvio_tpu_torch.kernels import ransac_bench as RB

    cfg_uzh = load_config(os.path.join(HERE, "configs", "config_UZHFPV.yaml"))
    rows = []
    for label, reader, cfg in (("MH_03", mh03, cfg_mh03), ("racing", racing, cfg_uzh)):
        t0 = time.perf_counter()
        inputs, kw = RB.gate_inputs(reader, cfg, GATE_FRAMES, dev)
        args = (kw["threshold"], kw["hypotheses"], 8, kw["min_inliers"])
        RK.ransac_mask.launches = 0
        ties = [{}, {}]
        for g in inputs:
            for tally, a in zip(ties, (args, args[:3] + (0,))):
                got, want = RK.ransac_mask(*g, *a), RK.ransac_mask_plain(*g, *a)
                if not torch.equal(got.cpu(), RB.kernel_mirror(g, *a)):
                    fail(f"gate ({label}, min_inliers {a[3]}): kernel {got.int().tolist()} is not its mirror's mask")
                if not torch.equal(got, want):
                    why = RB.near_tie(got, g, a[0], a[1], a[3])
                    if why is None:
                        fail(f"gate ({label}, min_inliers {a[3]}): kernel {got.int().tolist()} against plain "
                             f"{want.int().tolist()}, no near tie")
                    tally[why] = tally.get(why, 0) + 1
        if RK.ransac_mask.launches != 2 * len(inputs):
            fail(f"gate ({label}): {RK.ransac_mask.launches} launches for {2 * len(inputs)} calls")
        g = max(inputs, key=lambda g: int(g.mask.sum()))
        run = lambda: RK.ransac_mask(*g, *args)  # noqa: E731
        plain = lambda: RK.ransac_mask_plain(*g, *args)  # noqa: E731
        t = {"profiler_ms": B.profiler_ms(run, "ransac_gate_kernel"), "graph_ms": B.graph_ms(run),
             "host_ms": B.host_ms(run), "plain_ms": B.cuda_ms(plain, reps=5),
             "plain_graph_ms": B.graph_ms(plain, launches=1, replays=10)}
        t["ms"] = t["profiler_ms"] if t["profiler_ms"] is not None else t["graph_ms"]
        shape = f"K = {kw['hypotheses']}, N = {g.mask.shape[0]} ({int(g.mask.sum())} tracked)"
        print(f"gate: {label}, {len(inputs)} frames' inputs ({time.perf_counter() - t0:.1f} s): masks bitwise the "
              f"mirror's; equal to the plain version's but for near ties {ties[0]} (min_inliers "
              f"{kw['min_inliers']}) and {ties[1]} (min_inliers 0); {shape}: device {t['ms']:.5f} ms (profiler {t['profiler_ms']}, graph replay "
              f"{t['graph_ms']:.5f}), host {t['host_ms']:.5f} ms/call, plain {t['plain_ms']:.3f} ms eager and "
              f"{t['plain_graph_ms']:.4f} ms replayed from a graph ({card})", flush=True)
        rows.append({"name": "ransac_mask", "shape": f"{label}: {shape}", "route": "cuda",
                     "source": "eqvio_tpu_torch/csrc/ransac_cuda.cu", "replaces": None,
                     "near_ties": ties[0], "near_ties_min_inliers_0": ties[1], **t, "library_ms": None})
        if label == "MH_03":
            lanes_in = sorted(inputs, key=lambda g: -int(g.mask.sum()))[:GATE_LANES]
            prev, curr, mask, key, ids = (torch.stack([getattr(g, f) for g in lanes_in]) for f in RB.GateInput._fields)
            key = key[0]
            gate_l = lambda p, c, m, i: RK.ransac_mask(p, c, m, key, i, *args)  # noqa: E731
            plain_l = lambda p, c, m, i: RK.ransac_mask_plain(p, c, m, key, i, *args)  # noqa: E731
            got = torch.func.vmap(gate_l)(prev, curr, mask, ids)
            for b in range(GATE_LANES):
                if not torch.equal(got[b], gate_l(prev[b], curr[b], mask[b], ids[b])):
                    fail(f"gate lanes: lane {b} of the batched launch is not bitwise its single-lane launch")
            run_l = lambda: torch.func.vmap(gate_l)(prev, curr, mask, ids)  # noqa: E731
            plain_vm = lambda: torch.func.vmap(plain_l)(prev, curr, mask, ids)  # noqa: E731
            tl = {"profiler_ms": B.profiler_ms(run_l, "ransac_gate_kernel"), "graph_ms": B.graph_ms(run_l),
                  "host_ms": B.host_ms(run_l), "plain_ms": B.cuda_ms(plain_vm, reps=5),
                  "plain_graph_ms": B.graph_ms(plain_vm, launches=1, replays=10)}
            tl["ms"] = tl["profiler_ms"] if tl["profiler_ms"] is not None else tl["graph_ms"]
            lanes_eq = sum(torch.equal(got[b], plain_l(prev[b], curr[b], mask[b], ids[b])) for b in range(GATE_LANES))
            print(f"gate: {GATE_LANES} lanes of MH_03 frames under vmap, one launch: every lane bitwise its "
                  f"single-lane launch, {lanes_eq} of {GATE_LANES} equal to the plain version; device "
                  f"{tl['ms']:.5f} ms (profiler {tl['profiler_ms']}, graph replay {tl['graph_ms']:.5f}), host {tl['host_ms']:.5f} "
                  f"ms/call, plain under vmap {tl['plain_ms']:.3f} ms eager and {tl['plain_graph_ms']:.4f} ms "
                  f"replayed from a graph ({card})", flush=True)
            rows.append({"name": "ransac_mask", "shape": f"{GATE_LANES} lanes x {shape}, one launch", "route": "cuda",
                         "source": "eqvio_tpu_torch/csrc/ransac_cuda.cu", "replaces": None, **tl,
                         "library_ms": None})
    return rows


def case_times(K, B, case) -> dict:
    """The KLT kernel at a :class:`klt_bench.KltCase`'s shape (its detected
    corners, guesses = positions; lanes too): device ms per launch from the profiler
    (the replay of 50 launches in one CUDA graph where the profiler records
    none), the plain version's ms, and the bound."""
    run = lambda: K.klt_track_pyramid(case.pyr0, case.pyr1, case.main, case.main, case.win, case.iters)  # noqa: E731
    graph = B.graph_ms(run)
    prof = B.profiler_ms(run, "klt_pyramid_kernel")
    plain = B.cuda_ms(lambda: K.klt_track_pyramid_plain(case.pyr0, case.pyr1, case.main, case.main, case.win,
                                                        case.iters))
    shapes = [tuple(p.shape[-2:]) for p in case.pyr0]
    lanes = case.main.shape[0] if case.main.dim() == 3 else 1
    n = case.main.shape[-2]
    bound, bound_by = K.bound_ms(n, shapes, case.win, case.iters, lanes)
    shape = f"{n} features x {len(shapes)} levels at {shapes[0][1]}x{shapes[0][0]}"
    return {"ms": prof if prof is not None else graph, "profiler_ms": prof, "graph_ms": graph, "plain_ms": plain,
            "bound_ms": bound, "bound_by": bound_by, "shape": shape if lanes == 1 else f"{lanes} lanes x {shape}"}


def phase_mh03(mh03, cfg_mh03, build_s, card) -> dict:
    """Phase 10: the full MH_03 proxy through the fused path in float32,
    with its first frames against an eager card run and a CPU float64 run
    and one traced chunk; returns the KLT's counts and in-graph time."""
    import numpy as np
    import torch

    from eqvio_tpu_torch import runner as SR
    from eqvio_tpu_torch.app.run_opt import COST_STEPS, run_dataset
    from eqvio_tpu_torch.graph import WARMUP_STEPS
    from eqvio_tpu_torch.kernels import klt as K

    import shutil

    shutil.rmtree(FILES_DIR, ignore_errors=True)  # a checkpoint left there would be resumed in phase 12
    n = FUSED_FRAMES
    K.klt_track_pyramid.launches = 0
    _, eager_m = run_dataset(mh03, cfg_mh03, device="cuda", chunk_size=1, limit_frames=n)
    torch.cuda.synchronize()
    launches_m = K.klt_track_pyramid.launches
    if launches_m != n:
        fail(f"mh03: {launches_m} KLT kernel launches for the eager run's {n} frames")
    K.klt_track_pyramid.launches = 0
    t0 = time.perf_counter()
    state_m, fused_m = run_dataset(mh03, cfg_mh03, device="cuda", chunk_size=CHUNK, profile_dir=MH03_PROFILE_DIR,
                                   profile_chunk=PROFILE_CHUNK, output_dir=MH03_OUT_DIR)
    torch.cuda.synchronize()
    wall_m = time.perf_counter() - t0
    warmup_m = K.klt_track_pyramid.launches
    _, cpu_m = run_dataset(mh03, cfg_mh03, device="cpu", chunk_size=1, limit_frames=n)
    check_run("mh03", state_m, fused_m, frames=len(mh03.images.stamps))
    if warmup_m != WARMUP_STEPS + COST_STEPS:
        fail(f"mh03: the KLT wrapper counted {warmup_m} eager launches in the fused run, not the {WARMUP_STEPS} "
             f"warm-ups before its capture and the {COST_STEPS} counted step")
    gt_m = mh03.groundtruth
    gt_pos_m = np.stack([np.interp(fused_m["stamps"], gt_m.stamps, gt_m.position[:, i]) for i in range(3)], -1)
    rmse_m, scale_m = SR.ate_rmse(fused_m["positions"], gt_pos_m)
    if not rmse_m <= MH03_GATE_M or not abs(scale_m - 1.0) <= MH03_SCALE_TOL:
        fail(f"mh03: position RMSE {rmse_m} m (gate {MH03_GATE_M}), scale {scale_m} (within {MH03_SCALE_TOL} of 1)")
    if not np.array_equal(fused_m["stamps"][:n], eager_m["stamps"][:n]) or \
            not np.array_equal(cpu_m["stamps"][:n], eager_m["stamps"][:n]):
        fail("mh03: the fused, eager and cpu runs' stamps differ")
    if not np.array_equal(fused_m["feature_ids"][:n], eager_m["feature_ids"][:n]):
        bad = int(np.argmax((fused_m["feature_ids"][:n] != eager_m["feature_ids"][:n]).any(1)))
        fail(f"mh03: tracked ids differ from the eager card run from frame {bad}")
    diff_eager = float(np.abs(fused_m["positions"][:n] - eager_m["positions"][:n]).max())
    diff_cpu = float(np.abs(fused_m["positions"][:n] - cpu_m["positions"][:n]).max())
    if not np.isfinite(diff_eager) or diff_eager > FUSED_TOL_M:
        fail(f"mh03: max position difference to the eager card run {diff_eager} m (limit {FUSED_TOL_M})")
    if not np.isfinite(diff_cpu) or diff_cpu > CPU_TOL_M:
        fail(f"mh03: max position difference to the cpu float64 run {diff_cpu} m (limit {CPU_TOL_M})")
    prof_m = fused_m["profile"]
    _, events_m, _, klt_m, _, klt_note_m = traced_chunk("mh03", fused_m, MH03_PROFILE_DIR, PROFILE_CHUNK)
    frames_m = fused_m["frames"]
    ms_m = (wall_m - fused_m["setup_s"] - prof_m["s"]) * 1e3 / (frames_m - prof_m["frames"])
    busy_m = busy_us(events_m) / 1e3 / CHUNK
    print(f"mh03: MH_03 proxy, {frames_m} frames of 752x480 at 20 Hz, fused on cuda f32 (square-root) in chunks of "
          f"{CHUNK}: {ms_m:.3f} ms/frame without the {fused_m['setup_s']:.2f} s of capture and the traced chunk's "
          f"{prof_m['s']:.2f} s ({wall_m * 1e3 / frames_m:.3f} with them), device {fused_m['device_ms_per_frame']} "
          f"ms/frame; position RMSE {rmse_m:.4f} m (sim(3)-aligned, gate {MH03_GATE_M}), scale {scale_m:.4f}; "
          f"{fused_m['landmarks']} landmarks; first {n} frames: ids equal to the eager card run, positions within "
          f"{diff_eager:.3g} m of it and {diff_cpu:.3g} m of cpu f64; KLT wrapper {launches_m} launches in the eager "
          f"run, {warmup_m} eager warm-ups in the fused run; scene built on the host in {build_s:.1f} s ({card})",
          flush=True)
    print(f"mh03: traced chunk {PROFILE_CHUNK}: {klt_note_m}, {sum(klt_m) / len(klt_m) / 1e3:.5f} ms each; device "
          f"busy {busy_m:.3f} ms/frame, idle share {1.0 - busy_m / prof_m['device_ms_per_frame']:.3f} against the "
          f"same chunk's untraced device time {prof_m['device_ms_per_frame']:.3f} ms/frame; "
          f"{len(events_m) / CHUNK:.1f} device events per frame; largest by device ms/frame: "
          f"{largest_kernels(events_m, CHUNK, 8)} ({card})", flush=True)
    return {"launches": launches_m, "chunk": len(klt_m), "warmup": warmup_m,
            "graph_replay_ms": sum(klt_m) / len(klt_m) / 1e3, "ms_per_frame": ms_m,
            "device_ms_per_frame": fused_m["device_ms_per_frame"], "rmse": rmse_m,
            "iter_wait": fused_m["host_ms_per_frame"]["iter_wait"]}


def _csv_rows(path: str) -> list:
    with open(path) as f:
        return f.read().splitlines()


def phase_files(mh03, cfg_mh03, mh, card) -> dict:
    """Phase 12: the file path.  (a) The MH_03 proxy written as an ASL tree
    from phase 10's reader and run through ``app.batch.run_batch`` with a
    UZH-FPV tree of the racing proxy's first seconds (c): its IMUState.csv
    against phase 10's, its results.yaml against the gate, the roll-up of
    both; (b) an interrupted run to the first checkpoint and its resumed
    rest, stitched against (a); (d) the benchmark scene's first frames in a
    bag against the same frames' ASL tree.  Returns the KLT's counts."""
    import shutil

    import numpy as np
    import torch
    import yaml

    from eqvio_tpu_torch.app import run_opt as R
    from eqvio_tpu_torch.app.batch import run_batch
    from eqvio_tpu_torch.data import BagWriter, bench_scene, generate_mh03_proxy, generate_racing_proxy
    from eqvio_tpu_torch.data import write_asl_tree
    from eqvio_tpu_torch.graph import WARMUP_STEPS
    from eqvio_tpu_torch.io import bench_config
    from eqvio_tpu_torch.kernels import klt as K

    eager = WARMUP_STEPS + R.COST_STEPS  # the wrapper's launches per fused run: warm-ups and the counted step
    mh_dir, rc_dir = os.path.join(FILES_DIR, "mh03"), os.path.join(FILES_DIR, "racing")
    t0 = time.perf_counter()
    generate_mh03_proxy(mh_dir, end_time=MH03_SECONDS, reader=mh03)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    generate_racing_proxy(rc_dir, end_time=FILES_RACING_SECONDS)
    racing_s = time.perf_counter() - t0
    n_mh = len(mh03.images.stamps)
    n_png = len(os.listdir(os.path.join(mh_dir, "mav0", "cam0", "data")))
    mb = sum(e.stat().st_size for e in os.scandir(os.path.join(mh_dir, "mav0", "cam0", "data"))) / 1e6
    if n_png != n_mh:
        fail(f"files: the MH_03 tree holds {n_png} frames, the reader {n_mh}")

    # (a) + (c): one batch of the two trees, float32 on the card, no figures
    listing = os.path.join(FILES_DIR, "datasets.yaml")
    with open(listing, "w") as f:
        yaml.safe_dump({"datasets": [
            {"name": "mh03_proxy", "location": mh_dir, "mode": "asl", "config": os.path.join(HERE, "configs", "config_mh03_proxy.yaml")},
            {"name": "racing_proxy", "location": rc_dir, "mode": "uzhfpv",
             "camera": os.path.join(rc_dir, "camchain-imucam.yaml"),
             "groundtruth": os.path.join(rc_dir, "groundtruth.txt"), "gt_format": "uzhfpv",
             "config": os.path.join(HERE, "configs", "config_racing_proxy.yaml")}]}, f)
    out = os.path.join(FILES_DIR, "batch")
    runs = {}
    K.klt_track_pyramid.launches = 0
    t0 = time.perf_counter()
    summary = run_batch(listing, os.path.join(HERE, "configs", "config_mh03_proxy.yaml"), out, device="cuda",
                        plots=False, timing=False,
                        checkpoint_every=FILES_CKPT_EVERY, runs=runs)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    launches = K.klt_track_pyramid.launches
    run_a, run_c = runs["mh03_proxy"], runs["racing_proxy"]
    # graph launches of the run's frames: all launches less those that timed the first chunk from snapshots
    replays = {name: r["graph"]["replays"] - r["graph"]["timing_replays"] for name, r in runs.items()}
    for name, r in runs.items():
        padded = -(-r["frames"] // CHUNK) * CHUNK
        if replays[name] != padded:
            fail(f"files: {name}: {replays[name]} graph launches for {r['frames']} frames in chunks of {CHUNK} "
                 f"({r['graph']})")
    if launches != len(runs) * eager:
        fail(f"files: the KLT wrapper counted {launches} eager launches in the batch, not {eager} per sequence")
    if run_a["frames"] != n_mh or not run_a["healthy"]:
        fail(f"files: MH_03 from files ran {run_a['frames']} of {n_mh} frames, healthy {run_a['healthy']}")
    rows_a = _csv_rows(os.path.join(out, "mh03_proxy", "IMUState.csv"))
    rows_mem = _csv_rows(os.path.join(MH03_OUT_DIR, "IMUState.csv"))
    if rows_a != rows_mem:
        bad = next(i for i, (x, y) in enumerate(zip(rows_a + [""], rows_mem + [""])) if x != y)
        fail(f"files: IMUState.csv from files parts from phase 10's in-memory run at row {bad}: {rows_a[bad:bad + 1]} "
             f"against {rows_mem[bad:bad + 1]} ({len(rows_a)} and {len(rows_mem)} rows)")
    with open(os.path.join(out, "mh03_proxy", "results.yaml")) as f:
        res_a = yaml.safe_load(f)
    rmse_a, scale_a = res_a["position (m)"]["rmse"], res_a["scale"]
    if not rmse_a <= MH03_GATE_M or not abs(scale_a - 1.0) <= MH03_SCALE_TOL:
        fail(f"files: MH_03 results.yaml position RMSE {rmse_a} m (gate {MH03_GATE_M}), scale {scale_a}")
    with open(os.path.join(out, "summary.yaml")) as f:
        roll = yaml.safe_load(f)
    if roll["completed"] != 2 or summary["completed"] != 2 or not {"mh03_proxy", "racing_proxy"} <= set(roll):
        fail(f"files: summary.yaml rolls up {roll['completed']} sequences ({sorted(roll)}), not 2")
    if not run_c["healthy"] or run_c["decoder"] != run_a["decoder"]:
        fail(f"files: racing from files: healthy {run_c['healthy']}, decoder {run_c['decoder']}")

    # (b) an interrupted run to the first checkpoint, then the rest resumed from it
    b1, b2 = os.path.join(FILES_DIR, "part_a"), os.path.join(FILES_DIR, "part_b")
    _, sum_b1 = R.run_dataset(mh_dir, cfg_mh03, output_dir=b1, device="cuda", limit_frames=FILES_CKPT_EVERY,
                              checkpoint_every=FILES_CKPT_EVERY)
    ckpt = os.path.join(b1, "checkpoint.npz")
    _, sum_b2 = R.run_dataset(mh_dir, cfg_mh03, output_dir=b2, device="cuda", resume=ckpt)
    with np.load(ckpt) as z:
        at = json.loads(bytes(z["cursor_json"].tobytes()).decode())["frames"]
    rows_b1, rows_b2 = _csv_rows(os.path.join(b1, "IMUState.csv")), _csv_rows(os.path.join(b2, "IMUState.csv"))
    stitched = rows_b1[:1 + at] + rows_b2[1:]
    if at != FILES_CKPT_EVERY or sum_b2["frames"] != n_mh or stitched != rows_a:
        bad = next((i for i, (x, y) in enumerate(zip(stitched, rows_a)) if x != y), min(len(stitched), len(rows_a)))
        fail(f"files: the resumed run (checkpoint at frame {at}, {sum_b2['frames']} frames) parts from the "
             f"uninterrupted one at row {bad} of {len(rows_a)}")
    ms_save = sum_b1["checkpoint"]["ms_per_save"]

    # (d) the benchmark scene's first frames as a bag, against the same frames' ASL tree
    scene = bench_scene(SCENE_SECONDS)
    asl_dir, bag_dir = os.path.join(FILES_DIR, "bench_asl"), os.path.join(FILES_DIR, "bench_bag")
    write_asl_tree(scene, asl_dir)
    os.makedirs(bag_dir, exist_ok=True)
    last = scene.images.stamps[BAG_FRAMES - 1]
    bag = BagWriter(os.path.join(bag_dir, "seq.bag"))
    for t, g, a in zip(scene.imu.stamps, scene.imu.gyr, scene.imu.acc):
        if t <= last:
            bag.write_imu(t, g, a)
    for t, frame in zip(scene.images.stamps[:BAG_FRAMES], scene.frames):
        bag.write_image(t, frame / 255.0)
    bag.close()
    cam = scene.camera
    with open(os.path.join(bag_dir, "intrinsics.yaml"), "w") as f:
        yaml.safe_dump({"resolution": list(cam.resolution), "intrinsics": list(cam.intrinsics),
                        "distortion_coefficients": list(cam.distortion),
                        "T_BS": {"data": cam.T_BS.reshape(-1).tolist()}}, f)
    cfg_b = bench_config()
    K.klt_track_pyramid.launches = 0
    _, sum_bag = R.run_dataset(os.path.join(bag_dir, "seq.bag"), cfg_b, mode="rosbag", device="cuda")
    launches_bag = K.klt_track_pyramid.launches
    _, sum_asl = R.run_dataset(asl_dir, cfg_b, mode="asl", device="cuda", limit_frames=BAG_FRAMES)
    if sum_bag["frames"] != BAG_FRAMES or sum_asl["frames"] != BAG_FRAMES or launches_bag != eager:
        fail(f"files: bag {sum_bag['frames']} frames, ASL {sum_asl['frames']} (expected {BAG_FRAMES}); KLT wrapper "
             f"{launches_bag} eager launches in the bag run (expected {eager})")
    if not np.array_equal(sum_bag["feature_ids"], sum_asl["feature_ids"]):
        bad = int(np.argmax((sum_bag["feature_ids"] != sum_asl["feature_ids"]).any(1)))
        fail(f"files: the bag run's tracked ids differ from the ASL run's from frame {bad}")
    d_bag = float(np.abs(sum_bag["positions"] - sum_asl["positions"]).max())
    if not d_bag <= BAG_TOL_M:
        fail(f"files: bag against ASL: positions {d_bag} m apart (limit {BAG_TOL_M})")

    host = run_a["host_ms_per_frame"]
    ms_a = (run_a["frames"] / run_a["fps"] - run_a["setup_s"]) * 1e3 / run_a["frames"]  # without the capture
    print(f"files: MH_03 proxy written as an ASL tree ({n_png} PNG frames of 752x480, {mb:.1f} MB) from phase 10's "
          f"reader in {write_s:.1f} s, the racing proxy's first {FILES_RACING_SECONDS:.0f} s as a UZH-FPV tree "
          f"({run_c['frames']} frames of 640x480) in {racing_s:.1f} s; app.batch on cuda f32 (square-root, no "
          f"figures, checkpoint every {FILES_CKPT_EVERY}) in {batch_s:.1f} s ({card})", flush=True)
    print(f"files: (a) MH_03 from files: {run_a['frames']} frames, {ms_a:.3f} ms/frame without the "
          f"{run_a['setup_s']:.2f} s of capture ({1e3 / run_a['fps']:.3f} with it), device "
          f"{run_a['device_ms_per_frame']} ms/frame (phase 10 in memory: {mh['ms_per_frame']:.3f} ms/frame without "
          f"the capture and the traced chunk, device {mh['device_ms_per_frame']} ms/frame); decoder "
          f"{run_a['decoder']}, {run_a['decode_ms_per_frame']} ms/frame "
          f"on the decoding thread; main thread iter_wait {host['iter_wait']} ms/frame (in memory "
          f"{mh['iter_wait']}), upload {host['upload']}, dispatch {host['dispatch']}; IMUState.csv identical to "
          f"phase 10's ({len(rows_a) - 1} rows); results.yaml RMSE {rmse_a:.4f} m (gate {MH03_GATE_M}), scale "
          f"{scale_a:.4f}; {run_a['checkpoint']['saves']} checkpoints at "
          f"{run_a['checkpoint']['ms_per_save']} ms each; graph launches {replays}, KLT wrapper {launches} eager "
          f"launches ({eager} per sequence) ({card})", flush=True)
    print(f"files: (b) interrupted at the checkpoint of frame {at} ({ms_save} ms to save), resumed for "
          f"{sum_b2['frames'] - at} frames: the stitched IMUState.csv equals (a)'s; (c) racing from files: "
          f"{run_c['frames']} frames, decoder {run_c['decoder']} {run_c['decode_ms_per_frame']} ms/frame, RMSE "
          f"{roll['racing_proxy']['position (m)']['rmse']:.4f} m; summary.yaml: {roll['completed']} sequences, mean "
          f"RMSE {roll['mean position rmse']:.4f} m; (d) rosbag: {BAG_FRAMES} frames of the benchmark scene, decoder "
          f"{sum_bag['decoder']} {sum_bag['decode_ms_per_frame']} ms/frame, ids equal to the ASL tree's run "
          f"(decoder {sum_asl['decoder']} {sum_asl['decode_ms_per_frame']} ms/frame), positions within {d_bag:.3g} m "
          f"({card})", flush=True)
    shutil.rmtree(FILES_DIR, ignore_errors=True)
    return {"launches": launches, "replays": replays["mh03_proxy"], "frames": run_a["frames"],
            "decoder": run_a["decoder"]}


def phase_batch(card) -> dict:
    """Phase 11: the tracker-inclusive sequence batch on the benchmark scene
    (the JAX package's ``bench_batch_full_frame`` cell): the throughput run,
    lanes 0 and 7 against their own single-sequence runs, and a traced
    window of batched frames against one lane's.  Returns the batched KLT's
    numbers for the kernels line."""
    import numpy as np
    import torch

    from eqvio_tpu_torch.app import run_opt as R
    from eqvio_tpu_torch.data import bench_scene, noised_lanes
    from eqvio_tpu_torch.graph import WARMUP_STEPS, broadcast_lanes
    from eqvio_tpu_torch.io import bench_config
    from eqvio_tpu_torch.kernels import klt as K

    dev = torch.device("cuda")
    f32 = torch.float32
    t0 = time.perf_counter()
    reader = bench_scene(BATCH_SECONDS)
    cfg = bench_config()
    build_s = time.perf_counter() - t0

    # the main path: the throughput run, counted alone
    K.klt_track_pyramid.launches = 0
    t0 = time.perf_counter()
    res = R.bench_batch_full_frame(reader, cfg, BATCH_LANES, dtype=f32, limit_frames=BATCH_FRAMES,
                                   chunk_size=BATCH_CHUNK, reps=BATCH_REPS, device="cuda")
    torch.cuda.synchronize()
    bench_s = time.perf_counter() - t0
    launches = K.klt_track_pyramid.launches
    if not res["full_frame_batch_finite"] or res["full_frame_batch_frames"] != BATCH_FRAMES or \
            res["full_frame_batch_B"] != BATCH_LANES:
        fail(f"batch: {json.dumps(res)}")
    # eager launches: the warm-ups before the capture and the counted step; the replays launch it uncounted
    if launches != WARMUP_STEPS + R.COST_STEPS:
        fail(f"batch: the KLT wrapper counted {launches} eager launches, not the {WARMUP_STEPS} warm-ups and "
             f"{R.COST_STEPS} counted step")

    # lanes 0 and 7 against their own single-sequence runs on the same noised frames
    inp = R.collect_fused_inputs(reader, cfg, BATCH_FRAMES, f32, "cuda")
    imgs = torch.as_tensor(noised_lanes(inp.imgs, BATCH_LANES)).to(dev)
    meta = torch.as_tensor(inp.meta, dtype=f32).to(dev)
    meta_b = meta.expand(BATCH_LANES, *meta.shape)
    args = (inp.tcfg, inp.settings, inp.settings.suite, inp.camera, inp.imu_window, f32)
    batch = R.BatchChunkRunner(*args, *broadcast_lanes((inp.state, inp.tracker), BATCH_LANES), dev)
    n, N = BATCH_CMP_FRAMES, inp.tcfg.max_features
    outs_b = batch.run(imgs[:, :n], meta_b[:, :n]).cpu().numpy()
    singles, gaps = {}, {}
    for lane in BATCH_CHECK_LANES:
        one = R.ChunkRunner(*args, inp.state, inp.tracker, dev)
        o = one.run(imgs[lane, :n], meta[:n]).cpu().numpy()
        singles[lane] = (one, o)
        d_pos, d_px = 0.0, 0.0
        for k in range(n):
            u_b, u_1 = R._unpack_outputs(outs_b[lane, k], N), R._unpack_outputs(o[k], N)
            if not (np.array_equal(u_b[-1], u_1[-1]) and np.array_equal(u_b[-2][u_b[-1]], u_1[-2][u_1[-1]])):
                fail(f"batch: lane {lane}'s tracked ids differ from its single-sequence run at frame {k}")
            d_pos = max(d_pos, float(np.abs(u_b[1] - u_1[1]).max()))
            d_px = max(d_px, float(np.abs(u_b[-3][u_b[-1]] - u_1[-3][u_1[-1]]).max(initial=0.0)))
        if not d_pos <= FUSED_TOL_M or not d_px <= BATCH_PX_TOL:
            fail(f"batch: lane {lane} against its single-sequence run over {n} frames: positions {d_pos} m "
                 f"(limit {FUSED_TOL_M}), pixels {d_px} px (limit {BATCH_PX_TOL})")
        gaps[lane] = (d_pos, d_px)
    # the two lanes' own runs must lie apart, so that a lane fed the other's frames fails
    (_, o_a), (_, o_b) = (singles[lane] for lane in BATCH_CHECK_LANES)
    apart = 0.0
    for k in range(n):
        u_a, u_b = R._unpack_outputs(o_a[k], N), R._unpack_outputs(o_b[k], N)
        both = u_a[-1] & u_b[-1] & (u_a[-2] == u_b[-2])
        apart = max(apart, float(np.abs(u_a[-3][both] - u_b[-3][both]).max(initial=0.0)))
    if not apart > 2 * BATCH_PX_TOL:
        fail(f"batch: lanes {BATCH_CHECK_LANES}' single-sequence runs track within {apart} px of each other (must "
             f"exceed {2 * BATCH_PX_TOL})")

    # a traced window of batched frames against one lane's
    s, w = n, BATCH_WINDOW
    win_b = replay_window("batch", lambda: batch.run(imgs[:, s:s + w], meta_b[:, s:s + w]), batch.step.snapshot,
                          batch.step.restore, os.path.join(PROFILE_DIR, "batch"), dev, w)
    one0 = singles[BATCH_CHECK_LANES[0]][0]
    win_1 = replay_window("batch one lane", lambda: one0.run(imgs[0, s:s + w], meta[s:s + w]), one0.step.snapshot,
                          one0.step.restore, os.path.join(PROFILE_DIR, "batch1"), dev, w)
    for label, win in (("batched", win_b), ("one lane", win_1)):
        whole_klt = [k for k, whole in zip(win["klt_per_launch"], win["whole"]) if whole]
        whole_gate = [k for k, whole in zip(win["gate_per_launch"], win["whole"]) if whole]
        lead = win["whole"].index(True)
        if any(k != 1 for k in whole_klt + whole_gate) or lead > w // 2 or \
                any(k > 1 for k in win["klt_per_launch"][:lead] + win["gate_per_launch"][:lead]):
            fail(f"batch ({label}): klt_pyramid_kernel launches per graph launch {win['klt_per_launch']}, "
                 f"ransac_gate_kernel {win['gate_per_launch']} (whole launches {win['whole']})")
    per_b, per_1 = win_b["events_per_launch"], win_1["events_per_launch"]
    if per_b > per_1 + BATCH_LAUNCH_SLACK:
        fail(f"batch: {per_b} device events per batched frame against {per_1} for one lane (limit "
             f"+{BATCH_LAUNCH_SLACK}): the launches grow with the {BATCH_LANES} lanes")
    cost_b = batch.step.cost_analysis()
    cost_1 = one0.step.cost_analysis()
    ms_b, ms_1 = win_b["device_ms_per_frame"], win_1["device_ms_per_frame"]
    klt_ms = sum(win_b["klt_us"]) / len(win_b["klt_us"]) / 1e3
    print(f"batch: {BATCH_LANES} lanes of the benchmark scene ({BATCH_SECONDS:.0f} s cut, first {BATCH_FRAMES} frames "
          f"of 752x480, chunks of {BATCH_CHUNK}, float32, pixel noise per lane): full_frame_batch_fps "
          f"{res['full_frame_batch_fps']:.1f}, per sequence {res['full_frame_batch_per_seq_fps']:.1f} frames/s, "
          f"full_frame_batch_gflops_per_s {res['full_frame_batch_gflops_per_s']:.3f}, finite "
          f"{res['full_frame_batch_finite']} (best of {BATCH_REPS} passes; the run took {bench_s:.1f} s with its "
          f"capture; scene built on the host in {build_s:.1f} s); KLT wrapper {launches} eager launches "
          f"({card})", flush=True)
    print(f"batch: lanes {BATCH_CHECK_LANES} against their own single-sequence runs over {n} frames: ids equal, "
          f"positions within {max(g[0] for g in gaps.values()):.3g} m, pixels within "
          f"{max(g[1] for g in gaps.values()):.3g} px; the two lanes' runs track {apart:.3g} px apart ({card})",
          flush=True)
    print(f"batch: traced frames {s}-{s + w - 1}: device {ms_b:.3f} ms per batched frame against one lane's "
          f"{ms_1:.3f} ({ms_b / ms_1:.2f}x for {BATCH_LANES} lanes); device events per frame {per_b} batched against "
          f"{per_1} for one lane (limit +{BATCH_LAUNCH_SLACK}); klt_pyramid_kernel and ransac_gate_kernel once per whole "
          f"graph launch, "
          f"{klt_ms:.5f} ms each in the graph (one lane's {sum(win_1['klt_us']) / len(win_1['klt_us']) / 1e3:.5f}); "
          f"{win_b['note']} ({card})", flush=True)
    print(f"batch: counted per batched frame {cost_b['flops'] / 1e6:.3f} MFLOP and {cost_b['bytes accessed'] / 1e6:.3f} "
          f"MB in {cost_b['ops']} ops ({cost_b['flops'] / cost_1['flops']:.4f}x and "
          f"{cost_b['bytes accessed'] / cost_1['bytes accessed']:.4f}x one lane's {cost_1['flops'] / 1e6:.3f} MFLOP, "
          f"{cost_1['bytes accessed'] / 1e6:.3f} MB), {cost_b['flops'] / (ms_b * 1e6):.3f} GFLOP/s and "
          f"{cost_b['bytes accessed'] / (ms_b * 1e6):.3f} GB/s against the traced frames' device time; largest "
          f"per batched frame: {win_b['largest']}; one lane: {win_1['largest']} ({card})", flush=True)
    return {"launches": launches, "chunk": sum(win_b["klt_per_launch"]), "window": w, "graph_replay_ms": klt_ms}


def _spawn(module: str, world: int, args: list, name: str) -> list:
    """``world`` processes of ``python -m module <rank> <world> <port> args``
    on the card (gloo, sharing it); each must exit 0 within MESH_TIMEOUT_S.
    Returns their outputs."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=HERE)
    procs = [subprocess.Popen([sys.executable, "-m", module, str(r), str(world), port] + args, cwd=HERE, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        outs = [p.communicate(timeout=MESH_TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        outs = None
    finally:
        for p in procs:
            p.kill()
            p.wait()
    if outs is None:
        fail(f"{name}: {module} did not end within {MESH_TIMEOUT_S} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            fail(f"{name}: rank {r} of {module} exited {p.returncode}: {out[-2000:]}")
    return outs


def _lm_note(res) -> str:
    return "; ".join(
        f"{case} capacity {int(res[case + '/capacity'])} x {int(res[case + '/frames'])} frames: trajectory "
        f"{res[case + '/err_m']:.3g} m, Sigma {res[case + '/err_sigma']:.3g} from the local update, "
        f"{res[case + '/wall_s']:.3f} s sharded against {res[case + '/local_wall_s']:.3f} s local"
        for case in MESH_LM_CASES)


def phase_mesh(est_sim_b, card) -> None:
    """Phase 13: the parallel slice (``eqvio_tpu_torch/parallel``) on the
    card.  (a) In this process, a one-rank NCCL group (``parallel.dryrun``
    with one rank): phase 9(b)'s 128 lanes through
    ``build_sim_runner(batch=128, mesh={"seq": 1})``, bitwise equal to phase
    9(b)'s positions, and the landmark-sharded update on ``{"lm": 1}`` in
    the dry run's cases 2, 2b and 2c (dense and square root at capacity 16
    over 6 frames, square root at capacity 256 over 2 frames) within 1e-3 m
    of the local update's trajectory and 1e-2 of its Sigma; the group is
    destroyed after.  (b) The same cases in two processes that share the
    card over gloo: ``{"seq": 2}`` (64 lanes each) within 1e-3 m of phase
    9(b), and ``{"lm": 2}`` within the same bounds.  (c) Two
    ``dist_worker`` processes on the card over gloo print ``DIST_OK``.
    Collectives on CUDA tensors go through the backend directly
    (``staged=none``): gloo carries ``all_gather`` and ``all_reduce`` of
    CUDA tensors in this torch."""
    import numpy as np

    from eqvio_tpu_torch.parallel import dryrun

    shape = dict(SIM_SCENE, batch=SIM_BATCH, dtype="float32", reps=1)
    spec = {"seq": shape, **{case: {} for case in MESH_LM_CASES}}

    # (a) one rank, NCCL, in this process
    t0 = time.perf_counter()
    res = dryrun.main(0, 1, None, device="cuda", out=os.path.join(MESH_DIR, "one"), spec=spec)
    secs_a = time.perf_counter() - t0
    est = res["seq/est_position"]
    if est.shape != est_sim_b.shape or not np.array_equal(est, est_sim_b):
        fail(f"mesh (a): the {{'seq': 1}} run's positions {est.shape} are not phase 9(b)'s {est_sim_b.shape} "
             f"bitwise (largest difference {np.abs(est - est_sim_b).max() if est.shape == est_sim_b.shape else '-'})")
    if res["backend"] != "nccl":
        fail(f"mesh (a): the one-rank group's backend is {res['backend']}, not nccl")
    print(f"mesh (a): one rank, backend {res['backend']}, staged=none, in this process: {{'seq': 1}} x {SIM_BATCH} "
          f"lanes x {est.shape[1]} frames equal to phase 9(b) bitwise ({res['seq/wall_s_seq1']:.3f} s a run "
          f"against {res['seq/wall_s_local']:.3f} s without a mesh; outputs read back in "
          f"{res['seq/result_s_seq1'] * 1e3:.3f} ms against {res['seq/result_s_local'] * 1e3:.3f}); {{'lm': 1}}: "
          f"{_lm_note(res)}; {secs_a:.1f} s in all ({card})", flush=True)

    # (b) two processes sharing the card over gloo
    t0 = time.perf_counter()
    os.makedirs(MESH_DIR, exist_ok=True)
    spec_path = os.path.join(MESH_DIR, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    out_b = os.path.join(MESH_DIR, "two")
    _spawn("eqvio_tpu_torch.parallel.dryrun", 2, ["--device", "cuda", "--backend", "gloo", "--out", out_b,
                                                  "--spec", spec_path], "mesh (b)")
    secs_b = time.perf_counter() - t0
    ranks = [dict(np.load(os.path.join(out_b, f"rank{r}.npz"))) for r in range(2)]
    est = ranks[0]["seq/est_position"]
    d_seq = float(np.abs(est - est_sim_b).max()) if est.shape == est_sim_b.shape else float("inf")
    if not d_seq <= MESH_SEQ_TOL_M:
        fail(f"mesh (b): the {{'seq': 2}} run's positions {est.shape} lie {d_seq} m from phase 9(b)'s (limit "
             f"{MESH_SEQ_TOL_M})")
    r0 = ranks[0]
    print(f"mesh (b): two processes on one card over gloo (wall times: overhead, not scaling), backend "
          f"{r0['backend']}, staged=none: {{'seq': 2}} x {SIM_BATCH} lanes ({SIM_BATCH // 2} a rank) within "
          f"{d_seq:.3g} m of phase 9(b) (limit {MESH_SEQ_TOL_M}), {max(r['seq/err_m'] for r in ranks):.3g} m from "
          f"each rank's run without a mesh; a run {r0['seq/wall_s_seq2']:.3f} s against {r0['seq/wall_s_local']:.3f} "
          f"s for all {SIM_BATCH} lanes in one process beside the other (rank 1: {ranks[1]['seq/wall_s_seq2']:.3f} "
          f"and {ranks[1]['seq/wall_s_local']:.3f}); outputs read back in {r0['seq/result_s_seq2'] * 1e3:.3f} ms "
          f"with the gather against {r0['seq/result_s_local'] * 1e3:.3f}; {{'lm': 2}}: {_lm_note(r0)}; "
          f"{secs_b:.1f} s in all, process start included ({card})", flush=True)

    # (c) the multi-process worker on the card
    t0 = time.perf_counter()
    outs = _spawn("eqvio_tpu_torch.parallel.dist_worker", 2, ["--device", "cuda", "--backend", "gloo"], "mesh (c)")
    line = next((ln for ln in outs[0].splitlines() if ln.startswith("DIST_OK")), None)
    if line != "DIST_OK processes=2 global_devices=2 batch=2 active_landmarks=32":
        fail(f"mesh (c): process 0 printed {outs[0][-1000:]!r}")
    print(f"mesh (c): dist_worker, two processes on one card over gloo, staged=none: {line} "
          f"({time.perf_counter() - t0:.1f} s, process start included) ({card})", flush=True)


SURFACE_FRAMES = 64
SURFACE_DIR = os.path.join(HERE, "build", "smoke_surface")  # build/ is git-ignored; removed after the phase


def phase_surface(reader, cfg, cpu, state_f, card) -> float:
    """Phase 14 (see the module docstring); returns its seconds."""
    import shutil

    import numpy as np
    import torch
    from torch.utils._pytree import tree_leaves

    from eqvio_tpu_torch import checkpoint as CK
    from eqvio_tpu_torch import runner as SR
    from eqvio_tpu_torch import sim as S
    from eqvio_tpu_torch.app import run_opt as R
    from eqvio_tpu_torch.camera import default_test_camera
    from eqvio_tpu_torch.data import shifted_texture_pair
    from eqvio_tpu_torch.graph import WARMUP_STEPS
    from eqvio_tpu_torch.kernels import klt as K
    from eqvio_tpu_torch.lie import SE3

    t_start = time.perf_counter()
    shutil.rmtree(SURFACE_DIR, ignore_errors=True)
    os.makedirs(SURFACE_DIR)
    settings, _, _, _, _, window = R._setup(reader, cfg, torch.float32, torch.device("cuda"))

    # the entries that once defaulted to the CPU, called without a device
    times, poses = S.trajectory_poses("wave", 5.0, 100.0)
    sim = S.Simulator.create(end_time=5.0, num_points=200)
    key = torch.tensor([0, 42], dtype=torch.int64, device="cuda")
    ckpt = os.path.join(SURFACE_DIR, "checkpoint.npz")
    CK.save_checkpoint(ckpt, state_f, cursor={"frames": 0}, rng_key=key)
    loaded, _, _, key_back = CK.load_checkpoint(ckpt)
    capacity = int(state_f.xi0.landmarks.shape[-2])
    outputs = {
        "sim.trajectory_poses": (times, poses),
        "sim.Simulator.create": sim,
        "sim.Simulator.from_poses": S.Simulator.from_poses(times.cpu(), SE3(poses.R.cpu(), poses.x.cpu()),
                                                          sim.camera_offset, num_points=200),
        "sim.slot_tracker_init": S.slot_tracker_init(capacity),
        "runner.default_sim_camera": SR.default_sim_camera(),
        "camera.default_test_camera": default_test_camera(),
        "data.shifted_texture_pair": shifted_texture_pair(480, 752, (3, -2)),
        "checkpoint.load_checkpoint": loaded,
        "checkpoint.state_from_csv_line": CK.state_from_csv_line(CK.state_to_csv_line(state_f, settings), capacity,
                                                                 settings, dtype=torch.float32),
    }
    for name, out in outputs.items():
        tensors = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not tensors or not all(t.is_cuda for t in tensors):
            fail(f"surface: {name} without a device gave tensors on {sorted({str(t.device) for t in tensors})}")
    for a, b in zip(tree_leaves(state_f), tree_leaves(loaded)):
        if not torch.equal(a.to(b.dtype), b):
            fail("surface: the checkpoint's state did not load back as saved")
    if key_back is None or key_back.dtype != np.uint32 or key_back.tolist() != [0, 42]:
        fail(f"surface: the checkpoint's rng_key came back as {key_back!r}")

    # run_dataset: explicit values reproduce the defaults; a larger window runs
    lag = float((cfg.get("main") or {}).get("cameraLag", 0.0))
    rows, runs, counts = {}, {}, {}
    for name, kw in (("default", {}), ("imu_window", {"imu_window": window}), ("camera_lag", {"camera_lag": lag}),
                     ("larger_window", {"imu_window": window + 16})):
        out = os.path.join(SURFACE_DIR, name)
        K.klt_track_pyramid.launches = 0
        state, summary = R.run_dataset(reader, cfg, output_dir=out, chunk_size=CHUNK, limit_frames=SURFACE_FRAMES,
                                       **kw)
        launches = K.klt_track_pyramid.launches
        check_run(f"surface {name}", state, summary, frames=SURFACE_FRAMES)
        if launches != WARMUP_STEPS + R.COST_STEPS:
            fail(f"surface {name}: KLT wrapper {launches} eager launches (expected the {WARMUP_STEPS} warm-ups "
                 f"before capture and the {R.COST_STEPS} counted step)")
        with open(os.path.join(out, "IMUState.csv")) as f:
            rows[name] = f.read()
        runs[name], counts[name] = summary, launches
    for name in ("imu_window", "camera_lag"):
        if rows[name] != rows["default"]:
            fail(f"surface: run_dataset({name}=the default's value) wrote other IMUState rows than the default run")
    big = runs["larger_window"]
    n = min(CPU_FRAMES, len(cpu["positions"]))
    if not np.array_equal(cpu["stamps"][:n], big["stamps"][:n]):
        fail("surface: the larger window's run did not cover the cpu run's frames")
    diff = float(np.abs(cpu["positions"][:n] - big["positions"][:n]).max())
    if not np.isfinite(diff) or diff > CPU_TOL_M:
        fail(f"surface: imu_window={window + 16}: max position difference {diff} m to the cpu run (limit {CPU_TOL_M})")
    shutil.rmtree(SURFACE_DIR, ignore_errors=True)
    secs = time.perf_counter() - t_start
    print(f"surface: {len(outputs)} entries without a device on cuda; run_dataset over {SURFACE_FRAMES} frames in "
          f"chunks of {CHUNK}: imu_window={window} (derived) and camera_lag={lag} (config) rows identical to the "
          f"default's ({rows['default'].count(chr(10)) - 1} rows), imu_window={window + 16} within {diff:.3g} m of "
          f"the cpu run over {n} frames; KLT wrapper eager launches {json.dumps(counts)}; checkpoint "
          f"with rng_key [0, 42] from the card loaded back; {secs:.1f} s ({card})", flush=True)
    return secs


BENCH_TIMEOUT_S = 900  # each bench process
BENCH_REPS = 3


def _bench_line(module: str, card: str) -> dict:
    """Run ``python -m module`` from the checkout; its last line, held to
    exit 0, finite numbers, no error and ``device_kind`` naming the card."""
    from eqvio_tpu_torch.bench import _finite

    env = dict(os.environ, BENCH_REPS=str(BENCH_REPS))
    res = subprocess.run([sys.executable, "-m", module], cwd=HERE, env=env, capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT_S)
    lines = res.stdout.strip().splitlines()
    try:
        out = json.loads(lines[-1])
    except (IndexError, ValueError):
        out = None
    if res.returncode != 0 or not isinstance(out, dict):
        fail(f"bench: python -m {module} exited {res.returncode}; stdout {res.stdout[-3000:]!r}; "
             f"stderr {res.stderr[-6000:]!r}")
    sec = out.get("secondary", out)
    errors = [k for k in sec if k.endswith("_error") or k == "error"]
    if errors or not _finite(out) or sec.get("device_kind") != card:
        fail(f"bench: python -m {module}: errors {errors}, device_kind {sec.get('device_kind')!r} (card "
             f"{card!r}), non-finite numbers in {json.dumps(out)}")
    return out


def phase_bench(card) -> dict:
    """Phase 15 (see the module docstring); returns the two lines and the
    phase's seconds."""
    import shutil

    import numpy as np

    from eqvio_tpu_torch import bench as TB

    t0 = time.perf_counter()
    bench = _bench_line("eqvio_tpu_torch.bench", card)
    sec = bench["secondary"]
    if bench["healthy"] is not True or not sec.get("klt_kernel_masks_equal") or \
            not sec.get("klt_kernel_max_px_diff", np.inf) <= KERNEL_TOL_PX or sec.get("klt_kernel_launches") != 1:
        fail(f"bench: healthy {bench['healthy']}, KLT gate max |dpos| {sec.get('klt_kernel_max_px_diff')} px "
             f"(limit {KERNEL_TOL_PX}), masks equal {sec.get('klt_kernel_masks_equal')}, launches "
             f"{sec.get('klt_kernel_launches')}")
    bench_s = time.perf_counter() - t0
    kernels = _bench_line("eqvio_tpu_torch.bench_kernels", card)
    shutil.rmtree(TB.BENCH_DATASET, ignore_errors=True)
    secs = time.perf_counter() - t0
    print(f"bench: {json.dumps(bench)}", flush=True)
    print(f"bench_kernels: {json.dumps(kernels)}", flush=True)
    print(f"bench: python -m eqvio_tpu_torch.bench (BENCH_REPS={BENCH_REPS}) healthy, "
          f"full_frame_fps_single_seq {bench['value']} (reps {sec['fps_reps']}, each with its graph capture, "
          f"{sec['capture_s']} s in the last), device {sec['device_ms_per_frame']} ms/frame, decoder "
          f"{sec['decoder']}; KLT gate {sec['klt_kernel_max_px_diff']:.3g} px over {sec['klt_kernel_tracked']} "
          f"features, masks equal, {sec['klt_kernel_launches']} launch; {bench_s:.1f} s; bench_kernels "
          f"{secs - bench_s:.1f} s; the phase {secs:.1f} s ({card})", flush=True)
    return {"bench": bench, "kernels": kernels, "s": secs}


def main() -> None:
    t_smoke = time.perf_counter()
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
    from eqvio_tpu_torch.data import bench_scene, mh03_proxy, racing_proxy, shifted_texture_pair
    from eqvio_tpu_torch.frontend import build_pyramid
    from eqvio_tpu_torch.io import (bench_config, mh03_proxy_config, racing_proxy_config, settings_from_config,
                                    template_config)
    from eqvio_tpu_torch.kernels import klt as K
    from eqvio_tpu_torch.kernels import klt_bench as B
    from eqvio_tpu_torch.runtime import configure_runtime

    dev, _ = configure_runtime("cuda")

    # ---- 2. build ---------------------------------------------------------
    from eqvio_tpu_torch.kernels import ransac as RK

    build_s = K.build_kernel()
    gate_build_s = RK.build_kernel()
    print(f"build: klt_cuda.cu in {build_s:.2f} s, ransac_cuda.cu in {gate_build_s:.2f} s -> "
          f"{os.path.relpath(K.build.BUILD_DIR, HERE)}", flush=True)
    ptxas = {**K.build.ptxas_summary(K._SOURCE), **K.build.ptxas_summary(RK._SOURCE)}
    print("ptxas: " + ("; ".join(f"{name}: {p['registers']} registers, {p['spill_bytes']} B spilled, "
                                 f"{p['smem_bytes']} B static smem" for name, p in ptxas.items())
                       or "no report beside the library"), flush=True)

    # ---- the racing scene (set-up, shared by phases 3 and 7) ---------------
    t0 = time.perf_counter()
    racing = racing_proxy(RACING_SECONDS)
    cfg_r = racing_proxy_config()
    racing_build_s = time.perf_counter() - t0
    print(f"scene: racing proxy, {len(racing.images.stamps)} frames of {racing.camera.resolution[0]}x"
          f"{racing.camera.resolution[1]}, {len(racing.imu.stamps)} IMU samples, built on the host in "
          f"{racing_build_s:.1f} s", flush=True)
    t0 = time.perf_counter()
    mh03 = mh03_proxy(MH03_SECONDS)
    cfg_mh03 = mh03_proxy_config()
    mh03_build_s = time.perf_counter() - t0
    print(f"scene: MH_03 proxy, {len(mh03.images.stamps)} frames of {mh03.camera.resolution[0]}x"
          f"{mh03.camera.resolution[1]}, {len(mh03.imu.stamps)} IMU samples, built on the host in "
          f"{mh03_build_s:.1f} s", flush=True)

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

    def gate(p, err, shape, max_error):
        h, w = shape
        margin = (win - 1) / 2 + 2
        inside = (p[:, 0] >= margin) & (p[:, 0] < w - margin) & (p[:, 1] >= margin) & (p[:, 1] < h - margin)
        return inside & (err < max_error)

    def hold(name, p0, p1, p, guess, min_tracked, truth=None, max_error=case.max_error):
        """Kernel against plain: equal tracked masks; positions within
        KERNEL_TOL_PX where tracked (and, given ``truth``, where the plain
        track follows it within 0.05 px: a lost track that passes the
        residual gate moves by round-off alone).  Returns the error, the
        held mask, and for the tracked ones left out the kernel's and the
        float32 plain version's largest distance to the float64 plain one."""
        pos_k, err_k = K.klt_track_pyramid(p0, p1, p, guess, win, iters)
        torch.cuda.synchronize()
        pos_p, err_p = K.klt_track_pyramid_plain(p0, p1, p, guess, win, iters)
        ok_k, ok_p = (gate(q, e, p0[0].shape, max_error) for q, e in ((pos_k, err_k), (pos_p, err_p)))
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
    rcase = B.klt_case(dev, racing, config=cfg_r)
    err_race, ok_race, _, _ = hold("racing pair", rcase.pyr0, rcase.pyr1, rcase.main, rcase.main, 30,
                                   max_error=rcase.max_error)
    mcase = B.klt_case(dev, mh03, config=cfg_mh03, spacing="tracked")
    err_mh03, ok_mh03, _, _ = hold("mh03 pair", mcase.pyr0, mcase.pyr1, mcase.main, mcase.main, 30,
                                   max_error=mcase.max_error)
    if K.klt_track_pyramid.launches != 4:
        fail(f"kernel: {K.klt_track_pyramid.launches} launches for 4 calls")
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
    race, mt = case_times(K, B, rcase), case_times(K, B, mcase)
    for label, c, err, ok, t in (("racing pair (equalised frames 100-101", rcase, err_race, ok_race, race),
                                 ("MH_03 pair (frames 100-101", mcase, err_mh03, ok_mh03, mt)):
        print(f"kernel: {label}, maxError {c.max_error * 255:.1f}): max |dpos| {err:.3g} px over {int(ok.sum())} "
              f"of {len(c.main)}, masks equal; {t['shape']}: device {t['ms']:.5f} ms (profiler {t['profiler_ms']}, "
              f"graph replay {t['graph_ms']:.5f}), plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.6f} ms "
              f"({t['bound_by']}) ({card})", flush=True)

    # (e) the sequence batch's shape: 8 lanes of the benchmark pair, one launch
    lcase = B.klt_lanes_case(dev, reader, lanes=BATCH_LANES)
    lanes_n = lcase.main.shape[0] * lcase.main.shape[1]
    K.klt_track_pyramid.launches = 0
    pos_l, err_l = K.klt_track_pyramid(lcase.pyr0, lcase.pyr1, lcase.main, lcase.main, win, iters)
    torch.cuda.synchronize()
    pos_lp, err_lp = K.klt_track_pyramid_plain(lcase.pyr0, lcase.pyr1, lcase.main, lcase.main, win, iters)
    ok_l = gate(pos_l.reshape(-1, 2), err_l.reshape(-1), (H, W), lcase.max_error)
    if not torch.equal(ok_l, gate(pos_lp.reshape(-1, 2), err_lp.reshape(-1), (H, W), lcase.max_error)) or \
            int(ok_l.sum()) < lanes_n * 2 // 3:
        fail(f"lanes: tracked masks differ from the plain version or too few tracked ({int(ok_l.sum())} of {lanes_n})")
    err_lanes = float((pos_l - pos_lp).reshape(-1, 2).abs()[ok_l].max())
    if not np.isfinite(err_lanes) or err_lanes > KERNEL_TOL_PX:
        fail(f"lanes: kernel vs plain max |dpos| {err_lanes} px (limit {KERNEL_TOL_PX})")
    for b in range(BATCH_LANES):
        one = K.klt_track_pyramid([t[b] for t in lcase.pyr0], [t[b] for t in lcase.pyr1], lcase.main[b],
                                  lcase.main[b], win, iters)
        if not (torch.equal(one[0], pos_l[b]) and torch.equal(one[1], err_l[b])):
            fail(f"lanes: lane {b} of the batched launch is not bitwise its single-lane launch")
    if K.klt_track_pyramid.launches != 1 + BATCH_LANES:
        fail(f"lanes: {K.klt_track_pyramid.launches} launches for one batched and {BATCH_LANES} single calls")
    lanes_t = case_times(K, B, lcase)
    lanes_t["host_ms"] = B.host_ms(lambda: K.klt_track_pyramid(lcase.pyr0, lcase.pyr1, lcase.main, lcase.main, win,
                                                               iters))
    print(f"kernel: sequence batch, {BATCH_LANES} lanes of the benchmark pair with their own pixel noise, one launch of "
          f"{lanes_n} blocks: max |dpos| {err_lanes:.3g} px over {int(ok_l.sum())} of {lanes_n}, masks equal, every "
          f"lane bitwise its single-lane launch; {lanes_t['shape']}: device {lanes_t['ms']:.5f} ms (profiler "
          f"{lanes_t['profiler_ms']}, graph replay {lanes_t['graph_ms']:.5f}) against {ms_device:.5f} for one lane, host "
          f"{lanes_t['host_ms']:.5f} ms/call, plain {lanes_t['plain_ms']:.4f} ms, bound {lanes_t['bound_ms']:.6f} ms "
          f"({lanes_t['bound_by']}) ({card})", flush=True)

    # (f) the RANSAC gate kernel
    gate_rows = phase_gate(dev, mh03, cfg_mh03, racing, card)

    # ---- 4. the slice on the card ----------------------------------------
    run_dataset(reader, cfg, device="cuda", chunk_size=1, limit_frames=5)  # warm-up: library handles, allocator
    K.klt_track_pyramid.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, summary = run_dataset(reader, cfg, device="cuda", chunk_size=1)
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
    _, cpu = run_dataset(reader, cfg, device="cpu", chunk_size=1, limit_frames=CPU_FRAMES)
    n = min(CPU_FRAMES, len(cpu["positions"]))
    if n < CPU_FRAMES or not np.array_equal(cpu["stamps"][:n], summary["stamps"][:n]):
        fail("cpu: the float64 run did not cover the card run's first frames")
    diff = float(np.abs(cpu["positions"][:n] - summary["positions"][:n]).max())
    if not np.isfinite(diff) or diff > CPU_TOL_M:
        fail(f"cpu: max per-frame position difference {diff} m (limit {CPU_TOL_M})")
    print(f"cpu: first {n} frames, cpu f64 vs cuda f32 max position difference {diff:.3g} m", flush=True)

    # ---- 6. the fused path: the frame step as a CUDA graph ----------------
    from eqvio_tpu_torch.app.run_opt import COST_STEPS
    from eqvio_tpu_torch.graph import WARMUP_STEPS

    run_dataset(reader, cfg, device="cuda", chunk_size=CHUNK, limit_frames=2 * CHUNK)  # warm-up
    K.klt_track_pyramid.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_f, fused = run_dataset(reader, cfg, device="cuda", chunk_size=CHUNK, timing=True, trace=True,
                                 profile_dir=PROFILE_DIR, profile_chunk=PROFILE_CHUNK)
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t0
    warmup_launches = K.klt_track_pyramid.launches
    frames_f = fused["frames"]
    finite = all(bool(torch.isfinite(t).all()) for t in (state_f.Sigma, state_f.X.A.R, state_f.X.A.x,
                                                         state_f.X.Q.a, state_f.xi0.landmarks))
    if frames_f != frames or not finite or not fused["healthy"] or fused["landmarks"] < 10:
        fail(f"fused: frames {frames_f} (eager {frames}), finite {finite}, healthy {fused['healthy']}, "
             f"landmarks {fused['landmarks']}")
    if "graph" not in fused:
        fail("fused: the run captured no graph")
    if fused.get("ransac_kernels_per_step") != 1:
        fail(f"fused: the captured step holds {fused.get('ransac_kernels_per_step')} RANSAC gate kernels, not 1")
    # the wrapper counts eager launches only: the warm-up before the frame step's capture
    if warmup_launches != WARMUP_STEPS + COST_STEPS:
        fail(f"fused: the KLT wrapper counted {warmup_launches} eager launches, not the "
             f"{WARMUP_STEPS} of the warm-ups before capture and the {COST_STEPS} counted step")
    n = FUSED_FRAMES
    if not np.array_equal(fused["stamps"][:n], summary["stamps"][:n]):
        fail("fused: the fused and eager runs' stamps differ")
    if not np.array_equal(fused["feature_ids"][:n], summary["feature_ids"][:n]):
        bad = int(np.argmax((fused["feature_ids"][:n] != summary["feature_ids"][:n]).any(1)))
        fail(f"fused: tracked ids differ from the eager card run from frame {bad}")
    diff_eager = float(np.abs(fused["positions"][:n] - summary["positions"][:n]).max())
    diff_cpu = float(np.abs(fused["positions"][:n] - cpu["positions"][:n]).max())
    if not np.isfinite(diff_eager) or diff_eager > FUSED_TOL_M:
        fail(f"fused: max position difference to the eager card run {diff_eager} m (limit {FUSED_TOL_M})")
    if not np.isfinite(diff_cpu) or diff_cpu > CPU_TOL_M:
        fail(f"fused: max position difference to the cpu float64 run {diff_cpu} m (limit {CPU_TOL_M})")

    # chunk PROFILE_CHUNK of this run, traced alone from an idle card: launches,
    # idle share, the KLT inside the graph
    prof = fused["profile"]
    calls, device_events, _, klt, host_us, klt_note = traced_chunk("fused", fused, PROFILE_DIR, PROFILE_CHUNK,
                                                                  stamps=8)
    stamp_note = check_stamps("fused", fused)
    ms_klt_graph = sum(klt) / len(klt) / 1e3
    span_ms = (max(e[2] for e in device_events) - min(e[1] for e in device_events)) / 1e3 / CHUNK
    busy_ms = busy_us(device_events) / 1e3 / CHUNK
    idle = 1.0 - busy_ms / span_ms  # over the traced window, whose host the tracer slows
    idle_untraced = 1.0 - busy_ms / prof["device_ms_per_frame"]  # against the same chunk's untraced replays
    launches_graph = sum(calls.values()) / CHUNK
    host_ms = host_us / 1e3 / CHUNK

    setup_s = fused["setup_s"]
    # wall time per frame without the set-up (capture, timing replays) and the traced chunk
    ms_fused = (wall_f - setup_s - prof["s"]) * 1e3 / (frames_f - prof["frames"])
    sections = fused["device_sections_ms"]
    if not all(fused.get(k, 0) > 0 for k in ("flops_per_frame", "hbm_bytes_per_frame", "achieved_gflops",
                                            "achieved_hbm_gbps")):
        fail(f"fused: the summary lacks the counted work per frame: {fused.get('flops_per_frame')}")
    print(f"fused: counted per frame {fused['flops_per_frame'] / 1e6:.3f} MFLOP and "
          f"{fused['hbm_bytes_per_frame'] / 1e6:.3f} MB, achieved {fused['achieved_gflops']:.3f} GFLOP/s and "
          f"{fused['achieved_hbm_gbps']:.3f} GB/s against the device time ({card})", flush=True)
    print(f"fused: {frames_f} frames on cuda f32 in chunks of {CHUNK}: {ms_fused:.3f} ms/frame without the "
          f"{setup_s:.2f} s of set-up and the traced chunk's {prof['s']:.2f} s "
          f"({wall_f * 1e3 / frames_f:.3f} with them), eager {ms_frame:.2f} ms/frame in the same process; "
          f"device {fused['device_ms_per_frame']} ms/frame; host ms/frame {json.dumps(fused['host_ms_per_frame'])}, "
          f"dispatch {fused['dispatch_ms_per_frame']}, fetch {fused['fetch_ms_per_frame']}; {fused['landmarks']} "
          f"landmarks; first {n} frames: ids equal to the eager run, positions within {diff_eager:.3g} m of it "
          f"and {diff_cpu:.3g} m of cpu f64 ({card})", flush=True)
    print(f"fused: device sections ms/frame {json.dumps(sections)}; detector "
          f"{sections['features_full'] - sections['features_skip']:.3f} ms/frame (features full - skip); "
          f"searched fraction {fused['searched_frame_fraction']}; graph capture and instantiation "
          f"{fused['graph']['capture_s']:.3f} s, pool {fused['graph']['pool_bytes']} bytes; KLT wrapper "
          f"{warmup_launches} eager warm-up launches; {stamp_note} ({card})", flush=True)

    def eager_frames():
        run_dataset(reader, cfg, device="cuda", chunk_size=1, limit_frames=EAGER_PROFILE_FRAMES)
        torch.cuda.synchronize()

    eager_calls = launch_calls(eager_frames)
    launches_eager = sum(eager_calls.values()) / EAGER_PROFILE_FRAMES
    print(f"fused: traced chunk {PROFILE_CHUNK} of the run: CUDA runtime calls per frame {launches_graph:.2f} "
          f"({json.dumps({k: v / CHUNK for k, v in calls.items()})}) against {launches_eager:.1f} eager "
          f"({EAGER_PROFILE_FRAMES} frames of a separate run); device busy {busy_ms:.3f} ms/frame; idle share "
          f"{idle:.3f} over the traced window ({span_ms:.3f} ms/frame device span, the traced host's calls span "
          f"{host_ms:.4f} ms/frame), {idle_untraced:.3f} against the same chunk's untraced device time "
          f"{prof['device_ms_per_frame']:.3f} ms/frame; untraced host enqueue {fused['enqueue_ms_per_frame']} "
          f"ms/frame from an idle card; {klt_note}, {ms_klt_graph:.5f} ms each inside the graph ({card})",
          flush=True)
    print(f"fused: device events per frame in the traced chunk {len(device_events) / CHUNK:.1f}; largest by "
          f"device ms/frame: {largest_kernels(device_events, CHUNK, 12)} ({card})", flush=True)

    # ---- 7. fisheye: the racing proxy, fused ------------------------------
    K.klt_track_pyramid.launches = 0
    _, eager_r = run_dataset(racing, cfg_r, device="cuda", chunk_size=1, limit_frames=FUSED_FRAMES)
    torch.cuda.synchronize()
    launches_r = K.klt_track_pyramid.launches
    if launches_r != FUSED_FRAMES:
        fail(f"fisheye: {launches_r} KLT kernel launches for the eager run's {FUSED_FRAMES} frames")
    K.klt_track_pyramid.launches = 0
    t0 = time.perf_counter()
    state_r, fused_r = run_dataset(racing, cfg_r, device="cuda", chunk_size=CHUNK,
                                   profile_dir=RACING_PROFILE_DIR, profile_chunk=PROFILE_CHUNK)
    torch.cuda.synchronize()
    wall_r = time.perf_counter() - t0
    warmup_r = K.klt_track_pyramid.launches
    _, cpu_r = run_dataset(racing, cfg_r, device="cpu", chunk_size=1, limit_frames=FUSED_FRAMES)
    frames_r = fused_r["frames"]
    check_run("fisheye", state_r, fused_r, frames=len(racing.images.stamps))
    if warmup_r != WARMUP_STEPS + COST_STEPS:
        fail(f"fisheye: the KLT wrapper counted {warmup_r} eager launches in the fused run, not the "
             f"{WARMUP_STEPS} of the warm-ups before capture and the {COST_STEPS} counted step")
    gt_r = racing.groundtruth
    gt_pos_r = np.stack([np.interp(fused_r["stamps"], gt_r.stamps, gt_r.position[:, i]) for i in range(3)], -1)
    rmse_r = umeyama_rmse(fused_r["positions"], gt_pos_r)
    if not np.isfinite(rmse_r) or rmse_r > RACING_GATE_M:
        fail(f"fisheye: position RMSE {rmse_r} m (gate {RACING_GATE_M})")
    n = FUSED_FRAMES
    if not np.array_equal(fused_r["stamps"][:n], eager_r["stamps"][:n]) or \
            not np.array_equal(cpu_r["stamps"][:n], eager_r["stamps"][:n]):
        fail("fisheye: the fused, eager and cpu runs' stamps differ")
    if not np.array_equal(fused_r["feature_ids"][:n], eager_r["feature_ids"][:n]):
        bad = int(np.argmax((fused_r["feature_ids"][:n] != eager_r["feature_ids"][:n]).any(1)))
        fail(f"fisheye: tracked ids differ from the eager card run from frame {bad}")
    diff_eager_r = float(np.abs(fused_r["positions"][:n] - eager_r["positions"][:n]).max())
    diff_cpu_r = float(np.abs(fused_r["positions"][:n] - cpu_r["positions"][:n]).max())
    if not np.isfinite(diff_eager_r) or diff_eager_r > FUSED_TOL_M:
        fail(f"fisheye: max position difference to the eager card run {diff_eager_r} m (limit {FUSED_TOL_M})")
    if not np.isfinite(diff_cpu_r) or diff_cpu_r > CPU_TOL_M:
        fail(f"fisheye: max position difference to the cpu float64 run {diff_cpu_r} m (limit {CPU_TOL_M})")
    prof_r = fused_r["profile"]
    _, events_r, _, klt_r, _, klt_note_r = traced_chunk("fisheye", fused_r, RACING_PROFILE_DIR, PROFILE_CHUNK,
                                                         gates=0)
    ms_fused_r = (wall_r - fused_r["setup_s"] - prof_r["s"]) * 1e3 / (frames_r - prof_r["frames"])
    busy_r = busy_us(events_r) / 1e3 / CHUNK
    idle_r = 1.0 - busy_r / prof_r["device_ms_per_frame"]
    print(f"fisheye: racing proxy, {frames_r} frames on cuda f32 (square-root) in chunks of {CHUNK}: "
          f"{ms_fused_r:.3f} ms/frame without the {fused_r['setup_s']:.2f} s of set-up and the "
          f"traced chunk's {prof_r['s']:.2f} s ({wall_r * 1e3 / frames_r:.3f} with them); device "
          f"{fused_r['device_ms_per_frame']} ms/frame; position RMSE {rmse_r:.4f} m (sim(3)-aligned, gate "
          f"{RACING_GATE_M}); {fused_r['landmarks']} landmarks; first {n} frames: ids equal to the eager card run, "
          f"positions within {diff_eager_r:.3g} m of it and {diff_cpu_r:.3g} m of cpu f64; traced chunk: {klt_note_r}, "
          f"{sum(klt_r) / len(klt_r) / 1e3:.5f} ms each; "
          f"KLT wrapper {launches_r} launches in the eager run, {warmup_r} eager warm-ups in the fused run; "
          f"scene built in {racing_build_s:.1f} s ({card})", flush=True)
    print(f"fisheye: traced chunk {PROFILE_CHUNK}: device busy {busy_r:.3f} ms/frame, idle share {idle_r:.3f} against "
          f"the same chunk's untraced device time {prof_r['device_ms_per_frame']:.3f} ms/frame; "
          f"{len(events_r) / CHUNK:.1f} device events per frame; largest by device "
          f"ms/frame: {largest_kernels(events_r, CHUNK, 8)} ({card})", flush=True)
    print(f"fisheye: searched fraction {fused_r['searched_frame_fraction']}; graph capture {fused_r['graph']['capture_s']:.3f} s, pool "
          f"{fused_r['graph']['pool_bytes']} bytes; host ms/frame {json.dumps(fused_r['host_ms_per_frame'])} "
          f"({card})", flush=True)

    # ---- 8. filter modes: the template config's switches, fused ----------
    import copy

    cfg_t = template_config()
    # the KLT wrapper counts the eager warm-ups before the frame step's capture
    K.klt_track_pyramid.launches = 0
    state_a, dense = run_dataset(reader, cfg_t, device="cuda", chunk_size=CHUNK, limit_frames=2 * CHUNK,
                                 dtype=torch.float64, profile_dir=DENSE_PROFILE_DIR, profile_chunk=1)
    launches_a = K.klt_track_pyramid.launches
    _, cpu_a = run_dataset(reader, cfg_t, device="cpu", chunk_size=1, limit_frames=MODE_FRAMES)
    check_run("modes (a) dense f64", state_a, dense, frames=2 * CHUNK)
    if state_a.Sigma.dtype != torch.float64 or settings_from_config(cfg_t).sqrt_covariance or \
            launches_a != WARMUP_STEPS + COST_STEPS:
        fail(f"modes (a): Sigma {state_a.Sigma.dtype}, KLT wrapper {launches_a} eager launches (expected the "
             f"{WARMUP_STEPS} warm-ups before capture and the {COST_STEPS} counted step)")
    n = MODE_FRAMES
    if not np.array_equal(dense["feature_ids"][:n], cpu_a["feature_ids"][:n]):
        fail("modes (a): tracked ids differ from the cpu float64 run")
    diff_a = float(np.abs(dense["positions"][:n] - cpu_a["positions"][:n]).max())
    if not np.isfinite(diff_a) or diff_a > FUSED_TOL_M:
        fail(f"modes (a): max position difference to the cpu float64 run {diff_a} m (limit {FUSED_TOL_M})")
    klt_note_a = traced_chunk("modes (a)", dense, DENSE_PROFILE_DIR, 1)[-1]
    print(f"modes (a): template config (Euclidean, accurate Riccati, discrete innovation lift, median depth), "
          f"dense float64, fused on cuda over {2 * CHUNK} frames: first {n} frames' ids equal to the cpu float64 "
          f"run, positions within {diff_a:.3g} m; device {dense.get('device_ms_per_frame')} ms/frame; graph "
          f"capture {dense['graph']['capture_s']:.3f} s, pool {dense['graph']['pool_bytes']} bytes; KLT wrapper "
          f"{launches_a} eager warm-ups; traced chunk 1: {klt_note_a} ({card})", flush=True)

    K.klt_track_pyramid.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state_b, sqrt_b = run_dataset(reader, cfg_t, device="cuda", chunk_size=CHUNK, timing=True)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches_b = K.klt_track_pyramid.launches
    check_run("modes (b) square-root f32", state_b, sqrt_b, frames=frames)
    if state_b.Sigma.dtype != torch.float32 or launches_b != WARMUP_STEPS + COST_STEPS:
        fail(f"modes (b): Sigma {state_b.Sigma.dtype}, KLT wrapper {launches_b} eager launches (expected the "
             f"{WARMUP_STEPS} warm-ups before capture and the {COST_STEPS} counted step)")
    gt_pos_b = np.stack([np.interp(sqrt_b["stamps"], gt.stamps, gt.position[:, i]) for i in range(3)], -1)
    rmse_b = umeyama_rmse(sqrt_b["positions"], gt_pos_b)
    ms_b = (wall_b - sqrt_b["setup_s"]) * 1e3 / sqrt_b["frames"]
    print(f"modes (b): template config, float32 square-root, fused on cuda over {sqrt_b['frames']} frames: "
          f"{ms_b:.3f} ms/frame without the {sqrt_b['setup_s']:.2f} s of set-up; device "
          f"{sqrt_b['device_ms_per_frame']} ms/frame; sections {json.dumps(sqrt_b['device_sections_ms'])}; "
          f"{sqrt_b['landmarks']} landmarks; position RMSE {rmse_b:.4f} m (sim(3)-aligned); graph capture "
          f"{sqrt_b['graph']['capture_s']:.3f} s, pool {sqrt_b['graph']['pool_bytes']} bytes ({card})", flush=True)

    for name, patch in (("normal", {"coordinateChoice": "Normal"}), ("discrete", {"useDiscreteStateMatrix": True})):
        cfg_m = copy.deepcopy(cfg_t)
        cfg_m["eqf"]["settings"].update(patch)
        K.klt_track_pyramid.launches = 0
        state_m, run_m = run_dataset(reader, cfg_m, device="cuda", chunk_size=CHUNK, limit_frames=MODE_FRAMES)
        launches_m = K.klt_track_pyramid.launches
        check_run(f"modes (c) {name}", state_m, run_m, frames=MODE_FRAMES)
        if launches_m != WARMUP_STEPS + COST_STEPS:
            fail(f"modes (c) {name}: KLT wrapper {launches_m} eager launches (expected the {WARMUP_STEPS} "
                 f"warm-ups before capture and the {COST_STEPS} counted step)")
        print(f"modes (c): template config with {json.dumps(patch)}, float32 square-root, fused on cuda over "
              f"{MODE_FRAMES} frames: finite and healthy, {run_m['landmarks']} landmarks; device "
              f"{run_m.get('device_ms_per_frame')} ms/frame; graph capture {run_m['graph']['capture_s']:.3f} s, "
              f"pool {run_m['graph']['pool_bytes']} bytes ({card})", flush=True)

    # ---- 9. simulation: the eqvio_sim runner as a captured frame step -------
    est_sim_b = phase_sim(dev, card)

    # ---- 10. the MH_03 proxy, fused, float32 -------------------------------
    mh = phase_mh03(mh03, cfg_mh03, mh03_build_s, card)

    # ---- 11. the tracker-inclusive sequence batch ----------------------------
    bt = phase_batch(card)

    # ---- 12. the file path: trees, app.batch, resume, rosbag ------------------
    fl = phase_files(mh03, cfg_mh03, mh, card)

    # ---- 13. the parallel slice: mesh, sharded runner, sharded update, worker --
    phase_mesh(est_sim_b, card)

    # ---- 14. the public surface: defaults on the card, run_dataset's overrides --
    surface_s = phase_surface(reader, cfg, cpu, state_f, card)

    # ---- 15. the benchmark programs: bench and bench_kernels, each in its process --
    bn = phase_bench(card)
    gate, bk = bn["bench"]["secondary"], bn["kernels"]
    # the gate tracks its 30 detected corners through 4 levels of 752x480, phase 3's pyramid shapes
    gate_bound, gate_bound_by = K.bound_ms(30, [tuple(p.shape) for p in pyr0], win, iters)
    print(f"smoke: {time.perf_counter() - t_smoke:.1f} s in all, the surface phase {surface_s:.1f} s, the bench "
          f"phase {bn['s']:.1f} s ({card})", flush=True)

    print(json.dumps({"kernels": [{
        "name": "klt_track_pyramid",
        "route": "cuda",
        "source": "eqvio_tpu_torch/csrc/klt_cuda.cu",
        "replaces": "eqvio_tpu/frontend/pallas_klt.py:106",
        "launches": launches,
        "launches_fused_chunk": len(klt),
        "fused_chunk_frames": CHUNK,
        "launches_fused_warmup": warmup_launches,
        "max_abs_err": max_err,
        "ms": ms_device,
        "graph_replay_ms": ms_klt_graph,
        "device_ms": ms_device,
        "graph_ms": ms_graph,
        "host_ms": ms_host,
        "plain_ms": ms_plain,
        "bound_ms": ms_bound,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "klt_track_pyramid",
        "shape": f"racing: {race['shape']}, equalised",
        "route": "cuda",
        "source": "eqvio_tpu_torch/csrc/klt_cuda.cu",
        "replaces": "eqvio_tpu/frontend/pallas_klt.py:106",
        "launches": launches_r,
        "launches_fused_chunk": len(klt_r),
        "fused_chunk_frames": CHUNK,
        "launches_fused_warmup": warmup_r,
        "max_abs_err": err_race,
        "ms": race["ms"],
        "graph_replay_ms": sum(klt_r) / len(klt_r) / 1e3,
        "graph_ms": race["graph_ms"],
        "plain_ms": race["plain_ms"],
        "bound_ms": race["bound_ms"],
        "bound_by": race["bound_by"],
        "library_ms": None,
    }, {
        "name": "klt_track_pyramid",
        "shape": f"MH_03: {mt['shape']}",
        "route": "cuda",
        "source": "eqvio_tpu_torch/csrc/klt_cuda.cu",
        "replaces": "eqvio_tpu/frontend/pallas_klt.py:106",
        "launches": mh["launches"],
        "launches_fused_chunk": mh["chunk"],
        "fused_chunk_frames": CHUNK,
        "launches_fused_warmup": mh["warmup"],
        "max_abs_err": err_mh03,
        "ms": mt["ms"],
        "graph_replay_ms": mh["graph_replay_ms"],
        "graph_ms": mt["graph_ms"],
        "plain_ms": mt["plain_ms"],
        "bound_ms": mt["bound_ms"],
        "bound_by": mt["bound_by"],
        "library_ms": None,
    }, {
        "name": "klt_track_pyramid",
        "shape": f"MH_03 from files through app.batch: {mt['shape']}",
        "route": "cuda",
        "source": "eqvio_tpu_torch/csrc/klt_cuda.cu",
        "replaces": "eqvio_tpu/frontend/pallas_klt.py:106",
        "launches": fl["launches"],
        "graph_launches": fl["replays"],
        "frames": fl["frames"],
        "klt_per_graph_launch": 1,  # phase 10's traced chunk of the same graph
        "decoder": fl["decoder"],
        "max_abs_err": err_mh03,
        "ms": mt["ms"],
        "graph_replay_ms": mh["graph_replay_ms"],
        "graph_ms": mt["graph_ms"],
        "plain_ms": mt["plain_ms"],
        "bound_ms": mt["bound_ms"],
        "bound_by": mt["bound_by"],
        "library_ms": None,
    }, {
        "name": "klt_track_pyramid",
        "shape": f"sequence batch: {lanes_t['shape']}, one launch",
        "route": "cuda",
        "source": "eqvio_tpu_torch/csrc/klt_cuda.cu",
        "replaces": "eqvio_tpu/frontend/pallas_klt.py:106",
        "launches": bt["launches"],
        "launches_batch_window": bt["chunk"],
        "batch_window_frames": bt["window"],
        "max_abs_err": err_lanes,
        "ms": lanes_t["ms"],
        "graph_replay_ms": bt["graph_replay_ms"],
        "graph_ms": lanes_t["graph_ms"],
        "host_ms": lanes_t["host_ms"],
        "plain_ms": lanes_t["plain_ms"],
        "bound_ms": lanes_t["bound_ms"],
        "bound_by": lanes_t["bound_by"],
        "library_ms": None,
    }, {
        "name": "klt_track_pyramid",
        "shape": "bench KLT gate: frames 40-41 of the 30 s benchmark tree, 30 corners x 4 levels at 752x480",
        "route": "cuda",
        "source": "eqvio_tpu_torch/csrc/klt_cuda.cu",
        "replaces": "eqvio_tpu/frontend/pallas_klt.py:106",
        "launches": gate["klt_kernel_launches"],
        "max_abs_err": gate["klt_kernel_max_px_diff"],
        "ms": bk["klt_kernel_ms"],  # bench_kernels: graph replays at the same shape
        "plain_ms": bk["klt_plain_ms"],
        "bound_ms": gate_bound,
        "bound_by": gate_bound_by,
        "library_ms": None,
    }, *gate_rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
