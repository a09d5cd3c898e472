"""Per-stage and per-kernel timings: EqF update, propagation window, KLT
tracker, full filter frame, and the single-card batch-scaling curve; the
counterpart of the repository's ``bench_kernels.py``.

    python -m eqvio_tpu_torch.bench_kernels [--device cuda|cpu]

The reference analogue is the timing.csv flamegraph labels
(features/preprocessing/propagation/correction, analyse_timing_data.py:10-17).
Prints one JSON object with ``bench_kernels.py``'s keys; its TPU KLT routes
(``klt_mxu_ms``, ``klt_pallas_ms``) become the CUDA kernel's
(``klt_kernel_ms``) and its plain version's (``klt_plain_ms``), with the
kernel's bound (``klt_bound_ms``) beside them.  A part that raises is
recorded under its error key and the process exits non-zero.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback

import numpy as np
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

SCALING_BATCHES = (1, 8, 32, 128)
SCALING_SECONDS = 10.0


def _time(f, *args, reps=50):
    """ms per call of ``f(*args)`` on the device of ``args``' tensors.

    On the card the call is captured once as a CUDA graph over static
    buffers (``graph.GraphStep``: the inputs copied in, eager warm-ups on a
    side stream, then the capture), and the time is ``reps`` replays, one
    synchronisation, host wall over ``reps``.  On the CPU the plain call is
    timed after one warm-up."""
    tensors, spec = tree_flatten(args)  # every leaf a tensor: states, IMU windows, pyramids

    def call(*xs):
        return f(*tree_unflatten(list(xs), spec))

    dev = tensors[0].device
    if dev.type != "cuda":
        call(*tensors)
        t0 = time.perf_counter()
        for _ in range(reps):
            call(*tensors)
        return (time.perf_counter() - t0) / reps * 1e3
    from .graph import GraphStep

    step = GraphStep(lambda carry, *xs: (carry, call(*xs)), (), tensors, dev)
    step(*tensors)  # copies the inputs in, warms up, captures and replays once
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        step.graph.replay()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) / reps * 1e3


def main(device: str = "cuda") -> int:
    """Time every stage on ``device`` and print the JSON object; returns the
    exit code: 0 when every part ran, else 1."""
    from . import filter as F
    from .frontend import TrackerConfig, build_pyramid, detect_features, tracker_init, tracker_step
    from .kernels import klt as K
    from .runner import default_sim_camera
    from .runtime import configure_runtime
    from .states import IMU

    dev, _ = configure_runtime(device)
    dtype = torch.float32
    settings = F.Settings(
        measurement_noise=0.5, coordinate_choice="invdepth", fast_riccati=True,
        use_discrete_innovation_lift=False, use_median_depth=False,
    )
    suite = settings.suite
    cam = default_sim_camera(dtype, device=dev)
    N, Kw = 32, 12
    rng = np.random.default_rng(0)
    t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731

    pixels = t(rng.uniform(100, 500, size=(N, 2)))
    vis = torch.ones(N, dtype=torch.bool, device=dev)
    ids = torch.arange(N, dtype=torch.int64, device=dev)
    imu_win = IMU(
        stamp=t(np.linspace(0, 0.055, Kw)),
        gyr=t(rng.normal(size=(Kw, 3)) * 0.1),
        acc=t(rng.normal(size=(Kw, 3)) * 0.1 + [0, 0, 9.8]),
        gyr_bias_vel=torch.zeros((Kw, 3), dtype=dtype, device=dev),
        acc_bias_vel=torch.zeros((Kw, 3), dtype=dtype, device=dev),
    )
    dts = torch.full((Kw,), 0.005, dtype=dtype, device=dev)

    def filter_times(s: F.Settings) -> tuple[float, float, float]:
        state = F.add_landmarks(F.init_state(s, N, dtype, dev), pixels, vis, ids, cam, s)
        upd = lambda st, p, v: F.update_vision(st, p, v, cam, s, suite)  # noqa: E731
        prop = lambda st, w, d: F.propagate_window(st, w, d, s, suite)  # noqa: E731
        full = lambda st, w, d, p, v, i: F.process_vision(  # noqa: E731
            F.propagate_window(st, w, d, s, suite), p, v, i, cam, s, suite)
        return (round(_time(upd, state, pixels, vis), 4), round(_time(prop, state, imu_win, dts), 4),
                round(_time(full, state, imu_win, dts, pixels, vis, ids), 4))

    results: dict = {}
    (results["eqf_update_ms_per_frame"], results["propagation_window_ms_per_frame"],
     results["full_filter_frame_ms"]) = filter_times(settings)

    # square-root covariance mode (the production float32 numerics: QR-based
    # propagate + Kailath array update, what every card run executes)
    (results["sqrt_eqf_update_ms_per_frame"], results["sqrt_propagation_window_ms_per_frame"],
     results["sqrt_full_filter_frame_ms"]) = filter_times(dataclasses.replace(settings, sqrt_covariance=True))

    # tracker on a VGA-class frame
    tcfg = TrackerConfig(max_features=30, win_size=21, max_level=3, max_error=1e8)
    img = t(rng.uniform(0, 1, size=(480, 752)), torch.float32)
    step = lambda tr, im: tracker_step(tr, im, tcfg)  # noqa: E731
    trk = step(tracker_init(tcfg, (480, 752), dev), img)  # populate
    results["tracker_ms_per_frame"] = round(_time(step, trk, img, reps=20), 4)

    # sub-components
    det = lambda im, ex, em: detect_features(im, 30, min_dist=tcfg.feature_dist, exclude=ex,  # noqa: E731
                                             exclude_mask=em)
    results["detector_ms"] = round(_time(det, img, trk.positions, trk.mask, reps=20), 4)
    results["pyramid_ms"] = round(_time(lambda im: build_pyramid(im, 4), img, reps=20), 4)

    # the KLT: the CUDA kernel (on the CPU its wrapper runs the plain
    # version) and its plain version on the same pyramid and tracks
    pyr = build_pyramid(img, 4)
    try:
        pos = trk.positions.contiguous()
        results["klt_plain_ms"] = round(_time(lambda p: K.klt_track_pyramid_plain(pyr, pyr, p, p, 21, 8), pos,
                                              reps=20), 4)
        results["klt_kernel_ms"] = round(_time(lambda p: K.klt_track_pyramid(pyr, pyr, p, p, 21, 8), pos,
                                               reps=20), 5)
        bound, bound_by = K.bound_ms(len(pos), [tuple(p.shape) for p in pyr], 21, 8)
        results["klt_bound_ms"] = round(bound, 6)
        results["klt_bound_by"] = bound_by
    except Exception as e:  # noqa: BLE001 — the JSON line must still print
        traceback.print_exc()
        results["klt_kernel_error"] = f"{type(e).__name__}: {e}"

    # single-card batch scaling: aggregate filter fps over B concurrent sequences
    try:
        from .runner import build_sim_runner, prepare_sim_inputs

        inputs = prepare_sim_inputs(settings, capacity=N, max_features=30, end_time=SCALING_SECONDS,
                                    imu_freq=200.0, frame_freq=20.0, num_walls=4, dtype=dtype)
        curve = {}
        for B in SCALING_BATCHES:
            run_b = build_sim_runner(settings, inputs, augment_true_landmarks=False, compute_nees=False,
                                     batch=(B if B > 1 else None), device=device)
            res_b = run_b()  # captures the frame step on the card
            n_frames = int(res_b.times.shape[0])
            best = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                res_b = run_b()  # ends in a synchronisation and the outputs' copy to the host
                best = min(best, time.perf_counter() - t0)
            if not bool(torch.isfinite(res_b.est_position).all()):
                raise FloatingPointError(f"non-finite positions at B = {B}")
            curve[str(B)] = round(B * n_frames / best, 3)
        results["batch_scaling_fps"] = curve
    except Exception as e:  # noqa: BLE001
        traceback.print_exc()
        results["batch_scaling_error"] = f"{type(e).__name__}: {e}"

    from .bench import _chip_peaks

    results["device_kind"] = _chip_peaks(device)[0]
    print(json.dumps(results), flush=True)
    return 1 if any(k.endswith("_error") for k in results) else 0


def _args(argv=None):
    ap = argparse.ArgumentParser(description="bench_kernels.py's timings for the PyTorch / CUDA port")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="cuda (the default) runs on the card and raises without one; cpu runs the plain versions")
    return ap.parse_args(argv)


if __name__ == "__main__":
    sys.exit(main(_args().device))
