"""Real-data VIO entry point (counterpart of ``eqvio_tpu/app/run_opt.py``,
per-frame loop).

Dataset reader -> tracker (pyramid, KLT kernel, RANSAC gate, gated
detection) -> EqF (one-QR fast-Riccati propagation, square-root vision
update) -> CSV outputs, one frame at a time, eagerly on the chosen device.

Usage:
    python -m eqvio_tpu_torch.app.run_opt <dataset_dir> <config.yaml>
        [--device cuda|cpu] [--output DIR] [--start T] [--stop T] [--timing]

Not ported yet (``ROADMAP.md`` queue 1): the fused chunk runner and its
CUDA-graph capture, per-stage ``--timing`` calibration, checkpoint/resume,
``--simvis``/``--simimu``, feature predictions and the live view.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from .. import filter as F
from ..camera import PinholeCamera, RadTanCamera
from ..data import DataServer, create_dataset_reader
from ..frontend import tracker_init, tracker_step
from ..io import LoopTimer, VIOWriter, load_config, safe_get, settings_from_config, tracker_config_from_config
from ..io.writer import rotation_to_quaternion
from ..runtime import check_finite, configure_runtime, debug_nans
from ..states import IMU

TIMING_LABELS = ["features", "propagation", "preprocessing", "correction", "total vision update",
                 "write output", "total"]


def _build_imu_window(imu_buf, t_prev, stamp, imu_window):
    """The zero-dt-padded IMU window covering ``[t_prev, stamp]``: each
    buffered entry contributes its overlap; returns ``((stamps, gyr, acc,
    dts) numpy arrays, trimmed buffer)``."""
    kept = []
    for j, (ts, gyr, acc) in enumerate(imu_buf):
        t1 = imu_buf[j + 1][0] if j + 1 < len(imu_buf) else stamp
        dt = max(min(t1, stamp) - max(ts, t_prev), 0.0)
        if dt > 0 or not kept:
            kept.append((ts, gyr, acc, dt))
    kept = kept[-imu_window:]
    K = imu_window
    arr_stamp = np.full(K, kept[-1][0] if kept else stamp)
    arr_gyr = np.zeros((K, 3))
    arr_acc = np.zeros((K, 3))
    arr_dt = np.zeros(K)
    for j, (ts, gyr, acc, dt) in enumerate(kept):
        arr_stamp[j] = ts
        arr_gyr[j] = gyr
        arr_acc[j] = acc
        arr_dt[j] = dt
    for j in range(len(kept), K):
        if kept:
            arr_gyr[j] = kept[-1][1]
            arr_acc[j] = kept[-1][2]
    arr_stamp[len(kept):] = stamp
    # entry j covers [t_j, t_{j+1}): it is dead once its successor's stamp <= stamp
    trimmed = [e for j, e in enumerate(imu_buf) if j + 1 >= len(imu_buf) or imu_buf[j + 1][0] > stamp]
    return (arr_stamp, arr_gyr, arr_acc, arr_dt), trimmed


def camera_from_info(info, dtype: torch.dtype, device):
    fx, fy, cx, cy = info.intrinsics
    w, h = info.resolution
    if info.model == "radtan":
        if np.allclose(info.distortion, 0.0):
            return PinholeCamera.create(fx, fy, cx, cy, w, h, dtype=dtype, device=device)
        return RadTanCamera.create(fx, fy, cx, cy, info.distortion, w, h, dtype=dtype, device=device)
    if info.model == "equidistant":
        raise NotImplementedError("the equidistant camera is not ported yet (ROADMAP.md queue 1)")
    return PinholeCamera.create(fx, fy, cx, cy, w, h, dtype=dtype, device=device)


def _setup(reader, config, dtype: torch.dtype, device):
    """Settings (dataset extrinsics override, f32 square-root auto-enable),
    tracker config, camera, initial states and the IMU-window size (the
    dataset's IMU samples per frame with margin; pad entries are zero-dt
    no-ops)."""
    ist, fst = reader.imu.stamps, reader.images.stamps
    if len(ist) > 2 and len(fst) > 2:
        ratio = float(np.median(np.diff(fst)) / np.median(np.diff(ist)))
        imu_window = max(8, (int(np.ceil(ratio * 1.25)) + 6) // 4 * 4)
    else:
        imu_window = 32
    settings = settings_from_config(config)
    tcfg = tracker_config_from_config(config)
    T_BS = reader.camera.T_BS
    settings = dataclasses.replace(
        settings,
        camera_offset_quat=tuple(rotation_to_quaternion(T_BS[:3, :3]).tolist()),
        camera_offset_pos=tuple(T_BS[:3, 3].tolist()),
    )
    explicit = safe_get(config.get("eqf", {}) or {}, "settings:useSqrtCovariance", None, warn=False)
    if dtype == torch.float32 and not settings.sqrt_covariance and explicit is None:
        # f32 cannot factor the tuned configs' covariance spread; carry the factor
        settings = dataclasses.replace(settings, sqrt_covariance=True)
    if settings.use_feature_predictions:
        raise NotImplementedError("feature predictions are not ported yet (ROADMAP.md queue 1)")
    camera = camera_from_info(reader.camera, dtype, device)
    w, h = reader.camera.resolution
    state = F.init_state(settings, tcfg.max_features, dtype, device)
    tracker = tracker_init(tcfg, (h, w), device)
    return settings, tcfg, camera, state, tracker, imu_window


def run_dataset(
    dataset,
    config: dict,
    mode: str = "asl",
    output_dir: str | None = None,
    start: float | None = None,
    stop: float | None = None,
    camera_yaml: str | None = None,
    timing: bool = False,
    device: str = "cuda",
    limit_frames: int | None = None,
):
    """Run the per-frame pipeline; returns ``(final EqFState, summary)``.

    ``dataset`` is a dataset directory (read with ``mode``) or a reader
    object with the ASL reader's interface.  ``start``/``stop`` are offsets
    from the first data stamp.  The summary holds ``frames``, ``fps``,
    ``landmarks``, health flags, and the per-frame ``stamps`` and estimated
    ``positions`` (numpy).  ``device`` is ``"cuda"`` unless the caller asks
    for ``"cpu"``; without a card the CUDA default raises.
    """
    dev, dtype = configure_runtime(device)
    if isinstance(dataset, str):
        camera_lag = float((config.get("main", {}) or {}).get("cameraLag", 0.0))
        reader = create_dataset_reader(mode, dataset, camera_yaml, camera_lag)
    else:
        reader = dataset
    settings, tcfg, camera, state, tracker, imu_window = _setup(reader, config, dtype, dev)
    suite = settings.suite

    first = [s[0] for s in (reader.imu.stamps, reader.images.stamps) if len(s)]
    t0_data = float(min(first)) if first else 0.0
    start = t0_data + start if start and start > 0 else None
    stop = t0_data + stop if stop and stop > 0 else None

    server = DataServer(reader, start_time=start, stop_time=stop)
    writer = VIOWriter(output_dir) if output_dir else None
    loop_timer = LoopTimer(TIMING_LABELS)
    K = imu_window
    zeros_k3 = torch.zeros(K, 3, dtype=dtype, device=dev)

    def as_t(a):
        return torch.as_tensor(a, dtype=dtype).to(dev)

    imu_buf: list = []
    initialised = False
    n_frames = 0
    t_prev_host = -1.0
    stamps, positions = [], []
    t_begin = time.perf_counter()
    for meas in server:
        if meas.kind == "imu":
            gyr, acc = meas.data
            if not initialised:
                state = F.initialize_attitude_from_imu(
                    state, IMU.create(meas.stamp, gyr, acc, dtype=dtype, device=dev)
                )
                initialised = True
            imu_buf.append((meas.stamp, gyr, acc))
            continue
        if not initialised:
            continue
        loop_timer.start_loop()
        loop_timer.start_timing("total")

        loop_timer.start_timing("features")
        img = torch.tensor(meas.data, device=dev).to(torch.float32) * (1.0 / 255.0)  # uint8 frames
        tracker = tracker_step(tracker, img, tcfg)
        pixels = tracker.positions.to(dtype)
        loop_timer.end_timing("features")

        loop_timer.start_timing("propagation")
        t_prev = t_prev_host if t_prev_host >= 0 else float(state.t)
        (w_stamp, w_gyr, w_acc, w_dt), imu_buf = _build_imu_window(imu_buf, t_prev, meas.stamp, K)
        imu_win = IMU(as_t(w_stamp), as_t(w_gyr), as_t(w_acc), zeros_k3, zeros_k3)
        loop_timer.end_timing("propagation")

        loop_timer.start_timing("total vision update")
        state = F.propagate_window(state, imu_win, as_t(w_dt), settings, suite, wide_factor=True)
        state = F.process_vision(state, pixels, tracker.mask, tracker.ids, camera, settings, suite)
        state = state._replace(t=torch.tensor(meas.stamp, dtype=dtype, device=dev))
        t_prev_host = meas.stamp
        loop_timer.end_timing("total vision update")
        if debug_nans():
            check_finite(f"filter state at t={meas.stamp}", state.Sigma, state.X.A.x, state.X.Q.a)

        loop_timer.start_timing("write output")
        est = F.state_estimate(state)
        stamps.append(meas.stamp)
        positions.append(est.sensor.pose.x)
        if writer is not None:
            cpu = lambda t: t.detach().cpu().numpy()  # noqa: E731
            writer.write_states(
                meas.stamp, cpu(est.sensor.pose.R), cpu(est.sensor.pose.x), cpu(est.sensor.velocity),
                cpu(est.sensor.camera_offset.R), cpu(est.sensor.camera_offset.x), cpu(est.sensor.bias),
                landmarks=cpu(est.landmarks), landmark_ids=cpu(est.ids), landmark_mask=cpu(est.mask),
            )
            writer.write_features(meas.stamp, cpu(pixels), cpu(tracker.ids), cpu(tracker.mask))
        loop_timer.end_timing("write output")
        loop_timer.end_timing("total")
        if writer is not None and timing:
            writer.write_timing(*loop_timer.frame_row())

        n_frames += 1
        if limit_frames and n_frames >= limit_frames:
            break

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    elapsed = time.perf_counter() - t_begin
    if writer is not None:
        writer.flush()
    est = F.state_estimate(state)
    health = {k: bool(v) for k, v in F.health_check(state, settings).items()}
    summary = {
        "frames": n_frames,
        "fps": n_frames / max(elapsed, 1e-9),
        "final_position": est.sensor.pose.x.cpu().numpy().tolist(),
        "landmarks": int(est.mask.sum()),
        "nan": health["nan"],
        "sigma_pd": health["sigma_pd"],
        "healthy": health["nan"] is False and health["scales_valid"],
        "stamps": np.asarray(stamps),
        "positions": torch.stack(positions).cpu().numpy() if positions else np.zeros((0, 3)),
    }
    return state, summary


def main(argv=None):
    ap = argparse.ArgumentParser(description="EqVIO (PyTorch / CUDA port) on an ASL dataset")
    ap.add_argument("dataset")
    ap.add_argument("config")
    ap.add_argument("--mode", default="asl")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="cuda (the default) runs the filter in float32 with the CUDA KLT kernel; "
                         "cpu runs it in float64 with the kernel's plain version")
    ap.add_argument("--output", default=None)
    ap.add_argument("--camera", default=None)
    ap.add_argument("--start", type=float, default=None)
    ap.add_argument("--stop", type=float, default=None)
    ap.add_argument("--timing", action="store_true", help="write per-frame host wall times")
    args = ap.parse_args(argv)

    config = load_config(args.config)
    main_cfg = config.get("main", {}) or {}
    if args.start is None and float(main_cfg.get("startTime", 0.0)) > 0:
        args.start = float(main_cfg["startTime"])
    _, summary = run_dataset(
        args.dataset, config, mode=args.mode, output_dir=args.output, start=args.start,
        stop=args.stop, camera_yaml=args.camera, timing=args.timing, device=args.device,
    )
    status = "OK" if summary.get("healthy") else "UNHEALTHY (NaN/scale)"
    print(f"Processed {summary['frames']} frames at {summary['fps']:.1f} fps; "
          f"{summary['landmarks']} landmarks live; filter {status}.")


if __name__ == "__main__":
    main()
