"""Benchmark of the port: single-sequence FULL-FRAME throughput (tracker +
filter) on one card, the counterpart of the repository's ``bench.py``.

    python -m eqvio_tpu_torch.bench [--device cuda|cpu]

Prints ONE JSON line in ``bench.py``'s schema:
``{"metric", "value", "unit", "vs_baseline", "baseline_assumed",
"value_spread", "healthy", "secondary"}``.

Headline metric: frames/s of the real-data pipeline on a hermetic
EuRoC-scale ASL tree (752x480 frames, 200 Hz IMU, 20 Hz vision, 30
features) read from files: dataset reader + decoding thread + fused
tracker-and-filter frame step (one CUDA graph replayed per frame) + CSV
writer, timed as whole ``run_dataset`` calls, each of which captures its own
graph (``secondary.capture_s``).

Secondary fields:
- the run's decomposition (device, dispatch, fetch, write and host ms per
  frame, the decoder) and the counted work of one frame step against the
  card's published float32 and memory peaks (``fused_*``);
- ``klt_kernel_max_px_diff`` / ``klt_kernel_masks_equal``: the CUDA KLT
  kernel against its plain version on frames 40 and 41 of the tree;
- ``full_frame_batch_*``: BENCH_FF_BATCH tracker-inclusive pipelines in one
  vmapped frame step (``app.run_opt.bench_batch_full_frame``);
- ``filter_only_fps`` and ``sim_batch_aggregate_fps``: the simulation
  runner (vision precomputed, no tracker), one sequence and BENCH_BATCH
  lanes, with the lanes' counted work against the peaks (``batch_*``).

``REFERENCE_FPS = 500`` is ``bench.py``'s assumption (the reference commits
no timing numbers), flagged by ``baseline_assumed``.

A part that raises is recorded in the line under its error key (``error``,
``batch_full_frame_error``, ``klt_gate_error``, ``full_frame_error``); the
line still prints last, and the process then exits non-zero, as it does
when ``healthy`` is false.  On ``cuda`` nothing falls back to the CPU or to
the plain KLT.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import numpy as np
import torch

REFERENCE_FPS = 500.0  # assumed; the reference commits no timing numbers
# the tree lives in the checkout's git-ignored build/ directory
BENCH_DATASET = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build",
                             "eqvio_bench_asl_torch")
BENCH_SECONDS = 30.0
SIM_SECONDS = 30.0  # the simulation runner's sequence
KLT_FRAMES = (40, 41)  # the gate's frame pair
KLT_WIN, KLT_ITERS = 21, 8
KLT_TOL_PX = 2e-4

# Published peaks per card for utilization reporting (NVIDIA's H100 data
# sheet): float32 FLOP/s on the CUDA cores and HBM bytes/s.  The shares are
# taken against the float32 peak, not a tensor-core peak: the port pins TF32
# off (runtime.configure_runtime), so its matmuls run on the CUDA cores.
CHIP_PEAKS = {  # substring of torch.cuda.get_device_name() -> (peak TFLOP/s, peak HBM GB/s)
    "H100 80GB HBM3": (66.9, 3352.0),  # SXM5
    "H100 PCIe": (51.2, 2039.0),
}


def _card_line(index: int) -> str:
    """``nvidia-smi``'s "name, power limit" line of card ``index``."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()
    return out[index].strip()


def _chip_peaks(device: str = "cuda"):
    """``(device_kind, (peak TFLOP/s, peak GB/s) or None)``; on the card
    ``device_kind`` is the card's name and power limit as ``nvidia-smi``
    prints them."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu", None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    name = torch.cuda.get_device_name(index)
    kind = _card_line(index)
    for key, peaks in CHIP_PEAKS.items():
        if key in name:
            return kind, peaks
    return kind, None


def _utilization(flops_per_s, bytes_per_s, device: str = "cuda"):
    """(mfu_pct, hbm_util_pct, device_kind) from achieved rates."""
    kind, peaks = _chip_peaks(device)
    if peaks is None:
        return None, None, kind
    peak_f, peak_b = peaks
    return (
        round(100.0 * flops_per_s / (peak_f * 1e12), 4),
        round(100.0 * bytes_per_s / (peak_b * 1e9), 4),
        kind,
    )


def _ensure_dataset():
    """Generate (once) a hermetic EuRoC-scale ASL tree for the bench: the
    JAX bench's scene, written by the port's generator."""
    marker = os.path.join(BENCH_DATASET, ".complete_v3")
    if os.path.exists(marker):
        return
    import shutil

    from .data import generate_asl_dataset

    shutil.rmtree(BENCH_DATASET, ignore_errors=True)
    generate_asl_dataset(
        BENCH_DATASET,
        end_time=BENCH_SECONDS,
        imu_freq=200.0,
        frame_freq=20.0,
        width=752,
        height=480,
        num_points=600,
        seed=4,
        kind="room",  # stationary start: the filter self-init assumes rest
    )
    with open(marker, "w") as f:
        f.write("ok\n")


def bench_full_frame(dtype, device: str = "cuda"):
    """Single-sequence full-frame fps: reader -> decoding thread -> fused
    tracker+filter frame step -> writer, the ``run_dataset`` product path,
    one warm-up and BENCH_REPS timed calls.

    Returns ``(median fps, healthy, decomposition)``."""
    import tempfile

    from .app.run_opt import run_dataset
    from .io import bench_config

    _ensure_dataset()
    cfg = bench_config()
    chunk = int(os.environ.get("BENCH_CHUNK", "16"))

    def once():
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            _, summary = run_dataset(BENCH_DATASET, cfg, output_dir=out, dtype=dtype, chunk_size=chunk,
                                     device=device)
            return summary, time.perf_counter() - t0

    once()  # warm-up: kernel build, library handles, allocator
    reps = max(3, int(os.environ.get("BENCH_REPS", "5")))
    times, summary = [], {}
    for _ in range(reps):
        summary, dt = once()
        times.append(dt)
    n_frames = max(summary["frames"], 1)
    fps_reps = sorted(n_frames / t for t in times)
    best = min(times)
    decomp = {
        "chunk_size": chunk,
        "fps_reps": [round(v, 3) for v in fps_reps],
        "device_ms_per_frame": summary.get("device_ms_per_frame"),
        "dispatch_ms_per_frame": summary.get("dispatch_ms_per_frame"),
        "fetch_ms_per_frame": summary.get("fetch_ms_per_frame"),
        "write_ms_per_frame": summary.get("write_ms_per_frame"),
        "wall_ms_per_frame": round(best * 1e3 / n_frames, 3),
        "searched_frame_fraction": summary.get("searched_frame_fraction"),
        "host_ms_per_frame": summary.get("host_ms_per_frame"),
        # every timed call captures its own graph (set-up inside the timed wall)
        "capture_s": (summary.get("graph") or {}).get("capture_s"),
        "decoder": summary.get("decoder"),
    }
    # utilization of the fused frame step (counted work / device time)
    if summary.get("achieved_gflops"):
        dev_s = summary["device_ms_per_frame"] * 1e-3
        mfu, hbm, _ = _utilization(summary["flops_per_frame"] / dev_s, summary["hbm_bytes_per_frame"] / dev_s,
                                   device)
        decomp["fused_achieved_gflops"] = round(summary["achieved_gflops"], 3)
        decomp["fused_achieved_hbm_gbps"] = round(summary["achieved_hbm_gbps"], 3)
        decomp["fused_mfu_pct"] = mfu
        decomp["fused_hbm_util_pct"] = hbm
    decomp["device_kind"] = _chip_peaks(device)[0]
    fps_median = float(np.median(fps_reps))
    decomp["fps_median"] = round(fps_median, 3)
    decomp["fps_best"] = round(n_frames / best, 3)
    return fps_median, bool(summary.get("healthy", False)), decomp


def _card_name(kind: str) -> str:
    return kind.split(",")[0].strip().lower()


def _prior_round_best(device_kind: str):
    """Best committed headline value from previous rounds' BENCH_r*.json
    measured on the same card (its ``secondary.device_kind`` names
    ``device_kind``'s card), or None."""
    import glob

    best = None
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for path in glob.glob(os.path.join(here, "BENCH_r*.json")):
        try:
            with open(path) as f:
                rec = json.load(f)
            if rec.get("value") is None and isinstance(rec.get("tail"), str):
                # the round records wrap the bench line inside a "tail" string
                for line in rec["tail"].splitlines():
                    line = line.strip()
                    if line.startswith("{") and '"value"' in line:
                        rec = json.loads(line)
            if rec.get("metric") != "full_frame_fps_single_seq":
                continue
            kind = (rec.get("secondary") or {}).get("device_kind")
            if not isinstance(kind, str) or _card_name(kind) != _card_name(device_kind):
                continue
            v = rec.get("value")
            if isinstance(v, (int, float)) and (best is None or v > best):
                best = float(v)
        except (OSError, ValueError, AttributeError):  # a malformed record shouldn't kill the bench
            continue
    return best


def _klt_gate_case(device):
    """Frames 40 and 41 of the tree as bench.py's gate reads them: 4-level
    pyramids of both and 30 corners detected on the first,
    ``(pyr0, pyr1, positions [30, 2], mask [30])`` on ``device``."""
    import glob

    from PIL import Image

    from .frontend.detector import detect_features
    from .frontend.pyramid import build_pyramid

    files = sorted(glob.glob(os.path.join(BENCH_DATASET, "mav0/cam0/data/*.png")))
    f0, f1 = (torch.as_tensor(np.asarray(Image.open(files[i]), dtype=np.float32) / 255.0, device=device)
              for i in KLT_FRAMES)
    pts, mask = detect_features(f0, 30, min_dist=20)
    return build_pyramid(f0, 4), build_pyramid(f1, 4), pts, mask


def _klt_gate_track(track, pyr0, pyr1, pts, mask):
    """``track`` (the kernel's wrapper or its plain version) from ``pts``,
    gated as the tracker gates it: ``(positions [N, 2], tracked [N])``."""
    from .frontend.klt import tracked_mask

    pos, err = track(pyr0, pyr1, pts, pts, KLT_WIN, KLT_ITERS)
    return pos, tracked_mask(pos, err, mask, pyr0[0].shape, KLT_WIN)


def _klt_gate(device: str = "cuda"):
    """On-card equality gate for the CUDA KLT kernel: on a bench-scene frame
    pair it must match its plain version to within 2e-4 px over the features
    both track, with equal tracked masks (``chip_smoke.py``'s criterion).
    Returns ``(fields, ok)``, the fields for the line and the verdict, or
    ``(None, True)`` off the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None, True
    from .kernels import klt as K

    case = _klt_gate_case(dev)
    n0 = K.klt_track_pyramid.launches
    pos_k, ok_k = _klt_gate_track(K.klt_track_pyramid, *case)
    torch.cuda.synchronize(dev)
    launches = K.klt_track_pyramid.launches - n0
    pos_p, ok_p = _klt_gate_track(K.klt_track_pyramid_plain, *case)
    both = ok_k & ok_p
    diff = float((pos_k - pos_p).abs()[both].max()) if bool(both.any()) else float("nan")
    equal = bool(torch.equal(ok_k, ok_p))
    fields = {
        "klt_kernel_max_px_diff": diff,
        "klt_kernel_masks_equal": equal,
        "klt_kernel_tracked": int(both.sum()),
        "klt_kernel_launches": launches,
    }
    return fields, bool(equal and diff <= KLT_TOL_PX and launches == 1)


def _failed(secondary: dict, key: str, e: Exception) -> None:
    """Record a part's exception under ``key`` and its traceback on stderr."""
    traceback.print_exc()
    secondary[key] = f"{type(e).__name__}: {e}"


def _finite(x) -> bool:
    """Every number in a JSON-like value is finite."""
    if isinstance(x, dict):
        return all(_finite(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return all(_finite(v) for v in x)
    return not isinstance(x, float) or math.isfinite(x)


def main(device: str = "cuda") -> int:
    """Run the bench on ``device`` and print its line; returns the exit code:
    0 when every part ran and the run is healthy, else 1."""
    from . import filter as F
    from .runner import build_sim_runner, prepare_sim_inputs
    from .runtime import configure_runtime

    # TF32 off, float32 matmuls at full precision (the filter math needs them)
    dev, _ = configure_runtime(device)
    # BENCH_DTYPE=f64 runs the reference-parity numerics (C++ double)
    dtype = torch.float64 if os.environ.get("BENCH_DTYPE") == "f64" else torch.float32
    errors = ("error", "batch_full_frame_error", "klt_gate_error", "full_frame_error")

    # ---- headline: tracker-inclusive single-sequence full-frame rate ----
    secondary: dict = {}
    full_frame_fps, healthy = None, False
    try:
        full_frame_fps, healthy, decomp = bench_full_frame(dtype, device)
        secondary.update(decomp)
    except Exception as e:  # noqa: BLE001 — the line must still print
        _failed(secondary, "full_frame_error", e)

    # the CUDA KLT kernel against its plain version on the card
    try:
        gate, gate_ok = _klt_gate(device)
        if gate is not None:
            secondary.update(gate)
            healthy = healthy and gate_ok
    except Exception as e:  # noqa: BLE001
        _failed(secondary, "klt_gate_error", e)

    # regression-aware health: the median headline must stay within 20% of
    # the best committed prior round on the same card
    prior = _prior_round_best(secondary.get("device_kind", _chip_peaks(device)[0]))
    if prior and full_frame_fps is not None:
        secondary["prior_round_best_fps"] = prior
        perf_ok = full_frame_fps >= 0.80 * prior
        secondary["perf_vs_prior_ok"] = bool(perf_ok)
        healthy = healthy and perf_ok

    # ---- tracker-INCLUSIVE multi-sequence aggregate ----
    try:
        B_ff = int(os.environ.get("BENCH_FF_BATCH", "8"))
        if B_ff > 1:
            from .app.run_opt import bench_batch_full_frame
            from .io import bench_config

            _ensure_dataset()
            secondary.update(bench_batch_full_frame(
                BENCH_DATASET, bench_config(), B_ff, dtype=dtype,
                limit_frames=int(os.environ.get("BENCH_FF_FRAMES", "224")),
                chunk_size=int(os.environ.get("BENCH_FF_CHUNK", "32")), device=device,
            ))
            healthy = healthy and secondary.get("full_frame_batch_finite", True)
    except Exception as e:  # noqa: BLE001
        _failed(secondary, "batch_full_frame_error", e)

    # ---- secondary: filter-only + batch aggregate on the sim pipeline ----
    # algorithm switches of the reference's shipped EuRoC config (InvDepth,
    # fastRiccati, continuous innovation lift)
    try:
        settings = F.Settings(
            measurement_noise=0.5,
            coordinate_choice="invdepth",
            fast_riccati=True,
            use_discrete_innovation_lift=False,
            use_median_depth=False,
            initial_scene_depth=2.5,
        )
        inputs = prepare_sim_inputs(settings, capacity=32, max_features=30, end_time=SIM_SECONDS,
                                    imu_freq=200.0, frame_freq=20.0, num_walls=4, dtype=torch.float32)
        run = build_sim_runner(settings, inputs, augment_true_landmarks=False, compute_nees=False,
                               device=device)
        res = run()  # captures the frame step on the card
        n_frames = int(res.times.shape[0])
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            res = run()  # ends in a synchronisation and the outputs' copy to the host
            best = min(best, time.perf_counter() - t0)
        secondary["filter_only_fps"] = round(n_frames / best, 3)
        if not bool(torch.isfinite(res.est_position).all()):
            raise FloatingPointError("non-finite positions in the filter-only run")

        B = int(os.environ.get("BENCH_BATCH", "128"))
        if B > 1:
            run_b = build_sim_runner(settings, inputs, augment_true_landmarks=False, compute_nees=False,
                                     batch=B, device=device)
            res_b = run_b()
            best_b = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                res_b = run_b()
                best_b = min(best_b, time.perf_counter() - t0)
            if not bool(torch.isfinite(res_b.est_position).all()):
                raise FloatingPointError("non-finite positions in the batched run")
            secondary["sim_batch_aggregate_fps"] = round(B * n_frames / best_b, 3)
            ca = run_b.cost_analysis()
            if ca and ca.get("flops"):
                flops_s = float(ca["flops"]) / best_b
                bytes_s = float(ca.get("bytes accessed", 0.0)) / best_b
                mfu, hbm, _kind = _utilization(flops_s, bytes_s, device)
                secondary["batch_achieved_gflops"] = round(flops_s / 1e9, 3)
                secondary["batch_achieved_hbm_gbps"] = round(bytes_s / 1e9, 3)
                secondary["batch_mfu_pct"] = mfu
                secondary["batch_hbm_util_pct"] = hbm
    except Exception as e:  # noqa: BLE001
        _failed(secondary, "error", e)

    value = None if full_frame_fps is None else round(full_frame_fps, 3)
    out = {
        "metric": "full_frame_fps_single_seq",
        "value": value,  # MEDIAN of BENCH_REPS timed runs
        "unit": "frames/s",
        "vs_baseline": None if value is None else round(full_frame_fps / REFERENCE_FPS, 4),
        "baseline_assumed": True,
        "value_spread": {
            "min": secondary.get("fps_reps", [None])[0],
            "max": secondary.get("fps_reps", [None])[-1],
            "reps": len(secondary.get("fps_reps", [])),
        },
        "healthy": bool(healthy and _finite(secondary)),
        "secondary": secondary,
    }
    print(json.dumps(out), flush=True)
    return 0 if out["healthy"] and not any(k in secondary for k in errors) else 1


def _args(argv=None):
    ap = argparse.ArgumentParser(description="bench.py's line for the PyTorch / CUDA port")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="cuda (the default) runs on the card and raises without one; cpu runs the plain versions")
    return ap.parse_args(argv)


if __name__ == "__main__":
    sys.exit(main(_args().device))
