"""Inputs and timers for measuring the KLT kernel on the card.

``chip_smoke.py`` (phase 3) and ``scripts/klt_timing.py`` both measure the
kernel at the main path's shape, taken here once: frames 100 and 101 of the
benchmark scene (752x480, 4-level pyramids, win 21, 8 steps) with the
scene's detected corners (N = 30, guesses = positions), and the same plus
:func:`border_features` (38).  :func:`klt_case` with the racing proxy's
reader and config gives the fisheye shape: equalised 640x480 frames and 40
corners; :func:`klt_lanes_case` the sequence batch's shape: 8 lanes of the
benchmark pair, each with its own pixel noise.  The timers need a CUDA
device; nothing here runs at import.
"""

from __future__ import annotations

import statistics
import time
from typing import NamedTuple

import torch

from ..data import bench_scene, noised_lanes
from ..frontend import build_pyramid, detect_features, equalize_histogram
from ..io import bench_config, tracker_config_from_config

ITERS = 8  # Gauss-Newton steps per level on the main path


def border_features(height: int, width: int) -> list[list[float]]:
    """Eight full-resolution features within 12 px of the borders and corners."""
    return [[6.0, 240.0], [width - 7.0, 100.0], [376.0, 5.0], [300.0, height - 6.0], [10.0, 10.0],
            [width - 11.0, height - 11.0], [8.0, 400.0], [700.0, 8.0]]


class KltCase(NamedTuple):
    pyr0: list
    pyr1: list
    main: torch.Tensor  # [N, 2] detected corners: the main path's shape
    pair: torch.Tensor  # [N + 8, 2] the corners and the border features (the corners alone below 752x480)
    win: int
    iters: int
    max_error: float


def klt_case(device, reader=None, frames: tuple[int, int] = (100, 101), config: dict | None = None,
             spacing: str = "detect") -> KltCase:
    """The frame pair of the benchmark scene (or ``reader``) on ``device``,
    as the tracker of ``config`` (the benchmark's by default) sees it:
    equalised if the config says so, and its ``maxFeatures`` corners
    detected with its quality, spaced as one detection places them
    (``spacing="detect"``: ``featureDist``) or as the tracker keeps its
    live tracks apart (``"tracked"``: ``trackedFeatureDist``; a config whose
    detection spacing admits fewer corners per frame fills its slots over
    several frames, up to this spacing)."""
    reader = bench_scene(8.0) if reader is None else reader
    tcfg = tracker_config_from_config(bench_config() if config is None else config)
    levels, win = tcfg.max_level + 1, tcfg.win_size
    f0, f1 = (torch.tensor(reader.load_image_u8(i), device=device).float() * (1.0 / 255.0) for i in frames)
    if tcfg.equalize_histogram:
        f0, f1 = equalize_histogram(f0), equalize_histogram(f1)
    min_dist = {"detect": tcfg.feature_dist, "tracked": int(tcfg.tracked_feature_dist)}[spacing]
    corners, valid = detect_features(f0, tcfg.max_features, min_dist=min_dist,
                                     quality=tcfg.min_harris_quality, border=win)
    if int(valid.sum()) < tcfg.max_features:
        raise RuntimeError(f"only {int(valid.sum())} corners detected on frame {frames[0]}")
    main = corners[valid].contiguous()
    pair = main
    if f0.shape[1] >= 752:
        pair = torch.cat([main, torch.tensor(border_features(*f0.shape), device=device)]).contiguous()
    return KltCase(build_pyramid(f0, levels), build_pyramid(f1, levels), main, pair, win, ITERS, tcfg.max_error)


def klt_lanes_case(device, reader=None, lanes: int = 8, frames: tuple[int, int] = (100, 101),
                   noise_seed: int = 7) -> KltCase:
    """The benchmark pair as ``lanes`` sequences of the batch of
    ``app.run_opt.bench_batch_full_frame``: each lane the pair with its own
    uint8 pixel noise (:func:`data.noised_lanes`), pyramid levels ``[B, H_l,
    W_l]``, and every lane tracking the clean frame's detected corners
    (positions ``[B, N, 2]``): one batched launch of ``lanes x N`` blocks."""
    reader = bench_scene(8.0) if reader is None else reader
    clean = klt_case(device, reader, frames)
    pair = torch.as_tensor(noised_lanes(torch.stack([torch.as_tensor(reader.load_image_u8(i)) for i in frames]).numpy(),
                                        lanes, noise_seed)).to(device).float() * (1.0 / 255.0)
    levels = len(clean.pyr0)
    pyrs = [[torch.stack(lv) for lv in zip(*[build_pyramid(pair[b, k], levels) for b in range(lanes)])]
            for k in range(2)]
    main = clean.main.expand(lanes, *clean.main.shape).contiguous()
    return KltCase(pyrs[0], pyrs[1], main, main, clean.win, clean.iters, clean.max_error)


def cuda_ms(fn, reps: int = 50) -> float:
    """ms per call from CUDA events around ``reps`` back-to-back calls (for
    the plain version, whose many small kernels this times as a whole)."""
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


def graph_ms(fn, launches: int = 50, replays: int = 20) -> float:
    """Device ms per call: ``launches`` calls captured in one CUDA graph,
    replayed ``replays`` times between CUDA events (no host work between
    launches, so back-to-back kernels and their gaps are what is timed)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * launches)


def profiler_ms(fn, kernel: str, calls: int = 50):
    """Device ms per launch of the kernels whose name holds ``kernel``, from
    ``torch.profiler``'s CUDA activity over ``calls`` calls; None when the
    profiler records no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for ev in prof.key_averages():
        if kernel in ev.key:
            total_us += getattr(ev, "device_time_total", 0.0) or getattr(ev, "cuda_time_total", 0.0)
            count += ev.count
    return total_us / count / 1e3 if count and total_us > 0 else None


def host_ms(fn, calls: int = 100, batches: int = 7) -> float:
    """Host ms per call with no synchronisation between calls (the enqueue
    cost the caller's thread pays): the median over ``batches`` batches, as
    the host's clock is shared with other work."""
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(batches):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        per_call.append((time.perf_counter() - t0) * 1e3 / calls)
        torch.cuda.synchronize()
    return statistics.median(per_call)
