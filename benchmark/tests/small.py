"""Cells of the benchmark cut to a size the CPU tests can hold: a 320x240
scene of a few seconds, small chunks and few lanes.  The real limits stay."""

from __future__ import annotations

from benchmark.run import Cell

SMALL_MIX = {
    "seq": dict(warmup_frames=16, start_frames=8, check_frames=8, chunk_size=8, trace_frames=24, trace_steady=16),
    "batch": dict(lanes=2, chunk_size=8, start_frames=6, check_frames=8, check_chunk_lo=1, check_chunk_hi=2),
}
# seconds of scene and of window that let each small cell reach its check
SMALL_TIMES = {"seq": (3.0, 1.0), "batch": (3.0, 10.0)}


def small_cell(workload: str) -> Cell:
    cell = Cell(workload)
    sc = cell.cfg["scene"]
    fx, fy, cx, cy = sc["intrinsics"]
    s = 160.0 / cx  # the principal point to the centre of a 320x240 frame
    sc.update(width=320, height=240, num_points=400, intrinsics=[fx * s, fy * s, 160.0, 120.0])
    kind = cell.mix["driver"]
    cell.cfg["end_time"] = SMALL_TIMES[kind][0]
    cell.mix.update(SMALL_MIX[kind])
    return cell


def window_seconds(cell: Cell) -> float:
    return SMALL_TIMES[cell.mix["driver"]][1]
