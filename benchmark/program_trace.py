"""The program's own measurement of a seq cell: one instrumented
``run_dataset`` pass with the program's stage stamps and host spans
(``trace=True``), read by the per-layer metrics of ``metrics/`` that the
program times itself.

The pass runs once per driver, at the first metric that reads it, and is
kept on the driver.  It is whole and has the window's settings (the chunk,
the dtype, the camera lag, CSVs and a checkpoint at the driver's
``ckpt_every``), with no profiler running, into ``<out_dir>/instrumented``;
it touches nothing the check or the other metrics read (the driver's
``summary``, ``pass_dir``, ``ckpt``, ``view`` and ``records``).  Its
frames after the first chunk are the stretch: each frame's stamps on the
host clock give its stage times, the stretch's idle share, and the idle
seconds between frames by the host span that covered each gap, written to
``<out_dir>/program_trace.json`` with each stage's share of the step
(which holds where the pace of a whole pass moves every stage at once),
the pass's wall time in parts (:func:`pass_wall`) and, beside it, the mean
wall time of the window's passes.

A driver that lacks what this reads (no seq pass, or a program whose
``run_dataset`` takes no ``trace``) gives None, and so do its metrics.
"""

from __future__ import annotations

import bisect
import inspect
import itertools
import json
import os
import time

import numpy as np

SKIP_CHUNKS = 1  # the stretch starts after the pass's first chunk (its set-up and timing replays)
_UNREAD = object()


def reading(drv) -> dict | None:
    """The instrumented pass's numbers (cached on the driver), or None."""
    got = getattr(drv, "_program_trace", _UNREAD)
    if got is _UNREAD:
        got = _measure(drv)
        try:
            drv._program_trace = got
        except AttributeError:
            pass
    return got


def reader(key: str):
    def read(drv):
        r = reading(drv)
        return None if r is None else r[key]
    return read


def setup_part(*parts: str):
    """The seconds of ``parts`` of the set-up of the window's last pass
    (its summary's ``setup_parts_s``), summed."""
    def read(drv):
        summary = getattr(drv, "summary", None)
        split = None if summary is None else summary.get("setup_parts_s")
        return None if split is None else float(sum(split[p] for p in parts))
    return read


def _measure(drv) -> dict | None:
    run = getattr(drv, "run_dataset", None)
    need = ("scene", "config", "mix", "dtype", "dev", "ckpt_every", "lag", "out_dir")
    if run is None or not all(hasattr(drv, k) for k in need) or "trace" not in inspect.signature(run).parameters:
        return None
    out = os.path.join(drv.out_dir, "instrumented")
    t_call = time.time_ns()  # the host clock of the trace block's spans and stamps
    _, summary = run(drv.scene, drv.config, chunk_size=drv.mix["chunk_size"], dtype=drv.dtype, device=str(drv.dev),
                     output_dir=out, limit_frames=None, checkpoint_every=drv.ckpt_every,
                     checkpoint_path=os.path.join(out, "checkpoint.npz"), camera_lag=drv.lag, trace=True)
    t_return = time.time_ns()
    block = summary.get("trace")
    if block is None:
        return None
    r = stretch(block, SKIP_CHUNKS)
    if r is None:
        return None
    written = {**r, "clock": block["clock"], "pass_frames": len(block["frames"]),
               "pass_idle_by_host_s": block["idle_by_host_s"],
               "stage_share_pct": {k: 100.0 * r[f"{k}_ms_per_frame"] / r["step_ms_per_frame"]
                                   for k in ("frontend", "ransac", "propagation", "update")}}
    if block["clock"].get("host") == "time.time_ns":
        written["pass_wall_s"] = pass_wall(block, t_call, t_return, SKIP_CHUNKS)
    done, wall = getattr(drv, "frames_done", 0), getattr(drv, "wall_s", None)
    if done and wall:
        # the window's untraced passes: its wall time over the passes it completed
        written["window_pass_s"] = wall * len(drv.scene.images.stamps) / done
    with open(os.path.join(drv.out_dir, "program_trace.json"), "w") as f:
        json.dump(written, f, indent=1)
    return r


def pass_wall(block: dict, t_call: int, t_return: int, skip_chunks: int) -> dict:
    """A traced pass's wall time, from the call (``t_call``, host ns) to its
    return (``t_return``), in parts that sum to it: ``before_spans`` (to the
    first span: the configuration, the filter's and the writer's set-up,
    the clock offset), ``setup`` (the ``setup`` span), ``to_first_frame``
    (the rest up to the first frame's begin stamp: the first chunk's feed,
    pack, upload and launch), ``first_chunks`` (to the stretch's first
    begin), ``stretch`` (to the last frame's end), ``drain`` (to the end of
    the last span: the last rows' fetch and CSV write) and ``after_spans``
    (to the return: the summary, the trace block, the writer's close)."""
    col = {name: i for i, name in enumerate(block["frame_fields"])}
    rows = np.asarray(block["frames"], dtype=np.int64)
    first = int(rows[:, col["frame_begin"]].min())
    begin = int(rows[rows[:, col["chunk"]] >= skip_chunks, col["frame_begin"]].min())
    last = int(rows[:, col["frame_end"]].max())
    spans = block["spans"]
    s0, s1 = min(s[1] for s in spans), max(s[2] for s in spans)
    setup = sum(s[2] - s[1] for s in spans if s[0] == "setup")
    parts = {"before_spans": s0 - t_call, "setup": setup, "to_first_frame": first - s0 - setup,
             "first_chunks": begin - first, "stretch": last - begin, "drain": s1 - last, "after_spans": t_return - s1}
    return {"wall": (t_return - t_call) * 1e-9, **{k: v * 1e-9 for k, v in parts.items()}}


def stretch(block: dict, skip_chunks: int) -> dict | None:
    """The metrics of the frames of chunk ``skip_chunks`` on in a ``trace``
    block: mean ms a frame of the step and its stages, the idle share of
    [first begin, last end] outside every frame, and the idle seconds
    between frames labelled by the latest-begun main-thread span covering
    each gap's start (``"none"`` where none does)."""
    col = {name: i for i, name in enumerate(block["frame_fields"])}
    rows = np.asarray([r for r in block["frames"] if r[col["chunk"]] >= skip_chunks], dtype=np.int64)
    if len(rows) < 2:
        return None
    rows = rows[np.argsort(rows[:, col["frame"]])]
    base = rows[0, col["frame_begin"]]

    def t(name):  # ns from the stretch's first begin (epoch ns lose their last digits in float64)
        return (rows[:, col[name]] - base).astype(np.float64)

    begin, end = t("frame_begin"), t("frame_end")
    ms = lambda v: float(np.mean(v)) * 1e-6  # noqa: E731
    window = end[-1] - begin[0]
    gaps = [(a, b) for a, b in zip(end[:-1], begin[1:]) if b > a]
    idle = sum(b - a for a, b in gaps)
    main = sorted(((s[0], s[1] - base, s[2] - base) for s in block["spans"] if s[7] == "main"), key=lambda s: s[1])
    starts = [s[1] for s in main]
    reach = list(itertools.accumulate((s[2] for s in main), max))  # the latest end among spans 0..j
    by_host: dict = {}
    for a, b in gaps:
        label = "none"
        j = bisect.bisect_right(starts, a) - 1
        while j >= 0 and reach[j] >= a:  # a span before j can still cover the gap's start
            if main[j][2] >= a:
                label = main[j][0]
                break
            j -= 1
        by_host[label] = by_host.get(label, 0.0) + (b - a) * 1e-9
    return {
        "frames": int(len(rows)),
        "step_ms_per_frame": ms(end - begin),
        "frontend_ms_per_frame": ms((t("gate_begin") - begin) + (t("tracker_end") - t("gate_end"))),
        "ransac_ms_per_frame": ms(t("gate_end") - t("gate_begin")),
        "propagation_ms_per_frame": ms(t("propagation_end") - t("tracker_end")),
        "update_ms_per_frame": ms(end - t("propagation_end")),
        "step_idle_share": 100.0 * idle / window if window > 0 else None,
        "window_s": window * 1e-9,
        "idle_s": idle * 1e-9,
        "idle_by_host_s": by_host,
    }
