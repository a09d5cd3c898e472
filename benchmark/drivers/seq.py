"""``run_dataset`` passes over the scene cut, closed loop, each writing its
CSVs and saving one checkpoint at a frame drawn from the seed."""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from benchmark import reference, tracing
from benchmark.convert import cast, to_frozen
from benchmark.drivers import Driver, tracker_rows
from benchmark.scene import build_scene, scene_params


class SeqDriver(Driver):
    def setup(self):
        from eqvio_tpu_torch.app.run_opt import run_dataset

        self.run_dataset = run_dataset
        self.lag = reference.camera_lag(self.config)
        self.scene = build_scene(scene_params(self.cfg), self.seed, self.dev, lag=self.lag)
        self.T = len(self.scene.images.stamps)
        C = self.mix["chunk_size"]
        # one save per pass: the first chunk boundary after ckpt_every frames, and 2 x ckpt_every > T
        lo, hi = int(self.T * 0.55) // C, int((self.T - self.mix["check_frames"]) * 0.95) // C
        self.ckpt_every = int(self.rng.integers(lo, hi + 1)) * C
        self.pass_dir = os.path.join(self.out_dir, "pass")
        self.ckpt = os.path.join(self.pass_dir, "checkpoint.npz")
        with self.spans.span("warmup", frames=self.mix["warmup_frames"]):
            self._pass(self.mix["warmup_frames"], os.path.join(self.out_dir, "warmup"), every=C)

    def _pass(self, limit, out, every=None):
        # a reader object takes the configuration's camera lag only as an argument
        return self.run_dataset(self.scene, self.config, chunk_size=self.mix["chunk_size"], dtype=self.dtype,
                                device=str(self.dev), output_dir=out, limit_frames=limit,
                                checkpoint_every=every or self.ckpt_every,
                                checkpoint_path=os.path.join(out, "checkpoint.npz"), camera_lag=self.lag)

    def window(self, seconds: float):
        t0 = time.perf_counter()
        sums, n_pass, self.summary = {}, 0, None
        while True:
            with self.spans.span("pass", frames=self.T) as sp:
                self.attempted += self.T
                try:
                    _, summary = self._pass(None, self.pass_dir)
                except Exception as e:  # noqa: BLE001 — a pass that raises counts its frames failed
                    sp["error"] = f"{type(e).__name__}: {e}"
                    self.failed += self.T
                    summary = None
            if summary is not None:
                sp.update({k: summary.get(k) for k in ("setup_s", "host_ms_per_frame", "device_ms_per_frame",
                                                        "fetch_ms_per_frame", "write_ms_per_frame", "graph")})
                bad = int((~np.isfinite(summary["positions"]).all(axis=1)).sum())
                self.failed += bad + (self.T - summary["frames"])
                self.frames_done += summary["frames"]
                self.summary = summary
                n_pass += 1
                sums["pass_setup_s"] = sums.get("pass_setup_s", 0.0) + summary["setup_s"]
                sums["host_ms"] = sums.get("host_ms", 0.0) + sum(summary["host_ms_per_frame"].values()) * \
                    summary["frames"]
            if time.perf_counter() - t0 >= seconds:
                break
        self.wall_s = time.perf_counter() - t0
        if n_pass:
            self.host = {"pass_setup_s": sums["pass_setup_s"] / n_pass,
                         "host_ms_per_frame": sums["host_ms"] / max(self.frames_done, 1)}
        return {"seq_frames_per_s": self.frames_done / self.wall_s}

    def trace(self):
        n, steady = self.mix["trace_frames"], self.mix["trace_steady"]
        self.records = tracing.capture(lambda: self._pass(n, os.path.join(self.out_dir, "traced")))
        self.view = tracing.steady(self.records, steady)
        self.trace_frames, self.trace_lanes = steady, 1

    def _program_rows(self, k0: int, S: int) -> dict:
        """Frames ``k0 .. k0 + S`` of the last pass: positions from its
        summary, tracked ids and pixels from its ``features.csv``."""
        N = self.config["GIFT"]["maxFeatures"]
        ids, px = np.full((S, N), -1, dtype=np.int64), np.zeros((S, N, 2))
        with open(os.path.join(self.pass_dir, "features.csv")) as f:
            lines = f.readlines()[1:]
        for r, line in enumerate(lines[k0:k0 + S]):
            vals = [v.strip() for v in line.split(",")[1:] if v.strip()]
            for j in range(0, len(vals), 3):
                ids[r, j // 3] = int(vals[j])
                px[r, j // 3] = float(vals[j + 1]), float(vals[j + 2])
        return {"position": self.summary["positions"][k0:k0 + S], "ids": ids, "pixels": px}

    def _stretches(self):
        """From the start of the last pass, and from its checkpoint (the
        program's own state there; the tracker's pyramid is worked out again
        from the frame before)."""
        from eqvio_tpu_torch.checkpoint import load_checkpoint

        if self.summary is None:
            return None
        frames = torch.from_numpy(self.scene.host_frames)
        S0, S = self.mix["start_frames"], self.mix["check_frames"]
        K = reference.imu_window_size(self.scene)
        first, feed = reference.frame_feed(self.scene, self.T, K, self.lag)
        shape = tuple(self.scene.host_frames.shape[1:])
        p_state, p_trk, cursor, _ = load_checkpoint(self.ckpt, None, "cpu")  # in the dtype it was saved in
        k = int(cursor["frames"])

        def start(precision, dev):
            step = reference.FrameStep(self.config, self.scene, self.dtype, precision, dev, self.dev)
            state, trk = reference.initial_state(step.settings, step.tcfg, first, shape, step.dtype, dev, step.front)
            return tracker_rows(step.run(state, trk, frames, feed[:S0]))

        def mid(precision, dev):
            step = reference.FrameStep(self.config, self.scene, self.dtype, precision, dev, self.dev)
            state = to_frozen(p_state, cast(step.dtype, dev))
            trk = to_frozen(p_trk, lambda t: t.to(step.front))
            trk = trk._replace(pyramid=reference.pyramid_of(frames[feed[k - 1][0]].to(step.front), step.tcfg))
            return tracker_rows(step.run(state, trk, frames, feed[k:k + S]))

        return [(start, self._program_rows(0, S0)), (mid, self._program_rows(k, S))]


DRIVER = SeqDriver
