"""``lanes`` noised copies of the scene's frames, resident on the device,
through one ``BatchChunkRunner`` in chunks, the carry reloaded at the
sequence's end."""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import reference, tracing
from benchmark.convert import cast, to_frozen
from benchmark.drivers import Driver, InFlight, sync, tracker_rows
from benchmark.scene import build_scene, noised_lanes, scene_params


def unpack_row(row: np.ndarray, N: int) -> dict:
    """A fused frame step's output row ``[34 + 9N]``: the estimate's pose,
    velocity, camera offset, bias, searched flag, landmarks, their ids and
    mask, then the tracker's pixels, ids and visibility."""
    o = 34
    return {"position": row[9:12], "pixels": row[o + 5 * N:o + 7 * N].reshape(N, 2),
            "ids": np.where(row[o + 8 * N:o + 9 * N] > 0.5, np.rint(row[o + 7 * N:o + 8 * N]), -1).astype(np.int64)}


class BatchDriver(Driver):
    def setup(self):
        from eqvio_tpu_torch.app.run_opt import BatchChunkRunner, collect_fused_inputs
        from eqvio_tpu_torch.graph import broadcast_lanes

        if reference.camera_lag(self.config):
            raise ValueError("collect_fused_inputs applies no camera lag to a reader object")
        B, C = self.mix["lanes"], self.mix["chunk_size"]
        self.scene = build_scene(scene_params(self.cfg), self.seed, self.dev)
        T = len(self.scene.images.stamps)
        inp = collect_fused_inputs(self.scene, self.config, T, self.dtype, str(self.dev))
        self.T = T = (inp.meta.shape[0] // C) * C
        gen = torch.Generator(device=self.dev)
        gen.manual_seed(self.seed + 1)
        self.imgs = noised_lanes(self.scene.frames[:T], B, gen)
        self.meta = torch.as_tensor(inp.meta[:T], dtype=self.dtype).to(self.dev).expand(B, T, -1)
        self.carry0 = broadcast_lanes((inp.state, inp.tracker), B)
        self.runner = BatchChunkRunner(inp.tcfg, inp.settings, inp.settings.suite, inp.camera, inp.imu_window,
                                       self.dtype, *self.carry0, self.dev)
        self.N = inp.tcfg.max_features
        self.outs = torch.empty(B, C, self.runner.out_width, dtype=self.dtype, device=self.dev)
        # the check: the start of two lanes, one in each half, and one chunk of a lane from its carry
        S0, S = self.mix["start_frames"], self.mix["check_frames"]
        self.start_lanes = [int(self.rng.integers(0, B // 2)), int(self.rng.integers(B // 2, B))]
        self.mid_lane = int(self.rng.integers(0, B))
        self.mid_chunk = int(self.rng.integers(self.mix["check_chunk_lo"], self.mix["check_chunk_hi"] + 1))
        self.rows = torch.empty(B, (-(-S0 // C) + -(-S // C)) * C, self.runner.out_width, dtype=self.dtype,
                                device=self.dev)
        self.mid_carry = None
        with self.spans.span("warmup", frames=B * C * 2):
            for c in range(2):
                self.runner.run(self.imgs[:, c * C:(c + 1) * C], self.meta[:, c * C:(c + 1) * C], self.outs)
            self.runner.step.load(self.carry0)
            sync(self.dev)

    def _chunk(self, c: int, keep: int | None = None):
        C = self.mix["chunk_size"]
        self.runner.run(self.imgs[:, c:c + C], self.meta[:, c:c + C], self.outs)
        if keep is not None:
            self.rows[:, keep:keep + C].copy_(self.outs)

    def window(self, seconds: float):
        from torch.utils._pytree import tree_map

        B, C = self.mix["lanes"], self.mix["chunk_size"]
        S0 = self.mix["start_frames"]
        n_start = -(-S0 // C) * C
        mid = self.mid_chunk * C
        flight = InFlight(self.dev)
        t0 = time.perf_counter()
        c, first_pass = 0, True
        while True:
            if c >= self.T:
                self.runner.step.load(self.carry0)
                c, first_pass = 0, False
            keep = None
            if first_pass and c < n_start:
                keep = c
            elif first_pass and mid <= c < mid + -(-self.mix["check_frames"] // C) * C:
                if c == mid:
                    self.mid_carry = tree_map(torch.clone, self.runner.step.value())
                keep = n_start + c - mid
            with self.spans.span("chunk", frames=B * C, start_frame=c):
                self._chunk(c, keep)
                flight.mark()
            self.attempted += B * C
            self.frames_done += B * C
            c += C
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.dev)
        self.wall_s = time.perf_counter() - t0
        last = self.outs[:, -1].float().cpu().numpy()
        self.failed += C * int((~np.isfinite(last).all(axis=1)).sum())
        self.complete = not first_pass or c >= mid + self.mix["check_frames"]
        return {"batch_frames_per_s": self.frames_done / self.wall_s}

    def trace(self):
        C = self.mix["chunk_size"]

        def stretch():
            self.runner.step.load(self.carry0)
            self._chunk(0)
            sync(self.dev)
            self._chunk(C)

        self.records = tracing.capture(stretch)
        self.view = tracing.steady(self.records, C)
        self.trace_frames, self.trace_lanes = C, self.mix["lanes"]

    def _stretches(self):
        """From the start of two lanes, one in each half, and from one
        lane's carry before a chunk drawn from the seed."""
        if not self.complete or self.mid_carry is None:
            return None
        C, S0, S = self.mix["chunk_size"], self.mix["start_frames"], self.mix["check_frames"]
        n_start = -(-S0 // C) * C
        rows = self.rows.double().cpu().numpy()
        K = reference.imu_window_size(self.scene)
        first, feed = reference.frame_feed(self.scene, self.T, K)
        shape = tuple(self.scene.host_frames.shape[1:])

        def start(b):
            def run(precision, dev):
                step = reference.FrameStep(self.config, self.scene, self.dtype, precision, dev, self.dev)
                state, trk = reference.initial_state(step.settings, step.tcfg, first, shape, step.dtype, dev,
                                                     step.front)
                return tracker_rows(step.run(state, trk, self.imgs[b].cpu(), feed[:S0]))
            return run

        b, k = self.mid_lane, self.mid_chunk * C
        p_state, p_trk = self.mid_carry

        def mid(precision, dev):
            step = reference.FrameStep(self.config, self.scene, self.dtype, precision, dev, self.dev)
            frames = self.imgs[b].cpu()
            state = to_frozen(p_state, lambda t: cast(step.dtype, dev)(t[b]))
            trk = to_frozen(p_trk, lambda t: t[b].to(step.front))
            trk = trk._replace(pyramid=reference.pyramid_of(frames[k - 1].to(step.front), step.tcfg))
            return tracker_rows(step.run(state, trk, frames, feed[k:k + S]))

        prog = lambda r: {key: np.stack([unpack_row(x, self.N)[key] for x in r])  # noqa: E731
                          for key in ("position", "pixels", "ids")}
        return [(start(lane), prog(rows[lane, :S0])) for lane in self.start_lanes] + \
            [(mid, prog(rows[b, n_start:n_start + S]))]


DRIVER = BatchDriver
