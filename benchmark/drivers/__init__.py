"""The drivers of the traffic mixes.  A mix (``traffic/<mix>.json``) is
data: its ``driver`` key names a module of this package,
``drivers/<driver>.py``, found by that name, and its other keys are the
driver's parameters.  Each module's ``DRIVER`` is a :class:`Driver`:

* ``seq``: back-to-back ``run_dataset`` passes over the scene, closed loop,
  as an offline evaluator runs sequences;
* ``batch``: ``lanes`` noised copies of the scene through
  ``BatchChunkRunner.run``, chunk after chunk, the carry reloaded at the
  sequence's end.

A driver makes its inputs from the seed (:mod:`benchmark.scene`), warms up
every shape its window uses, runs the window and returns its end-to-end
numbers, traces a steady stretch when asked, and hands the reference
(:mod:`benchmark.reference`) what the window produced.  The program is
imported inside the drivers, never by the rest of the harness.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from .. import compare


def load(name: str):
    """The driver class of ``drivers/<name>.py``."""
    return importlib.import_module(f"{__name__}.{name}").DRIVER


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class InFlight:
    """At most ``depth`` blocks of work queued on the device: the host waits
    for the block ``depth`` back before it enqueues the next."""

    def __init__(self, dev, depth: int = 2):
        self.dev, self.depth, self.events = dev, depth, []

    def mark(self):
        if self.dev.type != "cuda":
            return
        ev = torch.cuda.Event()
        ev.record()
        self.events.append(ev)
        if len(self.events) > self.depth:
            self.events.pop(0).synchronize()


def tracker_rows(rows: list) -> dict:
    """A reference run's rows as a stretch's arrays."""
    return {"position": np.stack([r["position"] for r in rows]),
            "ids": np.stack([np.where(r["vis"], r["ids"], -1) for r in rows]),
            "pixels": np.stack([r["pixels"] for r in rows])}


class Driver:
    """The parts every entry shares: the cell's configuration ``cfg`` (its
    file), the mix ``mix``, the filter settings ``config`` (its YAML), the
    seed and the device; the counters of the window.  A driver defines
    ``setup()``, ``window(seconds) -> {end-to-end metric: value}``,
    ``trace()`` (sets ``records``, ``view``, ``trace_frames`` and
    ``trace_lanes``) and ``_stretches()`` (None, or ``[(run, program), ...]``
    with ``run(precision, device)`` the reference over a stretch and
    ``program`` what the window produced there)."""

    def __init__(self, cfg: dict, mix: dict, config: dict, seed: int, device: str, spans, out_dir: str):
        self.cfg, self.mix, self.config, self.seed = cfg, mix, config, seed
        self.dev = torch.device(device)
        self.spans, self.out_dir = spans, out_dir
        self.dtype = getattr(torch, cfg["dtype"])
        self.rng = np.random.default_rng([seed, 7])  # the check's samples
        self.attempted = self.failed = 0
        self.frames_done = 0  # lanes x frames completed in the window
        self.wall_s = 0.0
        self.host: dict = {}  # per-layer numbers read from the program's own summaries
        self.view = None  # the traced stretch
        self.records = None

    FAILED = {"pos_gap_m": float("inf"), "px_gap": float("inf"), "px_gap_median": float("inf"),
              "px_gap_q99": float("inf"), "id_mismatch": 1.0, "stretches": []}

    def check(self) -> dict:
        """The program's outputs against the reference (the filter in
        float64 on the host), stretch by stretch."""
        spec = self._stretches()
        if spec is None:
            return dict(self.FAILED)
        return compare.combine([compare.stretch(prog, run("f64", "cpu")) for run, prog in spec])

    def readings(self, device: str, control: bool = True) -> tuple[dict, dict | None]:
        """``(program, control)``: the numbers :meth:`check` gives, and those
        of the control put in the program's place (the reference at the
        control's precision on ``device``), over the same stretches from the
        same states; ``control`` False reads the program alone."""
        spec = self._stretches()
        if spec is None:
            return dict(self.FAILED), dict(self.FAILED) if control else None
        refs = [run("f64", "cpu") for run, _ in spec]
        prog = compare.combine([compare.stretch(p, ref) for (_, p), ref in zip(spec, refs)])
        if not control:
            return prog, None
        return prog, compare.combine([compare.stretch(run("control", device), ref)
                                      for (run, _), ref in zip(spec, refs)])
