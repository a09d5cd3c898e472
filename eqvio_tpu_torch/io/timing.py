"""Per-frame section timing (counterpart of ``eqvio_tpu/io/timing.py``).

Host wall time around explicitly delimited sections; rows go to
``timing.csv`` through the writer.  On the GPU a section's time covers only
the host's enqueue unless the section ends in a synchronising call.
"""

from __future__ import annotations

import time


class LoopTimer:
    def __init__(self, labels=None):
        self.labels = list(labels or [])
        self._start: dict[str, float] = {}
        self._frame: dict[str, float] = {}
        self._frame_start = 0.0

    def start_loop(self):
        self._frame = {lab: 0.0 for lab in self.labels}
        self._frame_start = time.perf_counter()

    def start_timing(self, label: str):
        self._start[label] = time.perf_counter()

    def end_timing(self, label: str):
        if label in self._start:
            self._frame[label] = self._frame.get(label, 0.0) + (
                time.perf_counter() - self._start.pop(label)
            )

    def frame_row(self) -> tuple[float, dict[str, float]]:
        return self._frame_start, dict(self._frame)
