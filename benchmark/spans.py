"""Spans of the benchmark's own calls into the program: a name, the host
clock at start and end (``time.perf_counter`` seconds), the frames the call
held and free-form attributes.  Kept in memory, written out as JSON lines
when the run ends."""

from __future__ import annotations

import contextlib
import json
import os
import time


class Spans:
    def __init__(self):
        self.records: list[dict] = []

    @contextlib.contextmanager
    def span(self, name: str, frames: int = 0, **attrs):
        """Record the block as one span; ``attrs`` may be added to inside it
        through the yielded dict."""
        rec = {"name": name, "frames": frames, **attrs}
        rec["start"] = time.perf_counter()
        try:
            yield rec
        finally:
            rec["end"] = time.perf_counter()
            self.records.append(rec)

    def write(self, path: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            for r in self.records:
                f.write(json.dumps(r, default=float) + "\n")
