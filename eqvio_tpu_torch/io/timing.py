"""Timing of the loops (counterpart of ``eqvio_tpu/io/timing.py``).

:class:`LoopTimer` (the per-frame loop): host wall time around explicitly
delimited sections; rows go to ``timing.csv`` through the writer.  On the
GPU a section's time covers only the host's enqueue unless the section ends
in a synchronising call.

:class:`Tracer` (the fused loop): named host spans on the profiler's clock,
their totals always and the spans themselves when a run is traced, and
named counters;
:func:`idle_by_host` labels the device's gaps between frames, whose ends the
frame step stamps (:mod:`eqvio_tpu_torch.stamps`), by the host span
that covers each; :func:`write_trace` writes a traced run's block.
"""

from __future__ import annotations

import bisect
import itertools
import json
import threading
import time
from collections import defaultdict

import torch

from ..stamps import host_ns

SPAN_FIELDS = ("name", "start_ns", "end_ns", "chunk", "frame_begin", "frame_end", "parent", "thread")


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


class Tracer:
    """Named host spans of the fused loop, on the clock ``torch.profiler``
    stamps its records with (:data:`stamps.host_ns`).

    Every span adds its seconds to its name's total (:attr:`seconds`) and one
    to its count (:attr:`counts`); :meth:`count` adds to a named counter
    (:attr:`counters`), for quantities the host knows without a span.  With
    ``keep`` each span is also kept, in memory, as ``(name, start_ns,
    end_ns, chunk, first frame, end frame, parent, thread)``: the parent is
    the span open around it on its thread when it began, the thread
    ``"main"`` (the one that made the tracer) or the thread's name.  While a
    profiler records, a span whose name is in ``annotate`` also opens
    ``record_function("eqvio.<name>")``, so a trace shows those phases on
    its host timeline.  Name there only spans that enqueue no device work:
    the profiler mirrors an annotation around device work onto the device's
    timeline as a range of its own, which a reader of the trace may take for
    device time.
    """

    def __init__(self, keep: bool = False, annotate=()):
        self.seconds: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.counters: dict[str, int] = defaultdict(int)
        self.events: list | None = [] if keep else None
        self._open = threading.local()  # the names of each thread's open spans, while spans are kept
        self._main = threading.get_ident()  # the thread that made the tracer: the loop's main thread
        self.annotate = frozenset(annotate)

    def span(self, name: str, chunk: int = -1, frames: tuple[int, int] = (-1, -1)) -> "_Span":
        """A context manager timing the block as the span ``name`` of
        ``chunk`` and the frames ``[frames[0], frames[1])``."""
        return _Span(self, name, chunk, frames)

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to the counter ``name``."""
        self.counters[name] += int(n)

    def add(self, name: str, start_ns: int, end_ns: int, chunk: int = -1, frames: tuple[int, int] = (-1, -1),
            parent: str | None = None) -> None:
        """Record a span timed elsewhere."""
        self.seconds[name] += (end_ns - start_ns) * 1e-9
        self.counts[name] += 1
        if self.events is not None:
            thread = "main" if threading.get_ident() == self._main else threading.current_thread().name
            self.events.append((name, start_ns, end_ns, chunk, frames[0], frames[1], parent, thread))

    def _stack(self) -> list:
        stack = getattr(self._open, "names", None)
        if stack is None:
            stack = self._open.names = []
        return stack


class _Span:
    __slots__ = ("tracer", "name", "chunk", "frames", "parent", "start", "end", "rf")

    def __init__(self, tracer: Tracer, name: str, chunk: int, frames: tuple[int, int]):
        self.tracer, self.name, self.chunk, self.frames = tracer, name, chunk, frames
        self.parent = self.rf = None

    def __enter__(self):
        if self.name in self.tracer.annotate and torch.autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function("eqvio." + self.name)
            self.rf.__enter__()
        if self.tracer.events is not None:
            stack = self.tracer._stack()
            self.parent = stack[-1] if stack else None
            stack.append(self.name)
        self.start = host_ns()
        return self

    @property
    def seconds(self) -> float:
        """The span's seconds, once it has ended."""
        return (self.end - self.start) * 1e-9

    def __exit__(self, *exc):
        self.end = host_ns()
        if self.tracer.events is not None:
            self.tracer._stack().pop()
        self.tracer.add(self.name, self.start, self.end, self.chunk, self.frames, self.parent)
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        return False


def idle_by_host(frames: list, spans: list) -> dict[str, float]:
    """Device seconds idle between consecutive frames, by what the host's
    main thread was doing: for each frame of ``frames`` (rows ``[frame id,
    begin ns, end ns]`` on the host clock, in frame order) after the first,
    the gap from the previous frame's end to its begin, labelled by the
    latest-begun main-thread span of ``spans`` (:attr:`Tracer.events`) that
    covers the gap's start, or ``"none"``."""
    main = sorted((s for s in spans if s[7] == "main"), key=lambda s: s[1])
    starts = [s[1] for s in main]
    reach = list(itertools.accumulate((s[2] for s in main), max))  # the latest end among spans 0..j
    out: dict[str, float] = defaultdict(float)
    for (_, _, end), (_, begin, _) in zip(frames, frames[1:]):
        if begin <= end:
            continue
        label = "none"
        j = bisect.bisect_right(starts, end) - 1
        while j >= 0 and reach[j] >= end:  # a span before j can still cover the gap's start
            if main[j][2] >= end:
                label = main[j][0]
                break
            j -= 1
        out[label] += (begin - end) * 1e-9
    return dict(out)


def write_trace(block: dict, path: str) -> None:
    """A run's ``trace`` block as JSON lines: the clock, then one line per
    frame and one per span, then the idle seconds by host span."""
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "clock", "stamps": block["stamps"], **block["clock"]}) + "\n")
        for row in block["frames"]:
            f.write(json.dumps({"kind": "frame", **dict(zip(block["frame_fields"], row))}) + "\n")
        for ev in block["spans"]:
            f.write(json.dumps({"kind": "span", **dict(zip(SPAN_FIELDS, ev))}) + "\n")
        f.write(json.dumps({"kind": "idle_by_host_s", **block["idle_by_host_s"]}) + "\n")
