"""The traced stretch of a ``--trace 1`` run and the arithmetic the
per-layer readers share.

:func:`capture` runs a callable under ``torch.profiler`` (host and device
activity) and keeps the records as plain tuples.  A CUDA graph's kernels
carry the correlation id of the ``cudaGraphLaunch`` that ran them, so
:func:`steady` takes the kernels of the last ``launches`` graph launches:
the frames of the stretch, after the launches before them warmed the trace
(a trace can lose the records at its start).  Its window runs from the
first of those kernels' starts to the last one's end; ``busy`` is the union
of every device interval (kernels, copies, fills) inside it.
"""

from __future__ import annotations

import numpy as np

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
GRAPH_LAUNCH = "cudaGraphLaunch"
KLT_KERNEL = "klt_pyramid_kernel"
NAME_CHARS = 160  # a breakdown's kernel names are cut to this (templated names run to thousands)
# cuSOLVER's and cuBLAS's Householder QR kernels (geqrf and its panel and
# update steps) by name
QR_KERNEL_PARTS = ("geqrf", "geqr2", "larfb", "larft", "larfg", "larf_", "orgqr", "ormqr", "householder")


def capture(fn, tail_s: float = 0.2) -> dict:
    """``fn()`` under ``torch.profiler``; the device is synchronised after it
    and the trace stays open ``tail_s`` more (the last records of a graph
    launch arrive late).  Returns ``{"device": [(kind, name, start_ns,
    end_ns, corr)], "host": [(kind, name, start_ns, end_ns, corr)]}``."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        time.sleep(tail_s)
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        start = _ns(e, "start")
        rec = (kind, e.name(), start, start + _ns(e, "duration"), int(e.correlation_id()),
               int(_call(e, "linked_correlation_id") or 0))
        (device if kind in DEVICE_KINDS else host).append(rec)
    return {"device": device, "host": host}


def _call(e, name):
    f = getattr(e, name, None)
    return None if f is None else f()


def _ns(e, what: str) -> int:
    """An event's ``start`` or ``duration`` in ns (torch versions name it in
    ns or in us)."""
    v = _call(e, what + "_ns")
    return int(v) if v is not None else int(round(_call(e, what + "_us") * 1000))


def _kind(e) -> str:
    """The activity kind of a profiler event: ``kernel``, ``gpu_memcpy``,
    ``gpu_memset`` for device work, else the host kind."""
    kind = _call(e, "activity_type")
    if kind is not None:
        return str(kind)
    if str(e.device_type()).endswith("CUDA"):
        name = e.name()
        return "gpu_memcpy" if name.startswith("Memcpy") else "gpu_memset" if name.startswith("Memset") else "kernel"
    return "host"


def _union(intervals: list) -> float:
    total, end = 0.0, -np.inf
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def steady(records: dict, launches: int) -> dict | None:
    """The stretch of the last ``launches`` graph launches: ``window_s``,
    ``busy_s``, its ``kernels`` ``[(name, start_ns, end_ns)]`` (those the
    launches ran), every device interval inside the window (``device``),
    the idle ``gaps`` ``[(start_ns, end_ns)]`` and the ``launches`` found.
    None where the trace holds fewer launches or none of their kernels."""
    graph = sorted((r for r in records["host"] if r[1] == GRAPH_LAUNCH), key=lambda r: r[2])
    if len(graph) < launches or launches <= 0:
        return None
    corr = {c for r in graph[-launches:] for c in r[4:6] if c}
    kernels = [(r[1], r[2], r[3]) for r in records["device"]
               if r[0] == "kernel" and (r[4] in corr or r[5] in corr)]
    if not kernels:
        return None
    w0, w1 = min(k[1] for k in kernels), max(k[2] for k in kernels)
    inside = sorted((r[2], r[3], r[1]) for r in records["device"] if r[3] > w0 and r[2] < w1)
    clipped = [(max(a, w0), min(b, w1)) for a, b, _ in inside]
    gaps, end = [], w0
    for a, b in sorted(clipped):
        if a > end:
            gaps.append((end, a))
        end = max(end, b)
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": _union(clipped) * 1e-9, "kernels": kernels,
            "device": inside, "gaps": gaps, "launches": launches}


def kernel_seconds(view: dict, match) -> tuple[float, int]:
    """Total seconds and count of the stretch's kernels whose name ``match``es."""
    sel = [(b - a) for name, a, b in view["kernels"] if match(name)]
    return sum(sel) * 1e-9, len(sel)


def is_qr(name: str) -> bool:
    low = name.lower()
    return any(p in low for p in QR_KERNEL_PARTS)


def breakdown(view: dict, host: list, top: int = 10) -> dict:
    """The device operations that took most time in the stretch, and its
    longest idle gaps labelled by the host call that was running when each
    began (the latest-started host record covering the gap's start)."""
    by_name: dict = {}
    for a, b, name in view["device"]:
        by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    hosts = sorted(((r[2], r[3], r[1]) for r in host), key=lambda r: r[0])
    starts = [h[0] for h in hosts]
    gaps = []
    for a, b in sorted(view["gaps"], key=lambda g: g[0] - g[1])[:top]:
        i = int(np.searchsorted(starts, a, side="right")) - 1
        label = "no host record"
        for j in range(i, max(i - 5000, -1), -1):
            if hosts[j][1] >= a:
                label = hosts[j][2]
                break
        gaps.append([label, (b - a) * 1e-9])
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops], "idle_gaps": gaps}
