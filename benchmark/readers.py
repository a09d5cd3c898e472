"""The arithmetic of the per-layer readers in ``benchmark/metrics/``: each
metric file names its quantity and calls one of these on the run's driver.
A reader that finds nothing to read returns None and the metric is left out
of the line."""

from __future__ import annotations

from . import tracing
from .frozen.frontend.pyramid import pyramid_shapes
from .frozen.kernels.klt import bound_ms


def busy_ms_per_frame(drv):
    v = drv.view
    return None if v is None else v["busy_s"] * 1e3 / v["launches"]


def idle_share(drv):
    v = drv.view
    return None if v is None or v["window_s"] <= 0 else 100.0 * (1.0 - v["busy_s"] / v["window_s"])


def kernels_per_frame(drv):
    v = drv.view
    return None if v is None else len(v["kernels"]) / v["launches"]


def qr_ms_per_frame(drv):
    v = drv.view
    if v is None:
        return None
    secs, n = tracing.kernel_seconds(v, tracing.is_qr)
    return secs * 1e3 / v["launches"] if n else None


def klt_bound(drv) -> tuple[float, str]:
    """The KLT kernel's least time at the cell's shapes (frozen ``bound_ms``):
    ``(ms, "operations" | "bytes")``."""
    gift = drv.config["GIFT"]
    levels = int(gift["maxLevel"]) + 1
    h, w = drv.scene.host_frames.shape[1:]
    lanes = drv.mix.get("lanes", 1)
    return bound_ms(int(gift["maxFeatures"]), pyramid_shapes(h, w, levels), int(gift["winSize"]), 8, lanes)


def klt_roofline(drv):
    """The KLT kernel's share of its roofline: its least time over its mean
    device time per launch in the stretch, in %."""
    v = drv.view
    if v is None:
        return None
    secs, n = tracing.kernel_seconds(v, lambda name: tracing.KLT_KERNEL in name)
    if not n:
        return None
    return 100.0 * klt_bound(drv)[0] / (secs * 1e3 / n)


def host(key):
    def read(drv):
        return drv.host.get(key)
    return read
