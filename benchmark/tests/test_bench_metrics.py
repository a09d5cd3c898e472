"""The per-layer arithmetic on a recorded trace: a hand-written record of
two graph launches (the warm one and the measured one) with their kernels,
copies and host calls, as :func:`benchmark.tracing.capture` keeps them."""

from __future__ import annotations

import importlib.util
import os
import types

import numpy as np
import pytest

from benchmark import readers, tracing
from benchmark.frozen.kernels.klt import bound_ms

HERE = os.path.dirname(os.path.abspath(__file__))
US = 1000  # ns


def _record():
    """Launch 10 warms the trace (its kernels and a copy); launch 20 runs
    a 5 us QR kernel, the 2 us KLT kernel and a 1 us fill, with idle gaps of
    3 us and 4 us between them; a copy of launch 20's stream overlaps the
    QR.  Correlation ids link kernels to launches (the KLT kernel through
    the linked id, as some versions report it)."""
    host = [("cuda_runtime", "cudaGraphLaunch", 0, 2 * US, 10, 0),
            ("cuda_runtime", "cudaGraphLaunch", 50 * US, 52 * US, 20, 0),
            ("cpu_op", "aten::copy_", 60 * US, 75 * US, 30, 0)]
    device = [("kernel", "warm_kernel", 5 * US, 40 * US, 10, 0),
              ("kernel", "void cusolver_geqrf_kernel<float>", 60 * US, 65 * US, 20, 0),
              ("gpu_memcpy", "Memcpy DtoD", 61 * US, 63 * US, 31, 0),
              ("kernel", "void klt_pyramid_kernel<4>(...)", 68 * US, 70 * US, 0, 20),
              ("kernel", "void at::native::FillFunctor", 74 * US, 75 * US, 20, 0)]
    return {"device": device, "host": host}


def _drv(view, lanes=1):
    cfg = {"GIFT": {"maxLevel": 3, "maxFeatures": 40, "winSize": 21}}
    return types.SimpleNamespace(view=view, host={"host_ms_per_frame": 3.5}, config=cfg,
                                 scene=types.SimpleNamespace(host_frames=np.zeros((1, 480, 752), np.uint8)),
                                 mix={"lanes": lanes} if lanes > 1 else {})


def test_steady_stretch():
    v = tracing.steady(_record(), 1)
    assert v["launches"] == 1 and len(v["kernels"]) == 3
    assert v["window_s"] == pytest.approx(15e-6) and v["busy_s"] == pytest.approx(8e-6)
    assert [(b - a) / US for a, b in v["gaps"]] == [3.0, 4.0]
    assert tracing.steady(_record(), 3) is None


def test_readers():
    v = tracing.steady(_record(), 1)
    d = _drv(v)
    assert readers.busy_ms_per_frame(d) == pytest.approx(8e-3)
    assert readers.idle_share(d) == pytest.approx(100 * 7 / 15)
    assert readers.kernels_per_frame(d) == 3
    assert readers.qr_ms_per_frame(d) == pytest.approx(5e-3)
    bound, binding = bound_ms(40, [(480, 752), (240, 376), (120, 188), (60, 94)], 21, 8)
    assert readers.klt_roofline(d) == pytest.approx(100 * bound / 2e-3) and binding in ("operations", "bytes")
    assert readers.klt_roofline(_drv(v, lanes=8)) == pytest.approx(100 * bound_ms(40, [(480, 752), (240, 376),
                                                                                      (120, 188), (60, 94)],
                                                                                  21, 8, 8)[0] / 2e-3)
    assert readers.host("host_ms_per_frame")(d) == 3.5
    assert readers.host("pass_setup_s")(d) is None
    for f in (readers.busy_ms_per_frame, readers.idle_share, readers.qr_ms_per_frame, readers.klt_roofline):
        assert f(_drv(None)) is None


def test_breakdown():
    v = tracing.steady(_record(), 1)
    b = tracing.breakdown(v, _record()["host"])
    assert b["device_ops"][0][0].startswith("void cusolver_geqrf") and len(b["device_ops"]) == 4
    assert b["idle_gaps"][0] == ["aten::copy_", pytest.approx(4e-6)]
    assert b["idle_gaps"][1][0] == "aten::copy_"


def test_metric_files_read_the_record():
    v = tracing.steady(_record(), 1)
    got = {}
    for name in os.listdir(os.path.join(os.path.dirname(HERE), "metrics")):
        spec = importlib.util.spec_from_file_location("m_" + name, os.path.join(os.path.dirname(HERE), "metrics", name))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        got[name[:-3]] = mod.read(_drv(v))
    assert got["device_busy_ms_per_frame.seq"] == pytest.approx(8e-3)
    assert got["idle_share.batch"] == pytest.approx(100 * 7 / 15)
    assert got["launches_per_frame.seq"] == 3 and got["host_ms_per_frame.seq"] == 3.5
