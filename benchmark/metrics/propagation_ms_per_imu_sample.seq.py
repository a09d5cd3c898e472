"""Device ms of propagation per live IMU sample: the stamped propagation time a frame (tracker end to propagation end, over an instrumented pass) over the live IMU samples a frame, from the counters of the window's last pass summary.  None where the summary has no counters or the program no stamps."""

from benchmark import program_trace


def read(drv):
    summary = getattr(drv, "summary", None)
    counters = None if summary is None else summary.get("counters")
    if not counters or not counters.get("frames") or not counters.get("imu_samples_live"):
        return None
    r = program_trace.reading(drv)
    if r is None:
        return None
    return r["propagation_ms_per_frame"] * counters["frames"] / counters["imu_samples_live"]
