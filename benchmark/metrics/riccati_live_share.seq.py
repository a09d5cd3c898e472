"""Share of the per-sample Riccati steps that carry an IMU reading: the window entries with dt > 0 over the Riccati steps the frame step runs, zero-dt pads included, from the counters of the window's last pass summary (percent).  None where the summary has no counters."""


def read(drv):
    summary = getattr(drv, "summary", None)
    counters = None if summary is None else summary.get("counters")
    if not counters or not counters.get("riccati_steps"):
        return None
    return 100.0 * counters["imu_samples_live"] / counters["riccati_steps"]
