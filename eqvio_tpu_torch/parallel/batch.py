"""A batch of filter instances as one program (counterpart of
``eqvio_tpu/parallel/batch.py``): every state and input carries a leading
lane axis and the one-sequence step runs under ``torch.func.vmap``, so the
work per frame is one batched launch per operation whatever the number of
lanes.

The multi-process worker (``parallel/dist_worker.py``) drives these over
each rank's block of the lanes.  The simulation runner vmaps its own frame
step, which also tracks slots and writes outputs.
"""

from __future__ import annotations

import torch
from .. import filter as F
from ..graph import broadcast_lanes
from ..runtime import configure_runtime


def make_batched_states(settings: F.Settings, batch: int, capacity: int, dtype=torch.float32,
                        device: str = "cuda") -> F.EqFState:
    """``batch`` freshly initialised filter states (leading axis = lane) on
    ``device`` (``cuda`` unless the caller asks for ``cpu``; without a card
    the default raises)."""
    dev, _ = configure_runtime(device)
    one = F.init_state(settings, capacity, dtype, dev)
    return broadcast_lanes(one, batch)


def batch_sim_step(settings: F.Settings, camera, suite=None):
    """The vmapped frame step ``step(states, imu_windows, dts, pixels, vis,
    ids) -> states`` (propagate over the IMU window, then the vision
    update), every input with a leading lane axis."""
    if suite is None:
        suite = settings.suite

    def one_step(state, imu_win, dts, pixels, vis, ids):
        state = F.propagate_window(state, imu_win, dts, settings, suite)
        return F.process_vision(state, pixels, vis, ids, camera, settings, suite)

    return torch.func.vmap(one_step)
