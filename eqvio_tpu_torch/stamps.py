"""The frame step's stamps: where it marks its stage boundaries, and the
host clock they are read against.

The frame step calls :func:`stamp` at each boundary of :data:`STAMPS`.  A
call does nothing unless a row is being stamped (:func:`stamping`): a step
built without a row issues no stamp op, and no kernel module is loaded for
one.  Inside :func:`stamping` each call writes the clock into the row's slot
through the op ``eqvio_tpu_torch::frame_stamp`` (:mod:`kernels.stamp`): the
card's timer on a CUDA row, :data:`host_ns` on a CPU row.
"""

from __future__ import annotations

import contextlib
import time

# the slots of a frame's stamp row, in the order the step reaches them
STAMPS = ("frame_begin", "gate_begin", "gate_end", "tracker_end", "propagation_end", "lifecycle_end",
          "vision_end", "frame_end")
(FRAME_BEGIN, GATE_BEGIN, GATE_END, TRACKER_END, PROPAGATION_END, LIFECYCLE_END, VISION_END,
 FRAME_END) = range(len(STAMPS))
# the host clock torch.profiler stamps its records with (Unix time in ns)
host_ns = time.time_ns

_row = None  # the row the step's stamps go to, while one is being stamped
_op = None  # kernels.stamp.frame_stamp, from the first stamping block on


def stamp(slot: int) -> None:
    """Stamp ``slot`` of the row being stamped; nothing without one."""
    if _row is not None:
        _op(_row, slot)


@contextlib.contextmanager
def stamping(row):
    """The block's :func:`stamp` calls write into ``row`` (``[len(STAMPS)]``
    int64)."""
    global _row, _op
    from .kernels.stamp import frame_stamp

    _op = frame_stamp
    prev, _row = _row, row
    try:
        yield row
    finally:
        _row = prev
