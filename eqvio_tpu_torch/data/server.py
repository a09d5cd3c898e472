"""Stamp-ordered measurement stream with a background image decoder
(counterpart of ``eqvio_tpu/data/server.py``).  The ASL and UZH-FPV readers
are ported; the ANU, rosbag and Hilti readers and the native PNG loader are
not yet (``ROADMAP.md`` queue 1).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, NamedTuple

import numpy as np


class Measurement(NamedTuple):
    kind: str  # "imu" | "image"
    stamp: float
    data: object  # (gyr, acc) or a uint8 image
    index: int


def create_dataset_reader(mode: str, dataset_dir: str, camera_yaml: str | None = None,
                          camera_lag: float = 0.0):
    """Reader for ``mode`` (``asl``/``euroc`` or ``uzhfpv``/``uzh``);
    ``camera_lag`` shifts image stamps earlier by the image-vs-IMU latency."""
    from .asl import ASLDatasetReader, ImageSeq

    mode = mode.lower()
    if mode in ("asl", "euroc"):
        reader = ASLDatasetReader(dataset_dir, camera_yaml)
    elif mode in ("uzhfpv", "uzh"):
        from .uzhfpv import UZHFPVDatasetReader

        reader = UZHFPVDatasetReader(dataset_dir, camera_yaml)
    elif mode in ("anu", "ap", "ros", "rosbag", "hilti"):
        raise NotImplementedError(
            f"dataset mode {mode!r} is not ported yet (ROADMAP.md queue 1, other readers)"
        )
    else:
        raise ValueError(f"unknown dataset mode {mode!r} (use asl | uzhfpv | anu | rosbag | hilti)")
    if camera_lag:
        reader.images = ImageSeq(reader.images.stamps - camera_lag, reader.images.paths)
    return reader


class DataServer:
    """Merged IMU + image stream; a daemon thread decodes images ahead of the
    consumer into a bounded queue."""

    def __init__(self, reader, start_time: float | None = None,
                 stop_time: float | None = None, queue_size: int = 64):
        self.reader = reader
        self.start_time = start_time
        self.stop_time = stop_time
        self.queue_size = queue_size

    def __iter__(self) -> Iterator[Measurement]:
        imu = self.reader.imu
        images = self.reader.images
        lo = -np.inf if self.start_time is None else self.start_time
        hi = np.inf if self.stop_time is None else self.stop_time
        img_idx = [i for i, s in enumerate(images.stamps) if lo <= s <= hi]
        imu_idx = [i for i, s in enumerate(imu.stamps) if lo - 0.1 <= s <= hi]

        img_queue: queue.Queue = queue.Queue(maxsize=self.queue_size)

        def producer():
            for i in img_idx:
                img_queue.put((i, self.reader.load_image_u8(i)))
            img_queue.put(None)

        threading.Thread(target=producer, daemon=True).start()

        done = False
        k = 0
        for i in img_idx:
            stamp_img = images.stamps[i]
            while k < len(imu_idx) and imu.stamps[imu_idx[k]] <= stamp_img:
                j = imu_idx[k]
                yield Measurement("imu", float(imu.stamps[j]), (imu.gyr[j], imu.acc[j]), j)
                k += 1
            if not done:
                item = img_queue.get()
                if item is None:
                    done = True
                else:
                    idx, img = item
                    assert idx == i
                    yield Measurement("image", float(stamp_img), img, i)
        while k < len(imu_idx):
            j = imu_idx[k]
            yield Measurement("imu", float(imu.stamps[j]), (imu.gyr[j], imu.acc[j]), j)
            k += 1
