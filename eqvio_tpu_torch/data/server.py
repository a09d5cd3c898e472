"""Stamp-ordered measurement stream with a background image decoder
(counterpart of ``eqvio_tpu/data/server.py``).
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterator, NamedTuple

import numpy as np


class Measurement(NamedTuple):
    kind: str  # "imu" | "image"
    stamp: float
    data: object  # (gyr, acc) or a uint8 image
    index: int


def create_dataset_reader(mode: str, dataset_dir: str, camera_yaml: str | None = None,
                          camera_lag: float = 0.0):
    """Reader for ``mode``: ``asl``/``euroc``, ``uzhfpv``/``uzh``, ``anu``/``ap``,
    ``ros``/``rosbag`` (``dataset_dir`` is the bag) or ``hilti``;
    ``camera_lag`` shifts image stamps earlier by the image-vs-IMU latency."""
    from .asl import ImageSeq

    reader = _create_reader(mode.lower(), dataset_dir, camera_yaml)
    if camera_lag:
        reader.images = ImageSeq(reader.images.stamps - camera_lag, reader.images.paths)
    return reader


def _create_reader(mode: str, dataset_dir: str, camera_yaml: str | None):
    if mode in ("asl", "euroc"):
        from .asl import ASLDatasetReader

        return ASLDatasetReader(dataset_dir, camera_yaml)
    if mode in ("uzhfpv", "uzh"):
        from .uzhfpv import UZHFPVDatasetReader

        return UZHFPVDatasetReader(dataset_dir, camera_yaml)
    if mode in ("anu", "ap"):
        from .anu import APDatasetReader

        return APDatasetReader(dataset_dir, camera_yaml)
    if mode in ("ros", "rosbag"):
        from .rosbag import RosbagDatasetReader

        return RosbagDatasetReader(dataset_dir, camera_yaml)
    if mode == "hilti":
        from .rosbag import HiltiDatasetReader

        return HiltiDatasetReader(dataset_dir, camera_yaml)
    raise ValueError(f"unknown dataset mode {mode!r} (use asl | uzhfpv | anu | rosbag | hilti)")


class DataServer:
    """Merged IMU + image stream; a daemon thread decodes images ahead of the
    consumer into a bounded queue.  PNG frames go through the native loader
    (``native_loader``) where it builds, else through the reader's
    ``load_image_u8``.  After a pass, ``decoder`` names the decoder used
    (``"native"``, or the reader's ``decoder``: ``"pil"`` for image files,
    ``"bag"`` for a bag's raw messages, ``"memory"`` for the in-memory
    scenes) and ``decode_s``/``decoded`` hold the decoding thread's seconds
    and frames."""

    def __init__(self, reader, start_time: float | None = None,
                 stop_time: float | None = None, queue_size: int = 64):
        self.reader = reader
        self.start_time = start_time
        self.stop_time = stop_time
        self.queue_size = queue_size
        self.decoder = None
        self.decode_s = 0.0
        self.decoded = 0

    def __iter__(self) -> Iterator[Measurement]:
        imu = self.reader.imu
        images = self.reader.images
        lo = -np.inf if self.start_time is None else self.start_time
        hi = np.inf if self.stop_time is None else self.stop_time
        img_idx = [i for i, s in enumerate(images.stamps) if lo <= s <= hi]
        imu_idx = [i for i, s in enumerate(imu.stamps) if lo - 0.1 <= s <= hi]

        frames = self._native_frames(img_idx)
        if frames is None:
            self.decoder = self.reader.decoder
            frames = ((i, self.reader.load_image_u8(i)) for i in img_idx)
        img_queue: queue.Queue = queue.Queue(maxsize=self.queue_size)

        def producer():
            it = iter(frames)
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it, None)
                except Exception as e:  # noqa: BLE001 — raised on the consuming thread
                    img_queue.put(e)
                    return
                self.decode_s += time.perf_counter() - t0
                if item is None:
                    break
                self.decoded += 1
                img_queue.put(item)
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
                if isinstance(item, Exception):
                    raise item
                if item is None:
                    done = True
                else:
                    idx, img = item
                    if idx != i:
                        raise RuntimeError(f"image decoder out of order: frame {idx} where {i} was due")
                    yield Measurement("image", float(stamp_img), img, i)
        while k < len(imu_idx):
            j = imu_idx[k]
            yield Measurement("imu", float(imu.stamps[j]), (imu.gyr[j], imu.acc[j]), j)
            k += 1

    def _native_frames(self, img_idx):
        """``(index, frame)`` pairs from the native loader when the reader
        decodes image files, every frame is a PNG and the loader builds, else
        None."""
        paths = [self.reader.images.paths[i] for i in img_idx]
        if self.reader.decoder != "pil" or not paths or not all(p.lower().endswith(".png") for p in paths):
            return None
        from . import native_loader

        if not native_loader.available():
            return None
        self.decoder = "native"
        loader = native_loader.NativeImageLoader(paths, queue_size=self.queue_size)
        return ((img_idx[k], img) for k, img in loader)
