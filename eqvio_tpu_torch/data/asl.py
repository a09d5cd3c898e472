"""EuRoC ASL-format dataset reader (counterpart of ``eqvio_tpu/data/asl.py``).

``mav0/{imu0,cam0}/data.csv`` with nanosecond stamps, ``cam0/sensor.yaml``
intrinsics and ``T_BS`` extrinsics, ground truth with duplicate stamps
removed.  PyYAML and PIL are imported inside the functions that need them.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np


class CameraInfo(NamedTuple):
    model: str  # "radtan" | "equidistant" | "pinhole"
    intrinsics: tuple  # (fx, fy, cx, cy)
    distortion: tuple
    resolution: tuple  # (width, height)
    T_BS: np.ndarray  # 4x4 camera-to-body extrinsics


class ImageSeq(NamedTuple):
    stamps: np.ndarray  # [T] seconds
    paths: list


class IMUSeq(NamedTuple):
    stamps: np.ndarray  # [K] seconds
    gyr: np.ndarray  # [K, 3]
    acc: np.ndarray  # [K, 3]


class GroundTruth(NamedTuple):
    stamps: np.ndarray
    position: np.ndarray  # [T, 3]
    quaternion: np.ndarray  # [T, 4] (w, x, y, z)
    velocity: np.ndarray | None


class ASLDatasetReader:
    decoder = "pil"  # what decodes the frames (data.server.DataServer.decoder)

    def __init__(self, dataset_dir: str, camera_yaml: str | None = None):
        self.base = os.path.join(dataset_dir, "mav0")
        self.imu = self._read_imu()
        self.images = self._read_images()
        self.camera = self._read_camera(camera_yaml)
        self.groundtruth = self._read_groundtruth()

    def _read_imu(self) -> IMUSeq:
        data = np.genfromtxt(os.path.join(self.base, "imu0", "data.csv"), delimiter=",", skip_header=1)
        return IMUSeq(data[:, 0] * 1e-9, data[:, 1:4], data[:, 4:7])

    def _read_images(self) -> ImageSeq:
        stamps, names = [], []
        with open(os.path.join(self.base, "cam0", "data.csv")) as f:
            next(f)
            for line in f:
                parts = line.strip().split(",")
                if len(parts) >= 2 and parts[0]:
                    stamps.append(float(parts[0]) * 1e-9)
                    names.append(os.path.join(self.base, "cam0", "data", parts[1].strip()))
        return ImageSeq(np.asarray(stamps), names)

    def _read_camera(self, camera_yaml) -> CameraInfo:
        import yaml

        with open(camera_yaml or os.path.join(self.base, "cam0", "sensor.yaml")) as f:
            cfg = yaml.safe_load(f)
        fu, fv, cu, cv = cfg["intrinsics"]
        dist = tuple(cfg.get("distortion_coefficients", (0.0, 0.0, 0.0, 0.0)))
        model = {"radial-tangential": "radtan", "equidistant": "equidistant"}.get(
            cfg.get("distortion_model", "radial-tangential"), "radtan"
        )
        w, h = cfg.get("resolution", (752, 480))
        T_BS = np.asarray(cfg["T_BS"]["data"], dtype=float).reshape(4, 4)
        return CameraInfo(model, (fu, fv, cu, cv), dist, (int(w), int(h)), T_BS)

    def _read_groundtruth(self) -> GroundTruth | None:
        path = os.path.join(self.base, "state_groundtruth_estimate0", "data.csv")
        if not os.path.exists(path):
            return None
        data = np.genfromtxt(path, delimiter=",", skip_header=1)
        stamps = data[:, 0] * 1e-9
        keep = np.concatenate([[True], np.diff(stamps) > 0])
        data, stamps = data[keep], stamps[keep]
        vel = data[:, 8:11] if data.shape[1] >= 11 else None
        return GroundTruth(stamps, data[:, 1:4], data[:, 4:8], vel)

    def load_image(self, index: int) -> np.ndarray:
        """Decode image ``index`` to grayscale float32 in [0, 1]."""
        return self.load_image_u8(index).astype(np.float32) / 255.0

    def load_image_u8(self, index: int) -> np.ndarray:
        """Decode image ``index`` to grayscale uint8."""
        from PIL import Image

        return np.asarray(Image.open(self.images.paths[index]).convert("L"), dtype=np.uint8)
