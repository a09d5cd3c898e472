"""ANU (AP) dataset reader (counterpart of ``eqvio_tpu/data/anu.py``).

``mav_imu.csv`` and ``cam.csv`` with second stamps, frames under
``frames/``, an OpenCV-FileStorage ``undistort.yaml`` camera (equidistant)
and ``ground_truth.csv`` with duplicate stamps removed.  PyYAML and PIL are
imported inside the functions that need them.
"""

from __future__ import annotations

import os
import re

import numpy as np

from .asl import CameraInfo, GroundTruth, ImageSeq, IMUSeq


def _parse_opencv_yaml(path: str) -> dict:
    """An OpenCV FileStorage YAML without its ``%YAML`` directive and
    ``!!opencv-matrix`` tags, as PyYAML reads it."""
    import yaml

    with open(path) as f:
        text = f.read()
    text = re.sub(r"^%YAML[^\n]*\n", "", text)
    return yaml.safe_load(text.replace("!!opencv-matrix", ""))


class APDatasetReader:
    decoder = "pil"  # what decodes the frames (data.server.DataServer.decoder)

    def __init__(self, dataset_dir: str, camera_yaml: str | None = None):
        self.base = dataset_dir.rstrip("/") + "/"
        self.imu = self._read_imu()
        self.images = self._read_images()
        self.camera = self._read_camera(camera_yaml)
        self.groundtruth = self._read_groundtruth()

    def _read_imu(self) -> IMUSeq:
        data = np.genfromtxt(self.base + "mav_imu.csv", delimiter=",", skip_header=1)
        return IMUSeq(data[:, 0], data[:, 1:4], data[:, 4:7])

    def _read_images(self) -> ImageSeq:
        stamps, names = [], []
        with open(self.base + "cam.csv") as f:
            next(f)
            for line in f:
                parts = [p.strip() for p in line.split(",")]
                if len(parts) >= 2 and parts[0]:
                    stamps.append(float(parts[0]))
                    names.append(os.path.join(self.base, "frames", parts[1]))
        return ImageSeq(np.asarray(stamps), names)

    def _read_camera(self, camera_yaml) -> CameraInfo:
        cfg = _parse_opencv_yaml(camera_yaml or (self.base + "undistort.yaml"))
        K = np.asarray(cfg["camera_matrix"]["data"], dtype=float).reshape(3, 3)
        dist = cfg.get("dist_coeffs", {}).get("data", [0.0, 0.0, 0.0, 0.0])[:4]
        return CameraInfo("equidistant", (K[0, 0], K[1, 1], K[0, 2], K[1, 2]), tuple(float(d) for d in dist),
                          (0, 0), np.eye(4))

    def _read_groundtruth(self) -> GroundTruth | None:
        path = self.base + "ground_truth.csv"
        if not os.path.exists(path):
            return None
        data = np.genfromtxt(path, delimiter=",", skip_header=1)
        data = data[np.concatenate([[True], np.diff(data[:, 0]) > 1e-9])]
        return GroundTruth(data[:, 0], data[:, 1:4], data[:, 4:8], None)

    def load_image(self, index: int) -> np.ndarray:
        """Decode image ``index`` to grayscale float32 in [0, 1]."""
        return self.load_image_u8(index).astype(np.float32) / 255.0

    def load_image_u8(self, index: int) -> np.ndarray:
        """Decode image ``index`` to grayscale uint8."""
        from PIL import Image

        return np.asarray(Image.open(self.images.paths[index]).convert("L"), dtype=np.uint8)
