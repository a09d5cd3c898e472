"""UZH-FPV dataset reader (counterpart of ``eqvio_tpu/data/uzhfpv.py``).

Space-delimited ``imu.txt`` and ``left_images.txt`` with a leading index
column, a kalibr camchain with the equidistant (fisheye) model whose
``T_cam_imu`` is inverted into the camera-to-body extrinsics, and
``groundtruth.txt`` (``id stamp tx ty tz qx qy qz qw``) with duplicate stamps
removed.  PyYAML and PIL are imported inside the functions that need them.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from .asl import CameraInfo, GroundTruth, ImageSeq, IMUSeq


class UZHFPVDatasetReader:
    decoder = "pil"  # what decodes the frames (data.server.DataServer.decoder)

    def __init__(self, dataset_dir: str, camera_yaml: str | None = None):
        self.base = dataset_dir.rstrip("/") + "/"
        self.imu = self._read_imu()
        self.images = self._read_images()
        self.camera = self._read_camera(camera_yaml)
        self.groundtruth = self._read_groundtruth()

    def _read_imu(self) -> IMUSeq:
        data = np.genfromtxt(os.path.join(self.base, "imu.txt"), skip_header=1)
        return IMUSeq(data[:, 1], data[:, 2:5], data[:, 5:8])  # id, stamp, gyr, acc

    def _read_images(self) -> ImageSeq:
        stamps, names = [], []
        with open(os.path.join(self.base, "left_images.txt")) as f:
            next(f)
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    stamps.append(float(parts[1]))
                    names.append(os.path.join(self.base, parts[2].strip()))
        return ImageSeq(np.asarray(stamps), names)

    def _find_camchain(self) -> str:
        """A ``*calib*/camchain-*imu.yaml`` beside the sequence, else a
        ``camchain-*.yaml`` inside it."""
        beside = sorted(glob.glob(os.path.join(self.base, "..", "*calib*", "camchain-*imu.yaml")))
        inside = sorted(glob.glob(os.path.join(self.base, "camchain-*.yaml")))
        if beside or inside:
            return (beside or inside)[0]
        raise FileNotFoundError(f"no kalibr camchain found near {self.base}")

    def _read_camera(self, camera_yaml) -> CameraInfo:
        import yaml

        with open(camera_yaml or self._find_camchain()) as f:
            cfg = yaml.safe_load(f)["cam0"]
        fu, fv, cu, cv = cfg["intrinsics"]
        w, h = cfg["resolution"]
        T_cam_imu = np.asarray(cfg["T_cam_imu"], dtype=float).reshape(4, 4)
        return CameraInfo("equidistant", (fu, fv, cu, cv), tuple(cfg["distortion_coeffs"]), (int(w), int(h)),
                          np.linalg.inv(T_cam_imu))

    def _read_groundtruth(self) -> GroundTruth | None:
        path = os.path.join(self.base, "groundtruth.txt")
        if not os.path.exists(path):
            return None
        data = np.genfromtxt(path, skip_header=1)
        keep = np.concatenate([[True], np.diff(data[:, 1]) > 1e-8])
        data = data[keep]
        qxyzw = data[:, 5:9]
        quat = np.stack([qxyzw[:, 3], qxyzw[:, 0], qxyzw[:, 1], qxyzw[:, 2]], axis=-1)
        return GroundTruth(data[:, 1], data[:, 2:5], quat, None)

    def load_image(self, index: int) -> np.ndarray:
        """Decode image ``index`` to grayscale float32 in [0, 1]."""
        return self.load_image_u8(index).astype(np.float32) / 255.0

    def load_image_u8(self, index: int) -> np.ndarray:
        """Decode image ``index`` to grayscale uint8."""
        from PIL import Image

        return np.asarray(Image.open(self.images.paths[index]).convert("L"), dtype=np.uint8)
