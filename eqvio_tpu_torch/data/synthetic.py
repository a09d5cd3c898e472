"""In-memory synthetic ASL scene (counterpart of
``eqvio_tpu/data/synthetic.py:generate_asl_dataset``).

:class:`SyntheticASLReader` renders the simulator's world points into frames
and serves them, with IMU rows and ground truth, through the ASL reader's
interface (``camera``, ``imu``, ``images``, ``groundtruth``,
``load_image_u8``) without writing files, so it needs neither PIL nor
PyYAML.  Every value passes through the same quantisation as the reference's
CSV round trip (integer-nanosecond stamps, 9-decimal IMU and ground-truth
rows, uint8 frames), so for the same arguments it serves what
``ASLDatasetReader`` reads back from ``generate_asl_dataset``'s tree.
"""

from __future__ import annotations

import numpy as np
import torch

from ..camera import RadTanCamera
from ..io.writer import rotation_to_quaternion
from ..lie import mv, se3_inv, se3_mul
from ..sim import Simulator
from .asl import CameraInfo, GroundTruth, ImageSeq, IMUSeq


def _render(points_px, visible, w, h, rng, amp, width) -> np.ndarray:
    """Visible points as 2-D gaussian blobs of per-point amplitude and width,
    plus mild noise."""
    img = np.zeros((h, w), dtype=np.float32)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    for i, ((x, y), v) in enumerate(zip(points_px, visible)):
        if v and 2 < x < w - 2 and 2 < y < h - 2:
            a, s2 = float(amp[i]), float(width[i])
            r = int(np.ceil(2.5 * np.sqrt(s2 / 2.0))) + 1
            x0, x1 = max(0, int(x) - r), min(w, int(x) + r + 1)
            y0, y1 = max(0, int(y) - r), min(h, int(y) + r + 1)
            img[y0:y1, x0:x1] += a * np.exp(
                -((xs[y0:y1, x0:x1] - x) ** 2 + (ys[y0:y1, x0:x1] - y) ** 2) / s2
            )
    img += rng.normal(scale=0.01, size=img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def _point_appearance(num_points: int, seed: int):
    r = np.random.default_rng(seed + 90210)
    return r.uniform(0.55, 1.25, num_points), r.uniform(1.8, 5.5, num_points)


def _ns_stamps(times: np.ndarray) -> np.ndarray:
    return np.asarray([float(int(t * 1e9)) for t in times]) * 1e-9


def _csv9(values: np.ndarray) -> np.ndarray:
    return np.vectorize(lambda v: float(f"{v:.9f}"))(np.asarray(values, dtype=np.float64))


class SyntheticASLReader:
    """The synthetic scene of ``generate_asl_dataset`` (no IMU noise, no
    distractors, zero distortion), served from memory."""

    def __init__(self, end_time: float = 5.0, imu_freq: float = 200.0, frame_freq: float = 20.0,
                 width: int = 320, height: int = 240, num_points: int = 400, seed: int = 0,
                 kind: str = "wave"):
        f64 = torch.float64
        sim = Simulator.create(kind=kind, end_time=end_time + 1.0, num_points=num_points,
                               num_walls=4, seed=seed, wall_distance=2.0)
        fx = fy = 200.0
        cx, cy = width / 2, height / 2
        dist = (0.0, 0.0, 0.0, 0.0)
        cam = RadTanCamera.create(fx, fy, cx, cy, dist, width, height, dtype=f64, device="cpu")
        rng = np.random.default_rng(seed)
        amp, blob_w = _point_appearance(num_points, seed)
        t0 = 0.2

        imu_times = np.arange(t0, end_time, 1.0 / imu_freq)
        gyr, acc = sim.get_imu_batch(torch.as_tensor(imu_times, dtype=f64))
        self.imu = IMUSeq(_ns_stamps(imu_times), _csv9(gyr.numpy()), _csv9(acc.numpy()))

        T_BS = np.eye(4)
        T_BS[:3, :3] = sim.camera_offset.R.numpy()
        T_BS[:3, 3] = sim.camera_offset.x.numpy()
        self.camera = CameraInfo("radtan", (fx, fy, cx, cy), dist, (width, height), T_BS)

        frame_times = np.arange(t0 + 1.0 / frame_freq, end_time, 1.0 / frame_freq)
        self.frames = []
        for t in frame_times:
            pose = sim.interpolate_pose(torch.tensor(t, dtype=f64))
            cam_inv = se3_inv(se3_mul(pose, sim.camera_offset))
            pts = mv(cam_inv.R, sim.world) + cam_inv.x
            px = cam.project(pts).numpy()
            z = pts[:, 2].numpy()
            vis = (z > 0.1) & (px[:, 0] > 0) & (px[:, 0] < width) & (px[:, 1] > 0) & (px[:, 1] < height)
            img = _render(px, vis, width, height, rng, amp, blob_w)
            self.frames.append((img * 255).astype(np.uint8))
        self.images = ImageSeq(_ns_stamps(frame_times),
                               [f"{int(t * 1e9)}.png" for t in frame_times])

        gt_times = np.arange(t0, end_time, 1.0 / frame_freq)
        pose, vel = sim.true_pose_velocity(torch.as_tensor(gt_times, dtype=f64))
        q = rotation_to_quaternion(pose.R.numpy())
        v_inertial = mv(pose.R, vel).numpy()
        self.groundtruth = GroundTruth(
            _ns_stamps(gt_times), _csv9(pose.x.numpy()), _csv9(q), _csv9(v_inertial)
        )

    def load_image_u8(self, index: int) -> np.ndarray:
        return self.frames[index]


def bench_scene(end_time: float = 8.0) -> SyntheticASLReader:
    """The benchmark scene (752x480 frames at 20 Hz, 200 Hz IMU, 600 points,
    seed 4, room trajectory with a stationary start), cut to ``end_time``
    seconds."""
    return SyntheticASLReader(end_time=end_time, imu_freq=200.0, frame_freq=20.0, width=752,
                              height=480, num_points=600, seed=4, kind="room")


def shifted_texture_pair(height: int, width: int, shift: tuple[int, int], seed: int = 5,
                         device="cpu") -> tuple[torch.Tensor, torch.Tensor]:
    """A smooth random texture in [0, 1] (bicubic noise at 64, 16 and 4 px
    scales) and its copy moved by the integer ``shift`` (x, y) px, wrapping
    at the borders: a float32 frame pair whose true motion is known
    everywhere, for tracking checks with large displacements."""
    rng = np.random.default_rng(seed)
    img = torch.zeros(height, width)
    for scale, amp in ((64, 1.0), (16, 0.3), (4, 0.1)):
        g = torch.tensor(rng.uniform(-1, 1, (height // scale + 2, width // scale + 2)).astype(np.float32))
        up = torch.nn.functional.interpolate(g[None, None], scale_factor=scale, mode="bicubic",
                                             align_corners=False)[0, 0]
        img += amp * up[:height, :width]
    img = ((img - img.min()) / (img.max() - img.min())).to(device).contiguous()
    return img, torch.roll(img, shifts=(shift[1], shift[0]), dims=(0, 1)).contiguous()


__all__ = ["SyntheticASLReader", "bench_scene", "shifted_texture_pair"]
