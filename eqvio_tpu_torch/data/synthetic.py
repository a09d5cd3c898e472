"""Synthetic scenes in memory and as dataset trees (counterpart of
``eqvio_tpu/data/synthetic.py``).

:class:`SyntheticASLReader` and :class:`SyntheticUZHFPVReader` render the
simulator's world points into frames and serve them, with IMU rows and ground
truth, through the dataset readers' interface (``camera``, ``imu``,
``images``, ``groundtruth``, ``load_image_u8``) without writing files.  Every
value passes through the same quantisation as the JAX package's file round
trip (integer-nanosecond or 9-decimal stamps, 9-decimal IMU and
ground-truth rows, uint8 frames, the camchain's inverted ``T_cam_imu``), and
the random draws come in the same order (IMU noise, then each frame's render
noise), so for the same arguments they serve what ``ASLDatasetReader`` and
``UZHFPVDatasetReader`` read back from the JAX generators' trees.

:func:`write_asl_tree` and :func:`write_uzhfpv_tree` write such a scene as
that tree: the CSV and YAML text of the JAX generators byte for byte, the
frames as PNG files.  ``generate_asl_dataset``, ``generate_uzhfpv_dataset``
and the proxy generators build the scene and write it, as the JAX
generators do.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..camera import EquidistantCamera, RadTanCamera
from ..io.writer import rotation_to_quaternion
from ..lie import mv, se3_inv, se3_mul
from ..sim import Simulator
from .asl import CameraInfo, GroundTruth, ImageSeq, IMUSeq


def _render(points_px, visible, w, h, rng, amp, width, grid) -> np.ndarray:
    """Visible points as 2-D gaussian blobs of per-point amplitude and width,
    plus mild noise; ``grid`` is ``np.mgrid[0:h, 0:w]`` in float32."""
    img = np.zeros((h, w), dtype=np.float32)
    ys, xs = grid
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


def _noisy_imu(sim, imu_times, imu_freq, imu_noise, rng):
    """IMU by pose differentiation, plus white noise at ``density *
    sqrt(f)`` and integrated bias walks when ``imu_noise`` is given
    (``{"gyr", "acc", "gyrBias", "accBias"}``)."""
    imu = sim.get_imu_batch(torch.as_tensor(imu_times, dtype=torch.float64))
    gyr, acc = imu.gyr.numpy(), imu.acc.numpy()
    if imu_noise is not None:
        n, sqf = len(imu_times), float(np.sqrt(imu_freq))
        gyr = gyr + rng.normal(scale=imu_noise["gyr"] * sqf, size=(n, 3))
        acc = acc + rng.normal(scale=imu_noise["acc"] * sqf, size=(n, 3))
        sqdt = float(np.sqrt(1.0 / imu_freq))
        gyr += np.cumsum(rng.normal(scale=imu_noise["gyrBias"] * sqdt, size=(n, 3)), axis=0)
        acc += np.cumsum(rng.normal(scale=imu_noise["accBias"] * sqdt, size=(n, 3)), axis=0)
    return gyr, acc


def _distractors(num: int, width: int, height: int, seed: int):
    """Image-pinned distractor blobs: base position, drift amplitude, period
    and phase [num, 2], appearance amplitude and width [num]."""
    drng = np.random.default_rng(seed + 5150)
    base = drng.uniform([0.12 * width, 0.12 * height], [0.88 * width, 0.88 * height], size=(num, 2))
    ampl = drng.uniform(6.0, 18.0, size=(num, 2))
    period = drng.uniform(9.0, 23.0, size=(num, 2))
    phase = drng.uniform(0, 2 * np.pi, size=(num, 2))
    return base, ampl, period, phase, drng.uniform(1.0, 1.3, num), drng.uniform(2.2, 4.5, num)


def _render_frames(sim, cam, frame_times, width, height, rng, amp, blob_w, distractors=None) -> list:
    """uint8 frames of the world points seen through ``cam`` at ``frame_times``,
    plus the image-pinned ``distractors`` (:func:`_distractors`) if given."""
    grid = np.mgrid[0:height, 0:width].astype(np.float32)
    frames = []
    for t in frame_times:
        pose = sim.interpolate_pose(torch.tensor(t, dtype=torch.float64))
        cam_inv = se3_inv(se3_mul(pose, sim.camera_offset))
        pts = mv(cam_inv.R, sim.world) + cam_inv.x
        px = cam.project(pts).numpy()
        z = pts[:, 2].numpy()
        vis = (z > 0.1) & (px[:, 0] > 0) & (px[:, 0] < width) & (px[:, 1] > 0) & (px[:, 1] < height)
        ramp, rwidth = amp, blob_w
        if distractors is not None:
            base, ampl, period, phase, d_amp, d_width = distractors
            px = np.concatenate([px, base + ampl * np.sin(2 * np.pi * t / period + phase)])
            vis = np.concatenate([vis, np.ones(len(base), dtype=bool)])
            ramp, rwidth = np.concatenate([amp, d_amp]), np.concatenate([blob_w, d_width])
        img = _render(px, vis, width, height, rng, ramp, rwidth, grid)
        frames.append((img * 255).astype(np.uint8))
    return frames


class SyntheticASLReader:
    """The synthetic scene of ``generate_asl_dataset`` served from memory:
    optional radial-tangential distortion, IMU noise with bias walks, a
    ground-truth rate of its own, walls and distractor blobs."""

    decoder = "memory"

    def __init__(self, end_time: float = 5.0, imu_freq: float = 200.0, frame_freq: float = 20.0,
                 width: int = 320, height: int = 240, num_points: int = 400, seed: int = 0,
                 kind: str = "wave", intrinsics: tuple | None = None, distortion: tuple | None = None,
                 imu_noise: dict | None = None, gt_freq: float | None = None, num_walls: int = 4,
                 wall_distance: float = 2.0, num_distractors: int = 0):
        f64 = torch.float64
        # the frames are rendered on the host
        sim = Simulator.create(kind=kind, end_time=end_time + 1.0, num_points=num_points,
                               num_walls=num_walls, seed=seed, wall_distance=wall_distance, device="cpu")
        if intrinsics is None:
            fx = fy = 200.0
            cx, cy = width / 2, height / 2
        else:
            fx, fy, cx, cy = intrinsics
        dist = tuple(distortion) if distortion is not None else (0.0, 0.0, 0.0, 0.0)
        cam = RadTanCamera.create(fx, fy, cx, cy, dist, width, height, dtype=f64, device="cpu")
        rng = np.random.default_rng(seed)
        amp, blob_w = _point_appearance(num_points, seed)
        t0 = 0.2

        imu_times = np.arange(t0, end_time, 1.0 / imu_freq)
        gyr, acc = _noisy_imu(sim, imu_times, imu_freq, imu_noise, rng)
        self.imu = IMUSeq(_ns_stamps(imu_times), _csv9(gyr), _csv9(acc))
        self.sim, self.frame_freq = sim, frame_freq

        T_BS = np.eye(4)
        T_BS[:3, :3] = sim.camera_offset.R.numpy()
        T_BS[:3, 3] = sim.camera_offset.x.numpy()
        self.camera = CameraInfo("radtan", (fx, fy, cx, cy), dist, (width, height), T_BS)

        distractors = _distractors(num_distractors, width, height, seed) if num_distractors > 0 else None
        frame_times = np.arange(t0 + 1.0 / frame_freq, end_time, 1.0 / frame_freq)
        self.frames = _render_frames(sim, cam, frame_times, width, height, rng, amp, blob_w, distractors)
        self.images = ImageSeq(_ns_stamps(frame_times),
                               [f"{int(t * 1e9)}.png" for t in frame_times])

        gt_times = np.arange(t0, end_time, 1.0 / (gt_freq or frame_freq))
        # the integer-nanosecond stamps of the tree's CSVs
        self.stamps_ns = {name: [int(t * 1e9) for t in times]
                          for name, times in (("imu", imu_times), ("frames", frame_times), ("gt", gt_times))}
        pose, vel = sim.true_pose_velocity(torch.as_tensor(gt_times, dtype=f64))
        q = rotation_to_quaternion(pose.R.numpy())
        v_inertial = mv(pose.R, vel).numpy()
        self.groundtruth = GroundTruth(
            _ns_stamps(gt_times), _csv9(pose.x.numpy()), _csv9(q), _csv9(v_inertial)
        )

    def load_image_u8(self, index: int) -> np.ndarray:
        return self.frames[index]


class SyntheticUZHFPVReader:
    """The synthetic scene of ``generate_uzhfpv_dataset`` (equidistant
    fisheye, optional IMU noise), served from memory."""

    decoder = "memory"

    def __init__(self, end_time: float = 4.0, imu_freq: float = 200.0, frame_freq: float = 10.0,
                 width: int = 320, height: int = 240, num_points: int = 300, seed: int = 0,
                 kind: str = "wave", intrinsics: tuple | None = None,
                 distortion: tuple = (0.01, -0.005, 0.001, 0.0), imu_noise: dict | None = None,
                 num_walls: int = 4, wall_distance: float = 2.0):
        f64 = torch.float64
        # the frames are rendered on the host
        sim = Simulator.create(kind=kind, end_time=end_time + 1.0, num_points=num_points,
                               num_walls=num_walls, wall_distance=wall_distance, seed=seed, device="cpu")
        if intrinsics is None:
            fx = fy = 140.0
            cx, cy = width / 2, height / 2
        else:
            fx, fy, cx, cy = intrinsics
        dist = tuple(distortion)
        cam = EquidistantCamera.create(fx, fy, cx, cy, dist, width, height, dtype=f64, device="cpu")
        rng = np.random.default_rng(seed)
        amp, blob_w = _point_appearance(num_points, seed)
        t0 = 0.2

        imu_times = np.arange(t0, end_time, 1.0 / imu_freq)
        gyr, acc = _noisy_imu(sim, imu_times, imu_freq, imu_noise, rng)
        self.imu = IMUSeq(_csv9(imu_times), _csv9(gyr), _csv9(acc))

        # the camchain holds T_cam_imu, the inverse offset; the reader inverts it back
        T_BS = np.eye(4)
        T_BS[:3, :3] = sim.camera_offset.R.numpy()
        T_BS[:3, 3] = sim.camera_offset.x.numpy()
        self.camera = CameraInfo("equidistant", (fx, fy, cx, cy), dist, (width, height),
                                 np.linalg.inv(np.linalg.inv(T_BS)))
        self.sim, self.T_cam_imu = sim, np.linalg.inv(T_BS)

        frame_times = np.arange(t0 + 1.0 / frame_freq, end_time, 1.0 / frame_freq)
        self.frames = _render_frames(sim, cam, frame_times, width, height, rng, amp, blob_w)
        self.images = ImageSeq(_csv9(frame_times), [f"img/image_{i}.png" for i in range(len(frame_times))])

        pose, _ = sim.true_pose_velocity(torch.as_tensor(frame_times, dtype=f64))
        self.groundtruth = GroundTruth(_csv9(frame_times), _csv9(pose.x.numpy()),
                                       _csv9(rotation_to_quaternion(pose.R.numpy())), None)

    def load_image_u8(self, index: int) -> np.ndarray:
        return self.frames[index]


# UZH-FPV indoor (Snapdragon + fisheye) style calibration of the racing proxy
UZHFPV_CAM_INTRINSICS = (278.66, 278.48, 319.75, 241.96)
UZHFPV_CAM_DISTORTION = (-0.013721808247486035, 0.020727425669427896,
                         -0.012786476702685545, 0.0025242267320687625)
# the sensor's true noise densities (MEMS data-sheet magnitudes); the filter
# keeps the tuned config's velocityNoise
RACING_IMU_NOISE = {"gyr": 3.0e-04, "acc": 2.0e-03, "gyrBias": 4.0e-05, "accBias": 3.0e-03}


def racing_proxy(end_time: float = 60.0, seed: int = 13) -> SyntheticUZHFPVReader:
    """The racing proxy of ``generate_racing_proxy``: a drone-racing
    figure-eight (``racing`` trajectory) seen at 640x480 and 30 Hz through
    an equidistant fisheye, a 500 Hz IMU with noise and bias walks, 1600
    points on 6 walls 4 m out."""
    return SyntheticUZHFPVReader(end_time=end_time, imu_freq=500.0, frame_freq=30.0, width=640, height=480,
                                 num_points=1600, seed=seed, kind="racing", intrinsics=UZHFPV_CAM_INTRINSICS,
                                 distortion=UZHFPV_CAM_DISTORTION, imu_noise=RACING_IMU_NOISE, num_walls=6,
                                 wall_distance=4.0)


# EuRoC cam0 (MT9V034, radial-tangential) public calibration of the EuRoC proxies
EUROC_CAM0_INTRINSICS = (458.654, 457.296, 367.215, 248.375)
EUROC_CAM0_DISTORTION = (-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05)
# the EuRoC sensor's true noise densities (ADIS16448 data sheet); the filter
# keeps the tuned config's velocityNoise
EUROC_IMU_NOISE = {"gyr": 1.6968e-04, "acc": 2.0000e-03, "gyrBias": 1.9393e-05, "accBias": 3.0000e-03}


def _euroc_proxy(end_time: float, seed: int, kind: str, num_points: int, **extra) -> SyntheticASLReader:
    return SyntheticASLReader(end_time=end_time, imu_freq=200.0, frame_freq=20.0, width=752, height=480,
                              num_points=num_points, seed=seed, kind=kind, intrinsics=EUROC_CAM0_INTRINSICS,
                              distortion=EUROC_CAM0_DISTORTION, imu_noise=EUROC_IMU_NOISE, gt_freq=100.0,
                              num_walls=6, **extra)


def v101_proxy(end_time: float = 144.0, seed: int = 11) -> SyntheticASLReader:
    """The V1_01 proxy of ``generate_v101_proxy``: a 144 s ``room``
    trajectory with V1_01's path length, 752x480 at 20 Hz through the EuRoC
    cam0 calibration, 200 Hz IMU with noise and bias walks, 900 points on 6
    walls, 100 Hz ground truth."""
    return _euroc_proxy(end_time, seed, "room", 900)


def mh03_proxy(end_time: float = 132.0, seed: int = 17) -> SyntheticASLReader:
    """The MH_03 proxy of ``generate_mh03_proxy``: a 132 s ``mh`` machine-hall
    sweep with MH_03's path length, 1,400 points on 6 walls 2.5 m out,
    otherwise as :func:`v101_proxy`."""
    return _euroc_proxy(end_time, seed, "mh", 1400, wall_distance=2.5)


def distractor_proxy(end_time: float = 45.0, seed: int = 21, num_distractors: int = 8) -> SyntheticASLReader:
    """The distractor scene of ``generate_distractor_proxy``: the V1_01
    proxy's room motion with image-pinned distractor blobs."""
    return _euroc_proxy(end_time, seed, "room", 900, num_distractors=num_distractors)


def bench_scene(end_time: float = 8.0) -> SyntheticASLReader:
    """The benchmark scene (752x480 frames at 20 Hz, 200 Hz IMU, 600 points,
    seed 4, room trajectory with a stationary start), cut to ``end_time``
    seconds."""
    return SyntheticASLReader(end_time=end_time, imu_freq=200.0, frame_freq=20.0, width=752,
                              height=480, num_points=600, seed=4, kind="room")


def _f9(values) -> str:
    return ",".join(f"{v:.9f}" for v in values)


def _write_pngs(frames, paths, workers: int = 8) -> None:
    """uint8 frames as 8-bit grayscale PNG files (zlib level 1; PIL's encoder
    runs outside the interpreter lock, so threads overlap it)."""
    from PIL import Image

    def save(frame, path):
        Image.fromarray(frame).save(path, compress_level=1)

    with ThreadPoolExecutor(workers) as pool:
        for fut in [pool.submit(save, f, p) for f, p in zip(frames, paths)]:
            fut.result()


def write_asl_tree(reader: SyntheticASLReader, out_dir: str) -> None:
    """The scene of ``reader`` as an ASL (EuRoC) tree under ``out_dir``:
    ``mav0/imu0/data.csv``, ``mav0/cam0/{data.csv, sensor.yaml, data/*.png}``
    and ``mav0/state_groundtruth_estimate0/data.csv``, in the JAX
    generator's text."""
    base = os.path.join(out_dir, "mav0")
    for sub in ("imu0", "cam0/data", "state_groundtruth_estimate0"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
    ns = reader.stamps_ns
    with open(os.path.join(base, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for t, g, a in zip(ns["imu"], reader.imu.gyr, reader.imu.acc):
            f.write(f"{t}," + _f9([*g, *a]) + "\n")
    cam = reader.camera
    (fx, fy, cx, cy), (width, height) = cam.intrinsics, cam.resolution
    with open(os.path.join(base, "cam0", "sensor.yaml"), "w") as f:
        f.write(
            "sensor_type: camera\n"
            f"T_BS:\n  rows: 4\n  cols: 4\n  data: {cam.T_BS.reshape(-1).tolist()}\n"
            f"rate_hz: {reader.frame_freq}\n"
            f"resolution: [{width}, {height}]\n"
            "camera_model: pinhole\n"
            f"intrinsics: [{fx}, {fy}, {cx}, {cy}]\n"
            "distortion_model: radial-tangential\n"
            f"distortion_coefficients: {list(cam.distortion)}\n"
        )
    with open(os.path.join(base, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        for t, name in zip(ns["frames"], reader.images.paths):
            f.write(f"{t},{name}\n")
    _write_pngs(reader.frames, [os.path.join(base, "cam0", "data", name) for name in reader.images.paths])
    gt = reader.groundtruth
    with open(os.path.join(base, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z [], "
                "v_RS_R_x [m s^-1], v_RS_R_y [m s^-1], v_RS_R_z [m s^-1]\n")
        for t, p, q, v in zip(ns["gt"], gt.position, gt.quaternion, gt.velocity):
            f.write(f"{t}," + _f9([*p, *q, *v]) + "\n")


def write_uzhfpv_tree(reader: SyntheticUZHFPVReader, out_dir: str) -> None:
    """The scene of ``reader`` as a UZH-FPV tree under ``out_dir``:
    ``imu.txt``, ``left_images.txt``, ``camchain-imucam.yaml`` (equidistant,
    ``T_cam_imu``), ``img/*.png`` and ``groundtruth.txt``, in the JAX
    generator's text."""
    import yaml

    os.makedirs(os.path.join(out_dir, "img"), exist_ok=True)
    with open(os.path.join(out_dir, "imu.txt"), "w") as f:
        f.write("# id timestamp wx wy wz ax ay az\n")
        for i, (t, g, a) in enumerate(zip(reader.imu.stamps, reader.imu.gyr, reader.imu.acc)):
            f.write(f"{i} {t:.9f} " + _f9([*g, *a]).replace(",", " ") + "\n")
    cam = reader.camera
    with open(os.path.join(out_dir, "camchain-imucam.yaml"), "w") as f:
        yaml.safe_dump({"cam0": {
            "camera_model": "pinhole",
            "distortion_model": "equidistant",
            "intrinsics": list(cam.intrinsics),
            "distortion_coeffs": list(cam.distortion),
            "resolution": list(cam.resolution),
            "T_cam_imu": reader.T_cam_imu.tolist(),
        }}, f)
    with open(os.path.join(out_dir, "left_images.txt"), "w") as f:
        f.write("# id timestamp image_name\n")
        for i, (t, name) in enumerate(zip(reader.images.stamps, reader.images.paths)):
            f.write(f"{i} {t:.9f} {name}\n")
    _write_pngs(reader.frames, [os.path.join(out_dir, name) for name in reader.images.paths])
    gt = reader.groundtruth
    with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
        f.write("# id timestamp tx ty tz qx qy qz qw\n")
        for i, (t, p, q) in enumerate(zip(gt.stamps, gt.position, gt.quaternion)):
            f.write(f"{i} {t:.9f} " + _f9([*p, q[1], q[2], q[3], q[0]]).replace(",", " ") + "\n")


def generate_asl_dataset(out_dir: str, **scene) -> Simulator:
    """Write the :class:`SyntheticASLReader` scene of ``scene`` (its keyword
    arguments) as an ASL tree under ``out_dir``; returns its simulator."""
    reader = SyntheticASLReader(**scene)
    write_asl_tree(reader, out_dir)
    return reader.sim


def generate_uzhfpv_dataset(out_dir: str, **scene) -> Simulator:
    """Write the :class:`SyntheticUZHFPVReader` scene of ``scene`` as a
    UZH-FPV tree under ``out_dir``; returns its simulator."""
    reader = SyntheticUZHFPVReader(**scene)
    write_uzhfpv_tree(reader, out_dir)
    return reader.sim


def _motion_stats(sim: Simulator, end_time: float) -> dict:
    """Duration, path length, mean and largest speed and angular rate of the
    simulator's trajectory up to ``end_time``."""
    x, t, R = sim.poses.x.numpy(), sim.times.numpy(), sim.poses.R.numpy()
    seg = np.linalg.norm(np.diff(x, axis=0), axis=1)
    speed = seg / np.diff(t)
    dR = np.einsum("tij,tik->tjk", R[:-1], R[1:])  # R_k^T R_{k+1}
    ang_rate = np.arccos(np.clip((np.trace(dR, axis1=1, axis2=2) - 1) / 2, -1, 1)) / np.diff(t)
    mask = t[:-1] < end_time
    return {
        "duration_s": float(min(end_time, t[-1])),
        "path_length_m": float(seg[mask].sum()),
        "mean_speed_mps": float(speed[mask].mean()),
        "max_speed_mps": float(speed[mask].max()),
        "mean_ang_rate_radps": float(ang_rate[mask].mean()),
        "max_ang_rate_radps": float(ang_rate[mask].max()),
    }


def _write_proxy(out_dir: str, reader, stats: dict):
    import yaml

    (write_asl_tree if isinstance(reader, SyntheticASLReader) else write_uzhfpv_tree)(reader, out_dir)
    with open(os.path.join(out_dir, "proxy_info.yaml"), "w") as f:
        yaml.safe_dump(stats, f)
    return reader.sim, stats


def generate_v101_proxy(out_dir: str, end_time: float = 144.0, seed: int = 11):
    """Write the V1_01 proxy (:func:`v101_proxy`) as an ASL tree with its
    motion statistics against V1_01's in ``proxy_info.yaml``; returns
    ``(sim, stats)``."""
    reader = v101_proxy(end_time, seed)
    stats = {**_motion_stats(reader.sim, end_time), "targets_v101": {
        "duration_s": 144.0, "path_length_m": 58.56120400739347, "mean_speed_mps": 58.56120400739347 / 144.0}}
    return _write_proxy(out_dir, reader, stats)


def generate_mh03_proxy(out_dir: str, end_time: float = 132.0, seed: int = 17, reader=None):
    """Write the MH_03 proxy (:func:`mh03_proxy`) as an ASL tree with its
    motion statistics against MH_03's in ``proxy_info.yaml``; returns
    ``(sim, stats)``.  ``reader``: that scene, already built (it takes
    tens of seconds to render at full length)."""
    reader = reader or mh03_proxy(end_time, seed)
    stats = {**_motion_stats(reader.sim, end_time), "targets_mh03": {
        "duration_s": 132.0, "path_length_m": 127.35526466112435, "mean_speed_mps": 127.35526466112435 / 132.0}}
    return _write_proxy(out_dir, reader, stats)


def generate_distractor_proxy(out_dir: str, end_time: float = 45.0, seed: int = 21, num_distractors: int = 8):
    """Write the distractor scene (:func:`distractor_proxy`) as an ASL tree;
    returns ``(sim, stats)``."""
    reader = distractor_proxy(end_time, seed, num_distractors)
    return _write_proxy(out_dir, reader, {"duration_s": float(end_time), "num_distractors": num_distractors})


def generate_racing_proxy(out_dir: str, end_time: float = 60.0, seed: int = 13):
    """Write the racing proxy (:func:`racing_proxy`) as a UZH-FPV tree with
    its motion statistics in ``proxy_info.yaml``; returns ``(sim, stats)``."""
    reader = racing_proxy(end_time, seed)
    return _write_proxy(out_dir, reader, _motion_stats(reader.sim, end_time))


def shifted_texture_pair(height: int, width: int, shift: tuple[int, int], seed: int = 5,
                         device="cuda") -> tuple[torch.Tensor, torch.Tensor]:
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


def noised_lanes(imgs: np.ndarray, batch: int, noise_seed: int = 7) -> np.ndarray:
    """``batch`` copies of the frames ``imgs [T, H, W]`` (uint8), each with
    its own pixel noise in [-3, 3] from ``np.random.default_rng(noise_seed)``,
    drawn lane after lane as the JAX package's ``bench_batch_full_frame``
    draws it, so lane b's frames are its lane b's bit for bit: ``[B, T, H, W]``."""
    rng = np.random.default_rng(noise_seed)
    return np.stack([
        np.clip(imgs.astype(np.int16) + rng.integers(-3, 4, imgs.shape, dtype=np.int16), 0, 255).astype(np.uint8)
        for _ in range(batch)
    ])


__all__ = ["SyntheticASLReader", "SyntheticUZHFPVReader", "bench_scene", "distractor_proxy",
           "generate_asl_dataset", "generate_distractor_proxy", "generate_mh03_proxy", "generate_racing_proxy",
           "generate_uzhfpv_dataset", "generate_v101_proxy", "mh03_proxy", "noised_lanes", "racing_proxy",
           "shifted_texture_pair", "v101_proxy", "write_asl_tree", "write_uzhfpv_tree"]
