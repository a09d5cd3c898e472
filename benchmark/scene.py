"""The benchmark's scenes, made from ``--seed``: a configuration's proxy
sequence (trajectory, walls of points, IMU with noise and bias walks,
frames).

A frozen copy of ``eqvio_tpu_torch/data/synthetic.py`` and of the set-up in
``eqvio_tpu_torch/runner.py``, built on :mod:`benchmark.frozen`.  The
trajectory, the world and the IMU are made on the host as there, in the
same order of draws.  The frames are rendered on the device: each visible
point's gaussian blob is summed in 2^-32 fixed point (integer sums do not
depend on the order of the atomic adds, so a seed gives the same frames on
every run), and the render noise comes from a ``torch.Generator`` on the
device seeded from the seed, where the port's generator draws it from its
numpy stream.  ``render(..., noise=)`` takes those draws instead, which the
tests use to hold the frames to the port's.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .frozen.camera import EquidistantCamera, RadTanCamera
from .frozen.lie import SE3, se3_inv, se3_mul
from .frozen.sim import Simulator

T0 = 0.2  # the first IMU stamp of every proxy
FIXED_POINT = 2.0 ** 32


class CameraInfo(NamedTuple):
    model: str  # "radtan" | "equidistant"
    intrinsics: tuple  # (fx, fy, cx, cy)
    distortion: tuple
    resolution: tuple  # (width, height)
    T_BS: np.ndarray  # 4x4 camera-to-body extrinsics


class ImageSeq(NamedTuple):
    stamps: np.ndarray
    paths: list


class IMUSeq(NamedTuple):
    stamps: np.ndarray
    gyr: np.ndarray
    acc: np.ndarray


class Scene:
    """A proxy sequence with the dataset readers' interface (``camera``,
    ``imu``, ``images``, ``groundtruth``, ``decoder``, ``load_image_u8``),
    served from memory.  ``frames`` is ``[T, H, W]`` uint8 on the device the
    scene was rendered on, ``host_frames`` the same on the host."""

    decoder = "memory"
    groundtruth = None

    def __init__(self, camera: CameraInfo, imu: IMUSeq, images: ImageSeq, frames: torch.Tensor):
        self.camera, self.imu, self.images = camera, imu, images
        self.frames = frames
        self.host_frames = frames.cpu().numpy()

    def load_image_u8(self, index: int) -> np.ndarray:
        return self.host_frames[index]


def _ns_stamps(times: np.ndarray) -> np.ndarray:
    return np.asarray([float(int(t * 1e9)) for t in times]) * 1e-9


def _csv9(values: np.ndarray) -> np.ndarray:
    return np.vectorize(lambda v: float(f"{v:.9f}"))(np.asarray(values, dtype=np.float64))


def _point_appearance(num_points: int, seed: int):
    r = np.random.default_rng(seed + 90210)
    return r.uniform(0.55, 1.25, num_points), r.uniform(1.8, 5.5, num_points)


def _noisy_imu(sim, imu_times, imu_freq, imu_noise, rng):
    """IMU by pose differentiation plus white noise at ``density * sqrt(f)``
    and integrated bias walks, in the port's order of draws."""
    imu = sim.get_imu_batch(torch.as_tensor(imu_times, dtype=torch.float64))
    gyr, acc = imu.gyr.numpy(), imu.acc.numpy()
    n, sqf = len(imu_times), float(np.sqrt(imu_freq))
    gyr = gyr + rng.normal(scale=imu_noise["gyr"] * sqf, size=(n, 3))
    acc = acc + rng.normal(scale=imu_noise["acc"] * sqf, size=(n, 3))
    sqdt = float(np.sqrt(1.0 / imu_freq))
    gyr += np.cumsum(rng.normal(scale=imu_noise["gyrBias"] * sqdt, size=(n, 3)), axis=0)
    acc += np.cumsum(rng.normal(scale=imu_noise["accBias"] * sqdt, size=(n, 3)), axis=0)
    return gyr, acc


def render(px: torch.Tensor, vis: torch.Tensor, amp: np.ndarray, blob_w: np.ndarray, width: int, height: int,
           noise=None, generator: torch.Generator | None = None, chunk: int = 32) -> torch.Tensor:
    """uint8 frames ``[T, H, W]`` of the points at pixels ``px [T, P, 2]``
    (float64) where ``vis [T, P]``, on ``px``'s device: per point a blob
    ``amp * exp(-d^2 / width)`` over the port's window (radius
    ``ceil(2.5 sqrt(width / 2)) + 1`` around the truncated centre, cut to the
    image, points within 2 px of the border left out), plus noise of
    standard deviation 0.01, clipped to [0, 1], times 255, truncated.
    ``noise(t0, t1)`` gives frames ``t0..t1``'s noise ``[t1 - t0, H, W]``
    (float32); without it, ``generator`` draws it on the device."""
    dev = px.device
    T, P = px.shape[:2]
    radius = np.ceil(2.5 * np.sqrt(blob_w / 2.0)).astype(np.int64) + 1
    R = int(radius.max())
    offs = torch.arange(-R, R + 1, device=dev)
    rad = torch.as_tensor(radius, device=dev)
    a = torch.as_tensor(amp, dtype=torch.float64, device=dev)
    s2 = torch.as_tensor(blob_w, dtype=torch.float64, device=dev)
    in_win = offs.abs()[None, :] <= rad[:, None]  # [P, K]
    out = torch.empty((T, height, width), dtype=torch.uint8, device=dev)
    for t0 in range(0, T, chunk):
        t1 = min(t0 + chunk, T)
        x, y = px[t0:t1, :, 0], px[t0:t1, :, 1]
        ok = vis[t0:t1] & (x > 2) & (x < width - 2) & (y > 2) & (y < height - 2)
        xs = torch.where(ok, x, 3.0)  # keeps the casts finite where a point is left out
        ys = torch.where(ok, y, 3.0)
        cols = xs.to(torch.int64)[..., None] + offs  # [t, P, K]; x > 2, so truncation is floor
        rows = ys.to(torch.int64)[..., None] + offs
        cmask = in_win & (cols >= 0) & (cols < width) & ok[..., None]
        rmask = in_win & (rows >= 0) & (rows < height)
        dx2 = (cols.to(torch.float64) - xs[..., None]) ** 2
        dy2 = (rows.to(torch.float64) - ys[..., None]) ** 2
        val = a[:, None, None] * torch.exp(-(dy2[..., :, None] + dx2[..., None, :]) / s2[:, None, None])
        mask = rmask[..., :, None] & cmask[..., None, :]  # [t, P, K, K]
        frame = torch.arange(t1 - t0, device=dev)[:, None, None, None]
        flat = (frame * height + rows[..., :, None]) * width + cols[..., None, :]
        acc = torch.zeros((t1 - t0) * height * width, dtype=torch.int64, device=dev)
        acc.scatter_add_(0, torch.where(mask, flat, 0).reshape(-1),
                         torch.where(mask, torch.round(val * FIXED_POINT), 0.0).to(torch.int64).reshape(-1))
        img = (acc.to(torch.float64) / FIXED_POINT).to(torch.float32).reshape(t1 - t0, height, width)
        if noise is not None:
            img = img + torch.as_tensor(noise(t0, t1), dtype=torch.float32, device=dev)
        else:
            img = img + torch.randn(img.shape, generator=generator, dtype=torch.float32, device=dev) * 0.01
        out[t0:t1] = (torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
    return out


def _camera(sc: dict, dtype=torch.float64, device="cpu"):
    fx, fy, cx, cy = sc["intrinsics"]
    w, h = sc["width"], sc["height"]
    if sc["camera_model"] == "equidistant":
        return EquidistantCamera.create(fx, fy, cx, cy, tuple(sc["distortion"]), w, h, dtype=dtype, device=device)
    return RadTanCamera.create(fx, fy, cx, cy, tuple(sc["distortion"]), w, h, dtype=dtype, device=device)


def simulator(sc: dict, seed: int) -> Simulator:
    """The trajectory and walls of the whole source sequence
    (``sequence_s``), on the host in float64; a cut keeps its first
    ``end_time`` seconds."""
    return Simulator.create(kind=sc["kind"], end_time=sc["sequence_s"] + 1.0, num_points=sc["num_points"],
                            num_walls=sc["num_walls"], wall_distance=sc["wall_distance"], seed=seed,
                            device="cpu")


def frame_pixels(sim: Simulator, cam, frame_times: np.ndarray, width: int, height: int):
    """Every world point's pixel ``[T, P, 2]`` and visibility ``[T, P]`` at
    ``frame_times``, in float64 on the host (the port's per-frame loop,
    batched over frames)."""
    pose = sim.interpolate_pose(torch.as_tensor(frame_times, dtype=torch.float64))
    cam_inv = se3_inv(se3_mul(pose, SE3(*(a.expand(len(frame_times), *a.shape) for a in sim.camera_offset))))
    pts = torch.einsum("tij,pj->tpi", cam_inv.R, sim.world) + cam_inv.x[:, None, :]
    px = cam.project(pts)
    z = pts[..., 2]
    vis = (z > 0.1) & (px[..., 0] > 0) & (px[..., 0] < width) & (px[..., 1] > 0) & (px[..., 1] < height)
    return px, vis


def scene_params(cfg: dict) -> dict:
    """A configuration file's scene block with its sequence length and cut."""
    return {**cfg["scene"], "end_time": cfg["end_time"], "sequence_s": cfg["sequence_s"]}


def build_scene(sc: dict, seed: int, device, noise=None, lag: float = 0.0) -> Scene:
    """The configuration's proxy sequence ``sc`` (:func:`scene_params`) for
    ``seed``, cut to ``sc["end_time"]`` seconds, frames rendered on
    ``device``.  The images' stamps lag their instants by ``lag`` seconds,
    as the rig's that the configuration's ``cameraLag`` corrects.  ``noise``
    as in :func:`render` (tests only)."""
    sim = simulator(sc, seed)
    w, h = sc["width"], sc["height"]
    imu_freq, frame_freq = sc["imu_freq"], sc["frame_freq"]
    rng = np.random.default_rng(seed)
    amp, blob_w = _point_appearance(sc["num_points"], seed)
    imu_times = np.arange(T0, sc["end_time"], 1.0 / imu_freq)
    gyr, acc = _noisy_imu(sim, imu_times, imu_freq, sc["imu_noise"], rng)
    frame_times = np.arange(T0 + 1.0 / frame_freq, sc["end_time"], 1.0 / frame_freq)
    T_BS = np.eye(4)
    T_BS[:3, :3] = sim.camera_offset.R.numpy()
    T_BS[:3, 3] = sim.camera_offset.x.numpy()
    fx, fy, cx, cy = sc["intrinsics"]
    if sc["camera_model"] == "equidistant":  # the UZH-FPV tree: 9-decimal stamps, T_cam_imu inverted back
        imu = IMUSeq(_csv9(imu_times), _csv9(gyr), _csv9(acc))
        images = ImageSeq(_csv9(frame_times + lag), [f"img/image_{i}.png" for i in range(len(frame_times))])
        T_BS = np.linalg.inv(np.linalg.inv(T_BS))
    else:  # the ASL tree: integer-nanosecond stamps
        imu = IMUSeq(_ns_stamps(imu_times), _csv9(gyr), _csv9(acc))
        images = ImageSeq(_ns_stamps(frame_times + lag), [f"{int(t * 1e9)}.png" for t in frame_times + lag])
    info = CameraInfo(sc["camera_model"], (fx, fy, cx, cy), tuple(sc["distortion"]), (w, h), T_BS)
    px, vis = frame_pixels(sim, _camera(sc), frame_times, w, h)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    frames = render(px.to(device), vis.to(device), amp, blob_w, w, h, noise=noise, generator=gen)
    return Scene(info, imu, images, frames)


def noised_lanes(frames: torch.Tensor, lanes: int, generator: torch.Generator) -> torch.Tensor:
    """``lanes`` copies of ``frames [T, H, W]`` (uint8), each with its own
    pixel noise, uniform in [-3, 3], clipped to [0, 255]: ``[B, T, H, W]``
    on ``frames``' device (the port's ``noised_lanes``, drawn on the
    device)."""
    out = torch.empty((lanes,) + tuple(frames.shape), dtype=torch.uint8, device=frames.device)
    for b in range(lanes):
        n = torch.randint(-3, 4, frames.shape, generator=generator, dtype=torch.int16, device=frames.device)
        out[b] = torch.clamp(frames.to(torch.int16) + n, 0, 255).to(torch.uint8)
    return out
