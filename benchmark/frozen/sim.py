"""Synthetic VIO simulator (counterpart of ``eqvio_tpu/sim.py``): named
trajectories, wall points, pose interpolation, IMU by pose differentiation,
the exact true state and per-frame feature selection (the program's slot
tracker is not copied: no cell runs the simulation runner).

Scene generation is set-up, not the hot path: it runs on the device it is
given (the CPU by default) and is batched over query times, where the JAX
package vmaps a per-time function.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .lie import SE3, mv, se3_exp, se3_inv, se3_log, se3_mul, so3_exp, so3_log
from .runtime import const
from .states import GRAVITY, IMU, DUMMY_POINT, VIOSensorState, VIOState


def _rot_z(ang):
    z = torch.zeros_like(ang)
    return so3_exp(torch.stack([z, z, ang], dim=-1))


def _unwrap(p: torch.Tensor) -> torch.Tensor:
    """``numpy.unwrap`` along the last axis (period 2 pi), in its operation order."""
    dd = torch.diff(p)
    ddmod = torch.remainder(dd + math.pi, 2 * math.pi) - math.pi
    ddmod = torch.where((ddmod == -math.pi) & (dd > 0), torch.full_like(ddmod, math.pi), ddmod)
    correct = torch.where(torch.abs(dd) < math.pi, torch.zeros_like(dd), ddmod - dd)
    return torch.cat([p[..., :1], p[..., 1:] + torch.cumsum(correct, dim=-1)], dim=-1)


def _gradient(f: torch.Tensor, h: float) -> torch.Tensor:
    """``numpy.gradient`` along axis 0 with spacing ``h``: central differences
    inside, one-sided at the ends (the JAX package's operation order)."""
    inner = (f[2:] - f[:-2]) * 0.5 / h
    return torch.cat([(f[1:2] - f[0:1]) / h, inner, (f[-1:] - f[-2:-1]) / h], dim=0)


def _body_attitude(yaw, pitch, roll):
    zero = torch.zeros_like(yaw)
    Rz = so3_exp(torch.stack([zero, zero, yaw], dim=-1))
    Ry = so3_exp(torch.stack([zero, pitch, zero], dim=-1))
    Rx = so3_exp(torch.stack([roll, zero, zero], dim=-1))
    return torch.einsum("tij,tjk,tkl->til", Rz, Ry, Rx)


def _stationary_start(t):
    """The hold-then-ramp time parameter of the EuRoC-like kinds: 3 s at rest."""
    u = torch.clamp(t - 3.0, min=0.0)
    return u - 2.0 * (1.0 - torch.exp(-u / 2.0))


def trajectory_poses(kind: str, end_time: float, frequency: float, dtype=torch.float64, device="cuda"):
    """Stamped poses ``[T]`` of a named trajectory: ``(t, SE3)``.

    Kinds: ``line``, ``wave``, ``sine``, ``square``, ``room`` (alias
    ``v101``: EuRoC V1_01-like), ``mh`` (alias ``machine_hall``: EuRoC
    MH_03-like) and ``racing`` (UZH-FPV-like)."""
    num = int(np.floor(end_time * frequency))
    t = torch.arange(num, dtype=dtype, device=device) / frequency
    two_pi = 2 * math.pi
    s = torch.sin
    if kind == "line":
        coord = 5.0 * (2.0 * (t + s(t * 2 * math.pi / 10.0)) / end_time - 1.0)
        zero = torch.zeros_like(t)
        x = torch.stack([zero, coord, zero], dim=-1)
        R = torch.eye(3, dtype=dtype, device=device).expand(num, 3, 3)
    elif kind == "wave":
        ang = 2 * math.pi * t / 20.0
        R = _rot_z(ang)
        x = torch.stack([torch.cos(ang), s(ang), 0.2 * s(10 * ang)], dim=-1)
    elif kind == "sine":
        ang = 2 * math.pi * t / 20.0
        R = _rot_z(ang)
        x = torch.stack([torch.cos(ang), s(ang), 0.1 * s(5 * ang)], dim=-1)
    elif kind in ("room", "v101"):
        # EuRoC V1_01-like room trajectory with a 3 s stationary start, scaled
        # so a 144 s run has V1_01's path length (58.56 m)
        tau = _stationary_start(t)
        scale = 58.56 / 65.14
        x = scale * torch.stack(
            [
                1.30 * s(two_pi * tau / 27.0) + 0.33 * s(two_pi * tau / 7.8)
                + 0.055 * s(two_pi * tau / 1.5),
                1.30 * s(two_pi * tau / 22.0 + 1.0) + 0.33 * torch.cos(two_pi * tau / 9.2)
                + 0.055 * s(two_pi * tau / 1.7 + 0.8),
                0.35 * s(two_pi * tau / 12.0) + 0.12 * s(two_pi * tau / 5.3)
                + 0.04 * s(two_pi * tau / 1.9 + 1.7),
            ],
            dim=-1,
        )
        yaw = (0.9 * s(two_pi * tau / 23.0) + 0.35 * s(two_pi * tau / 7.0)
               + 0.05 * s(two_pi * tau / 1.6))
        roll = 0.12 * s(two_pi * tau / 4.3) + 0.05 * s(two_pi * tau / 1.4)
        pitch = 0.12 * torch.cos(two_pi * tau / 5.7) + 0.05 * torch.cos(two_pi * tau / 1.6 + 0.5)
        R = _body_attitude(yaw, pitch, roll)
    elif kind in ("mh", "machine_hall"):
        # EuRoC MH_03-like machine-hall sweep with a 3 s stationary start,
        # scaled so a 132 s run has MH_03's path length (127.355 m)
        tau = _stationary_start(t)
        scale = 127.35526466112435 / 127.650055
        x = scale * torch.stack(
            [
                4.5 * s(two_pi * tau / 40.0) + 1.3 * s(two_pi * tau / 11.0)
                + 0.18 * s(two_pi * tau / 2.1),
                2.3 * s(two_pi * tau / 31.0 + 0.7) + 1.0 * torch.cos(two_pi * tau / 13.0)
                + 0.18 * s(two_pi * tau / 2.4 + 0.8),
                1.1 * s(two_pi * tau / 17.0) + 0.4 * s(two_pi * tau / 6.3)
                + 0.10 * s(two_pi * tau / 2.0 + 1.2),
            ],
            dim=-1,
        )
        yaw = (1.4 * s(two_pi * tau / 37.0) + 0.5 * s(two_pi * tau / 9.0)
               + 0.08 * s(two_pi * tau / 2.2))
        roll = 0.18 * s(two_pi * tau / 5.1) + 0.07 * s(two_pi * tau / 1.7)
        pitch = 0.18 * torch.cos(two_pi * tau / 6.4) + 0.07 * torch.cos(two_pi * tau / 2.0 + 0.5)
        R = _body_attitude(yaw, pitch, roll)
    elif kind == "racing":
        # drone-racing figure-eight in an ~18x9x2 m hall with a 3 s stationary
        # start, yaw along the track tangent, banking from yaw rate x speed
        tau = _stationary_start(t)
        A, B = 9.0, 4.5
        x = torch.stack(
            [
                A * s(two_pi * tau / 14.0),
                B * s(2 * two_pi * tau / 14.0),
                1.0 + 0.8 * s(two_pi * tau / 6.5),
            ],
            dim=-1,
        )
        dxdtau = A * (two_pi / 14.0) * torch.cos(two_pi * tau / 14.0)
        dydtau = B * (2 * two_pi / 14.0) * torch.cos(2 * two_pi * tau / 14.0)
        yaw = _unwrap(torch.atan2(dydtau, dxdtau))
        dt_s = 1.0 / frequency
        speed = torch.linalg.norm(_gradient(x, dt_s), dim=-1)
        roll = torch.clamp(torch.atan(_gradient(yaw, dt_s) * speed / 9.81), -0.6, 0.6)
        pitch = torch.clamp(-0.05 * _gradient(speed, dt_s), -0.3, 0.3)
        R = _body_attitude(yaw, pitch, roll)
    elif kind == "square":
        square_time = 20.0
        R = _rot_z(-2 * math.pi * t / square_time)
        s01 = (t / square_time * 4) - torch.floor(t / square_time * 4)
        d = -1.0 + 2.0 * s(s01 / 2 * math.pi) ** 2
        side = torch.floor(t / square_time * 4).to(torch.int32) % 4
        one = torch.ones_like(d)
        px = torch.where(side == 0, d, torch.where(side == 1, one, torch.where(side == 2, -d, -one)))
        py = torch.where(side == 0, one, torch.where(side == 1, -d, torch.where(side == 2, -one, d)))
        x = torch.stack([px, py, torch.zeros_like(d)], dim=-1)
    else:
        raise ValueError(f"unknown trajectory kind {kind!r}")
    return t, SE3(R, x)


def generate_world_points(poses_x: np.ndarray, num: int, distance: float, num_walls: int,
                          seed: int) -> np.ndarray:
    """Random points on 1-6 walls around the trajectory's bounding box."""
    rng = np.random.default_rng(seed)
    lo = poses_x.min(axis=0)
    hi = poses_x.max(axis=0)
    temp = 0.8 * np.array([float(num_walls > 0), float(num_walls > 1), float(num_walls > 3)]) + 0.2
    scaling = hi - lo + 2 * distance * temp
    offset = lo - distance * temp
    pts = rng.uniform(0, 1, size=(num, 3)) * scaling + offset
    for i in range(num):
        wall = (num_walls * i) // num
        if wall == 0:
            pts[i, 0] = offset[0] + scaling[0]
        elif wall == 1:
            pts[i, 1] = offset[1] + scaling[1]
        elif wall == 2:
            pts[i, 1] = offset[1]
        elif wall == 3:
            pts[i, 0] = offset[0]
        elif wall == 4:
            pts[i, 2] = offset[2]
        else:
            pts[i, 2] = offset[2] + scaling[2]
    return pts


class Simulator(NamedTuple):
    times: torch.Tensor  # [T]
    poses: SE3  # [T]
    world: torch.Tensor  # [P, 3] inertial points (ids 0..P-1)
    camera_offset: SE3

    @staticmethod
    def create(kind="wave", end_time=60.0, pose_frequency=100.0, num_points=1000, wall_distance=2.0,
               num_walls=1, seed=0, camera_offset: SE3 | None = None, dtype=torch.float64, device="cuda"):
        t, poses = trajectory_poses(kind, end_time, pose_frequency, dtype, device)
        world = generate_world_points(poses.x.cpu().numpy(), num_points, wall_distance, num_walls, seed)
        if camera_offset is None:
            # z-forward camera mounted on the body x-axis
            cam_R = torch.tensor(
                [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], dtype=dtype, device=device
            ).T
            camera_offset = SE3(cam_R, torch.zeros(3, dtype=dtype, device=device))
        return Simulator(t, poses, torch.as_tensor(world, dtype=dtype, device=device), camera_offset)

    @staticmethod
    def from_poses(times, poses: SE3, camera_offset: SE3, num_points: int = 1000, wall_distance: float = 2.0,
                   num_walls: int = 4, seed: int = 0, dtype=torch.float64, device="cuda") -> "Simulator":
        """A simulator around an arbitrary stamped trajectory (such as a
        dataset's ground truth)."""
        f = lambda a: torch.as_tensor(a, dtype=dtype, device=device).contiguous()  # noqa: E731
        x = f(poses.x)
        world = generate_world_points(x.cpu().numpy(), num_points, wall_distance, num_walls, seed)
        return Simulator(f(times), SE3(f(poses.R), x), f(world), camera_offset)

    def _index(self, t: torch.Tensor) -> torch.Tensor:
        """Index of the first pose stamped >= t, clamped to [2, T-2]."""
        i = torch.searchsorted(self.times, t)
        return torch.clamp(i, 2, self.times.shape[0] - 2)

    def interpolate_pose(self, t: torch.Tensor) -> SE3:
        """Constant-twist interpolation between the bracketing poses (batched over t)."""
        i = self._index(t)
        p0 = SE3(self.poses.R[i - 1], self.poses.x[i - 1])
        p1 = SE3(self.poses.R[i], self.poses.x[i])
        t0, t1 = self.times[i - 1], self.times[i]
        vel = se3_log(se3_mul(se3_inv(p0), p1)) / (t1 - t0)[..., None]
        return se3_mul(p0, se3_exp(vel * (t - t0)[..., None]))

    def _inertial_states(self, t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
        taus = torch.stack([self.times[i - 2], self.times[i - 1], self.times[i], self.times[i + 1]],
                           dim=-1) - t[..., None]
        Xp = torch.stack([self.poses.x[i - 2], self.poses.x[i - 1], self.poses.x[i],
                          self.poses.x[i + 1]], dim=-1)  # [..., 3, 4]
        TT = torch.stack([torch.ones_like(taus), taus, taus**2 / 2.0, taus**3 / 6.0], dim=-2)
        TTt = TT.transpose(-1, -2)
        A = Xp @ TTt @ torch.linalg.inv_ex(TT @ TTt)[0]
        return A[..., 0:3]

    def inertial_states(self, t: torch.Tensor) -> torch.Tensor:
        """``[..., 3, 3]`` inertial (position | velocity | acceleration) from a
        cubic least-squares fit over the 4 bracketing poses."""
        return self._inertial_states(t, self._index(t))

    def _attitude(self, t: torch.Tensor, i: torch.Tensor):
        R0 = self.poses.R[i - 1]
        t0, t1 = self.times[i - 1], self.times[i]
        gyr = so3_log(R0.transpose(-1, -2) @ self.poses.R[i]) / (t1 - t0)[..., None]
        return gyr, R0 @ so3_exp((t - t0)[..., None] * gyr)

    def get_imu(self, t: torch.Tensor) -> IMU:
        """IMU at stamps ``t`` (any shape) by pose differentiation."""
        i = self._index(t)
        gyr, att = self._attitude(t, i)
        accel_inertial = self._inertial_states(t, i)[..., 2]
        grav = torch.tensor([0.0, 0.0, -GRAVITY], dtype=t.dtype, device=t.device)
        acc = mv(att.transpose(-1, -2), accel_inertial - grav)
        return IMU.create(t, gyr, acc, dtype=t.dtype, device=t.device)

    get_imu_batch = get_imu

    def true_pose_velocity(self, ts: torch.Tensor):
        """True ``(pose SE3, body velocity)`` at stamps ``ts``."""
        i = self._index(ts)
        _, att = self._attitude(ts, i)
        states = self._inertial_states(ts, i)
        return SE3(att, states[..., 0]), mv(att.transpose(-1, -2), states[..., 1])

    def _camera_points(self, pose: SE3) -> torch.Tensor:
        """Every world point in the camera frame of ``pose`` ``[...]``: ``[..., P, 3]``."""
        cam_pose_inv = se3_inv(se3_mul(pose, self.camera_offset))
        return torch.einsum("...ij,pj->...pi", cam_pose_inv.R, self.world) + cam_pose_inv.x[..., None, :]

    def full_state(self, t: torch.Tensor, capacity: int = 0) -> VIOState:
        """Exact true state at stamps ``t`` (any shape); the landmarks hold
        every world point in the camera frame (ids 0..P-1)."""
        pose, velocity = self.true_pose_velocity(t)
        P = self.world.shape[0]
        batch = t.shape
        sensor = VIOSensorState(
            bias=torch.zeros(*batch, 6, dtype=self.world.dtype, device=self.world.device),
            pose=pose,
            velocity=velocity,
            camera_offset=SE3(*(a.expand(*batch, *a.shape) for a in self.camera_offset)),
        )
        return VIOState(
            sensor=sensor,
            landmarks=self._camera_points(pose),
            ids=torch.arange(P, device=self.world.device).expand(*batch, P),
            mask=torch.ones(*batch, P, dtype=torch.bool, device=self.world.device),
        )

    def get_vision(self, t: torch.Tensor, camera, max_features: int):
        """Visible world points at stamps ``t``: ``(camera-frame points [..., P, 3],
        selected [..., P])``; selection keeps the ``max_features`` lowest-id
        visible points."""
        cam_pts = self._camera_points(self.interpolate_pose(t))
        visible = camera.is_in_domain(cam_pts)
        rank = torch.cumsum(visible.to(torch.int64), dim=-1) - 1
        return cam_pts, visible & (rank < max_features)

    def get_vision_compact(self, t: torch.Tensor, camera, max_features: int):
        """``(sel_ids [..., F], sel_pts [..., F, 3])``: the selected world ids in
        ascending order and their camera-frame points, -1 / dummy padded."""
        cam_pts, selected = self.get_vision(t, camera, max_features)
        P = cam_pts.shape[-2]
        ids = torch.arange(P, device=cam_pts.device)
        first = torch.sort(torch.where(selected, ids, P), dim=-1).values[..., :max_features]
        valid = first < P
        safe = torch.clamp(first, 0, P - 1)
        pts = torch.gather(cam_pts, -2, safe[..., None].expand(*safe.shape, 3))
        dummy = const(DUMMY_POINT, cam_pts.dtype, cam_pts.device)
        return torch.where(valid, first, -1), torch.where(valid[..., None], pts, dummy)
