"""Synthetic trajectories and world points (counterpart of the scene part of
``eqvio_tpu/sim.py``): the ``wave``, ``room`` and ``racing`` trajectories,
wall points, pose interpolation, IMU by pose differentiation and the exact
true state.

Scene generation is set-up, not the hot path: it runs in float64 on the
device it is given (the CPU by default) and is batched over query times.
The other trajectory kinds (``line``, ``sine``, ``square``, ``mh``), the slot
simulator and NEES wait for the simulation slice (``ROADMAP.md`` queue 1).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .lie import SE3, mv, se3_exp, se3_inv, se3_log, se3_mul, so3_exp, so3_log
from .states import GRAVITY


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


def trajectory_poses(kind: str, end_time: float, frequency: float, dtype=torch.float64, device="cpu"):
    """Stamped poses ``[T]`` of a named trajectory: ``(t, SE3)``."""
    num = int(np.floor(end_time * frequency))
    t = torch.arange(num, dtype=dtype, device=device) / frequency
    if kind == "wave":
        ang = 2 * math.pi * t / 20.0
        R = _rot_z(ang)
        x = torch.stack([torch.cos(ang), torch.sin(ang), 0.2 * torch.sin(10 * ang)], dim=-1)
    elif kind == "room":
        # EuRoC V1_01-like room trajectory with a 3 s stationary start
        two_pi = 2 * math.pi
        u = torch.clamp(t - 3.0, min=0.0)
        tau = u - 2.0 * (1.0 - torch.exp(-u / 2.0))
        scale = 58.56 / 65.14
        s = torch.sin
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
    elif kind == "racing":
        # drone-racing figure-eight in an ~18x9x2 m hall with a 3 s stationary
        # start, yaw along the track tangent, banking from yaw rate x speed
        two_pi = 2 * math.pi
        u = torch.clamp(t - 3.0, min=0.0)
        tau = u - 2.0 * (1.0 - torch.exp(-u / 2.0))
        A, B = 9.0, 4.5
        x = torch.stack(
            [
                A * torch.sin(two_pi * tau / 14.0),
                B * torch.sin(2 * two_pi * tau / 14.0),
                1.0 + 0.8 * torch.sin(two_pi * tau / 6.5),
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
    else:
        raise NotImplementedError(
            f"trajectory kind {kind!r} is not ported yet (ROADMAP.md queue 1, simulation path)"
        )
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
    world: torch.Tensor  # [P, 3] inertial points
    camera_offset: SE3

    @staticmethod
    def create(kind="wave", end_time=60.0, pose_frequency=100.0, num_points=1000,
               wall_distance=2.0, num_walls=1, seed=0, dtype=torch.float64, device="cpu"):
        t, poses = trajectory_poses(kind, end_time, pose_frequency, dtype, device)
        world = generate_world_points(poses.x.cpu().numpy(), num_points, wall_distance, num_walls, seed)
        # z-forward camera mounted on the body x-axis
        cam_R = torch.tensor(
            [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], dtype=dtype, device=device
        ).T
        camera_offset = SE3(cam_R, torch.zeros(3, dtype=dtype, device=device))
        return Simulator(t, poses, torch.as_tensor(world, dtype=dtype, device=device), camera_offset)

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
        """``[..., 3, 3]`` inertial (position | velocity | acceleration) from a
        cubic least-squares fit over the 4 bracketing poses."""
        taus = torch.stack([self.times[i - 2], self.times[i - 1], self.times[i], self.times[i + 1]],
                           dim=-1) - t[..., None]
        Xp = torch.stack([self.poses.x[i - 2], self.poses.x[i - 1], self.poses.x[i],
                          self.poses.x[i + 1]], dim=-1)  # [..., 3, 4]
        TT = torch.stack([torch.ones_like(taus), taus, taus**2 / 2.0, taus**3 / 6.0], dim=-2)
        TTt = TT.transpose(-1, -2)
        A = Xp @ TTt @ torch.linalg.inv(TT @ TTt)
        return A[..., 0:3]

    def _attitude(self, t: torch.Tensor, i: torch.Tensor):
        R0 = self.poses.R[i - 1]
        t0, t1 = self.times[i - 1], self.times[i]
        gyr = so3_log(R0.transpose(-1, -2) @ self.poses.R[i]) / (t1 - t0)[..., None]
        return gyr, R0 @ so3_exp((t - t0)[..., None] * gyr)

    def get_imu_batch(self, ts: torch.Tensor):
        """``(gyr [T, 3], acc [T, 3])`` at stamps ``ts`` by pose differentiation."""
        i = self._index(ts)
        gyr, att = self._attitude(ts, i)
        accel_inertial = self._inertial_states(ts, i)[..., 2]
        grav = torch.tensor([0.0, 0.0, -GRAVITY], dtype=ts.dtype, device=ts.device)
        acc = mv(att.transpose(-1, -2), accel_inertial - grav)
        return gyr, acc

    def true_pose_velocity(self, ts: torch.Tensor):
        """True ``(pose SE3, body velocity)`` at stamps ``ts``."""
        i = self._index(ts)
        _, att = self._attitude(ts, i)
        states = self._inertial_states(ts, i)
        return SE3(att, states[..., 0]), mv(att.transpose(-1, -2), states[..., 1])
