"""CSV output writer with the reference VIOWriter's files and headers
(counterpart of ``eqvio_tpu/io/writer.py``; numpy only).  Lines are
buffered in memory and written on :meth:`flush`, or with ``streaming=True``
handed to the native async writer as they come.
"""

from __future__ import annotations

import os

import numpy as np


def rotation_to_quaternion(R: np.ndarray) -> np.ndarray:
    """Rotation matrix ``[..., 3, 3]`` -> quaternion ``[..., 4]`` (w, x, y, z)."""
    R = np.asarray(R)
    batch = R.shape[:-2]
    R = R.reshape((-1, 3, 3))
    q = np.zeros((R.shape[0], 4))
    for i, M in enumerate(R):
        t = np.trace(M)
        if t > 0:
            s = np.sqrt(t + 1.0) * 2
            q[i] = [0.25 * s, (M[2, 1] - M[1, 2]) / s, (M[0, 2] - M[2, 0]) / s,
                    (M[1, 0] - M[0, 1]) / s]
        else:
            k = np.argmax(np.diag(M))
            i1, i2 = (k + 1) % 3, (k + 2) % 3
            s = np.sqrt(1.0 + M[k, k] - M[i1, i1] - M[i2, i2]) * 2
            qv = np.zeros(4)
            qv[1 + k] = 0.25 * s
            qv[0] = (M[i2, i1] - M[i1, i2]) / s
            qv[1 + i1] = (M[i1, k] + M[k, i1]) / s
            qv[1 + i2] = (M[i2, k] + M[k, i2]) / s
            q[i] = qv
    return q.reshape(batch + (4,))


def _fmt(x) -> str:
    return f"{float(x):.6g}"


class VIOWriter:
    """Buffered CSV writer: IMUState.csv, camera.csv, bias.csv, points.csv,
    features.csv and timing.csv, and the simulation's trueState.csv,
    landmarkError.csv, poseConsistency.csv, biasConsistency.csv and
    nees.csv.

    With ``streaming=True`` each line goes to :class:`io.native.AsyncFile`
    (``native/aofstream.cpp``: a C++ thread flushes the files), so a long
    run holds no output in Python memory; where that library does not
    build, the writer buffers as without it."""

    def __init__(self, output_dir: str, streaming: bool = False):
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self._buffers: dict = {}
        self._native = None
        if streaming:
            from . import native

            if native.available():
                self._native = native

    def _file(self, name: str, header: str):
        if name not in self._buffers:
            if self._native is not None:
                handle = self._native.AsyncFile(os.path.join(self.output_dir, name))
                handle.write(header)
                self._buffers[name] = handle
            else:
                self._buffers[name] = [header]
        return self._buffers[name]

    def write_states(self, stamp, pose_R, pose_x, velocity, cam_R, cam_x, bias,
                     landmarks=None, landmark_ids=None, landmark_mask=None):
        q = rotation_to_quaternion(pose_R)
        buf = self._file("IMUState.csv", "time, px, py, pz, qw, qx, qy, qz, vx, vy, vz\n")
        buf.append(f"{float(stamp):.20g}, " + ", ".join(map(_fmt, [*pose_x, *q, *velocity])) + "\n")
        qc = rotation_to_quaternion(cam_R)
        buf = self._file("camera.csv", "time, px, py, pz, qw, qx, qy, qz\n")
        buf.append(f"{float(stamp):.20g}, " + ", ".join(map(_fmt, [*cam_x, *qc])) + "\n")
        buf = self._file(
            "bias.csv",
            "time, bias_gyr_x, bias_gyr_y, bias_gyr_z, bias_acc_x, bias_acc_y, bias_acc_z\n",
        )
        buf.append(f"{float(stamp):.20g}, " + ", ".join(map(_fmt, bias)) + "\n")

        if landmarks is not None:
            # world-frame points: (pose * camera offset) applied to each landmark
            PC_R = np.asarray(pose_R) @ np.asarray(cam_R)
            PC_x = np.asarray(pose_R) @ np.asarray(cam_x) + np.asarray(pose_x)
            buf = self._file("points.csv", "time, p1id, p1x, p1y, p1z, ...\n")
            parts = []
            for pid, p, m in zip(np.asarray(landmark_ids), np.asarray(landmarks),
                                 np.asarray(landmark_mask)):
                if m:
                    parts += [str(int(pid)), *map(_fmt, PC_R @ p + PC_x)]
            buf.append(f"{float(stamp):.20g}, " + ", ".join(parts) + "\n")

    def write_features(self, stamp, pixels, ids, mask):
        buf = self._file("features.csv", "time, z1id, z1x, z1y, ...\n")
        parts = []
        for pid, z, m in zip(np.asarray(ids), np.asarray(pixels), np.asarray(mask)):
            if m:
                parts += [str(int(pid)), _fmt(z[0]), _fmt(z[1])]
        buf.append(f"{float(stamp):.20g}, " + ", ".join(parts) + "\n")

    def write_timing(self, stamp, timings: dict[str, float]):
        buf = self._file("timing.csv", "time, " + ", ".join(timings.keys()) + "\n")
        buf.append(f"{float(stamp):.20g}, " + ", ".join(_fmt(v) for v in timings.values()) + "\n")

    def _row(self, name: str, header: str, stamp, values) -> None:
        self._file(name, header).append(f"{float(stamp):.20g}, " + ", ".join(map(_fmt, values)) + "\n")

    # --- the simulation's consistency outputs ---

    def write_landmark_error(self, stamp, errors, mask):
        self._row("landmarkError.csv", "time, lm_err_1, lm_err_2, ...\n", stamp,
                  [e for e, m in zip(np.asarray(errors), np.asarray(mask)) if m])

    def write_true_state(self, stamp, pose_R, pose_x, velocity, bias):
        self._row("trueState.csv",
                  "time, pose_tx, pose_ty, pose_tz, pose_qw, pose_qx, pose_qy, pose_qz,"
                  " vel_x, vel_y, vel_z, bias_gyr_x, bias_gyr_y, bias_gyr_z,"
                  " bias_acc_x, bias_acc_y, bias_acc_z\n",
                  stamp, [*pose_x, *rotation_to_quaternion(pose_R), *velocity, *bias])

    def write_pose_consistency(self, stamp, eps, sigma_diag):
        """Pose error coordinates and marginal standard deviations."""
        self._row("poseConsistency.csv",
                  "time, eps_rx, eps_ry, eps_rz, eps_px, eps_py, eps_pz,"
                  " sig_rx, sig_ry, sig_rz, sig_px, sig_py, sig_pz\n",
                  stamp, [*eps, *np.sqrt(np.asarray(sigma_diag))])

    def write_bias_consistency(self, stamp, eps, sigma_diag):
        """Bias error coordinates and marginal standard deviations."""
        self._row("biasConsistency.csv",
                  "time, eps_gyr_x, eps_gyr_y, eps_gyr_z, eps_acc_x, eps_acc_y, eps_acc_z,"
                  " sig_gyr_x, sig_gyr_y, sig_gyr_z, sig_acc_x, sig_acc_y, sig_acc_z\n",
                  stamp, [*eps, *np.sqrt(np.asarray(sigma_diag))])

    def write_nees(self, stamp, nees, dof, pose_nees=0.0, attitude_nees=0.0):
        self._row("nees.csv", "time, NEES, DoF, PoseNEES, AttitudeNEES\n", stamp,
                  [nees, dof, pose_nees, attitude_nees])

    def flush(self):
        if self._native is not None:
            for handle in self._buffers.values():
                handle.close()
            self._buffers.clear()
            return
        for name, lines in self._buffers.items():
            with open(os.path.join(self.output_dir, name), "w") as f:
                f.writelines(lines)

    close = flush

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.flush()
