"""End-to-end simulation runner, the ``eqvio_sim`` equivalent (counterpart of
``eqvio_tpu/runner.py``).

Set-up runs once on the host: trajectory, IMU, per-frame IMU windows,
feature selection and ground truth for the whole sequence, optional noise.
Everything per frame then lives on the device for the whole run, and the
frame step (IMU propagation, slot tracking, landmark lifecycle, the EqF
update, NEES) reads frame ``k`` through a frame counter held on the device
and writes its outputs into ``[T, ...]`` device buffers.  On ``cuda`` the
step is captured once as a CUDA graph (:class:`graph.GraphStep`) and
replayed once per frame, with one synchronisation at the end; on ``cpu`` the
same step runs directly.  ``batch=B`` and :func:`build_fleet_runner` run the
one-sequence step over a leading lane axis with ``torch.func.vmap``, in the
same single graph: the launches per frame do not grow with the lanes.
``SimRunner.cost_analysis()`` counts a run's operations and bytes, as the
JAX runner's ``run.cost_analysis()`` reads them from XLA.  With ``mesh=``
(``parallel/mesh.py``) each rank runs its own block of the lanes through its
own graph, with no collective inside it, and the outputs are gathered over
the mesh's ``seq`` axis after the replays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils._pytree import tree_map

from . import cost
from . import filter as F
from .camera import PinholeCamera
from .graph import GraphStep, broadcast_lanes, select
from .lie import SE3
from .runtime import configure_runtime, const
from .sim import Simulator, first_match, gather_slots_compact, slot_tracker_init, slot_tracker_step_compact
from .states import DUMMY_POINT, IMU, VIOState


def build_imu_windows(imu_times: np.ndarray, frame_times: np.ndarray, t_start: float):
    """Per-frame padded IMU application windows: sample ``j`` applies from
    ``max(stamp_j, t_prev)`` to ``min(stamp_{j+1}, t_frame)``.  Returns
    ``(sample_idx [T, K], dts [T, K])`` with zero-dt padding."""
    T = len(frame_times)
    idx_windows = []
    dt_windows = []
    prev = t_start
    ext = np.append(imu_times, np.inf)
    for ti in frame_times:
        j0 = max(np.searchsorted(imu_times, prev, side="right") - 1, 0)
        j1 = np.searchsorted(imu_times, ti, side="left")
        js = np.arange(j0, max(j1, j0 + 1))
        dts = np.clip(np.minimum(ext[js + 1], ti) - np.maximum(imu_times[js], prev), 0.0, None)
        idx_windows.append(js)
        dt_windows.append(dts)
        prev = ti
    K = max(len(w) for w in idx_windows)
    idx = np.zeros((T, K), dtype=np.int64)
    dts = np.zeros((T, K), dtype=np.float64)
    for i, (js, dw) in enumerate(zip(idx_windows, dt_windows)):
        idx[i, : len(js)] = js
        idx[i, len(js):] = js[-1]  # repeat the last sample with dt 0
        dts[i, : len(dw)] = dw
    return idx, dts


class SimRunResult(NamedTuple):
    """Per-frame outputs (CPU tensors; a batch or fleet adds a leading lane axis)."""

    times: torch.Tensor  # [T]
    est_position: torch.Tensor  # [T, 3]
    est_attitude: torch.Tensor  # [T, 3, 3]
    est_velocity: torch.Tensor  # [T, 3]
    true_position: torch.Tensor  # [T, 3]
    true_attitude: torch.Tensor  # [T, 3, 3]
    true_velocity: torch.Tensor  # [T, 3]
    nees: torch.Tensor  # [T], NaN unless computed
    num_landmarks: torch.Tensor  # [T]
    # (pose_nees [T], attitude_nees [T], eps [T, 21], sigma_diag [T, 21],
    # landmark_err [T, N]) with ``consistency``, else None
    consistency: tuple | None = None


def default_sim_camera(dtype=torch.float64, device="cuda") -> PinholeCamera:
    """EuRoC-like pinhole camera, 752x480."""
    return PinholeCamera.create(458.654, 457.296, 367.215, 248.375, 752, 480, dtype=dtype, device=device)


class SimInputs(NamedTuple):
    """Prepared inputs of a simulation run (CPU tensors)."""

    sim: Simulator
    camera: PinholeCamera
    state0: F.EqFState
    ftimes: torch.Tensor  # [T]
    idx: torch.Tensor  # [T, K] IMU sample per window entry
    dts: torch.Tensor  # [T, K]
    imu_all: IMU
    max_features: int
    capacity: int
    pixel_noise: torch.Tensor | None = None  # [T, capacity, 2]
    sel_ids: torch.Tensor | None = None  # [T, F] selected world ids
    sel_pts: torch.Tensor | None = None  # [T, F, 3] camera-frame points
    true_pos: torch.Tensor | None = None  # [T, 3]
    true_R: torch.Tensor | None = None  # [T, 3, 3]
    true_vel: torch.Tensor | None = None  # [T, 3]
    true_lm_full: torch.Tensor | None = None  # [T, P, 3], full-state mode only


def prepare_sim_inputs(
    settings: F.Settings,
    capacity: int = 32,
    max_features: int = 30,
    end_time: float = 30.0,
    imu_freq: float = 200.0,
    frame_freq: float = 20.0,
    kind: str = "wave",
    seed: int = 0,
    num_walls: int = 4,
    num_points: int = 1000,
    input_noise: bool = False,
    output_noise: bool = False,
    initial_noise: bool = False,
    noise_seed: int = 1,
    dtype=torch.float64,
    sim: Simulator | None = None,
    camera: PinholeCamera | None = None,
    full_state: bool = False,
) -> SimInputs:
    """One-time host set-up: trajectory, IMU, windows, selection, truth and
    the initial state, in ``dtype`` on the CPU.

    The noise switches draw from ``np.random.default_rng(noise_seed)`` in
    the JAX package's order: IMU noise (gyr, then acc) at the filter's input
    gains times ``sqrt(imu_freq)``, the initial state through the chart at
    the initial covariance, then pixel noise at ``measurement_noise``.
    ``full_state``: every world point is in the state from the start and
    stays there; ``capacity`` becomes the world's size.
    """
    if sim is None:
        # the inputs are built on the host and copied to the device once per run
        sim = Simulator.create(kind=kind, end_time=end_time + 1.0, seed=seed, num_walls=num_walls,
                               num_points=num_points, dtype=dtype, device="cpu")
    if camera is None:
        camera = default_sim_camera(dtype, device="cpu")  # host set-up, as the simulator
    if full_state:
        capacity = int(sim.world.shape[0])
    t = lambda a: torch.as_tensor(a, dtype=dtype)  # noqa: E731

    t0 = 0.2
    imu_times = np.arange(t0, end_time, 1.0 / imu_freq)
    frame_times = np.arange(t0 + 1.0 / frame_freq, end_time, 1.0 / frame_freq)
    idx_np, dts_np = build_imu_windows(imu_times, frame_times, t0)
    imu_all = sim.get_imu_batch(t(imu_times))

    nrng = np.random.default_rng(noise_seed)
    if input_noise:
        sf = np.sqrt(imu_freq)
        gyr_n = nrng.normal(size=tuple(imu_all.gyr.shape)) * settings.vel_gyr_noise * sf
        acc_n = nrng.normal(size=tuple(imu_all.acc.shape)) * settings.vel_acc_noise * sf
        imu_all = imu_all._replace(gyr=imu_all.gyr + t(gyr_n), acc=imu_all.acc + t(acc_n))

    true0 = sim.full_state(t(t0))
    state = F.init_state(settings, capacity, dtype, "cpu")
    sensor0 = true0.sensor._replace(camera_offset=sim.camera_offset)
    xi0 = true0._replace(sensor=sensor0) if full_state else state.xi0._replace(sensor=sensor0)
    state = state._replace(xi0=xi0, t=t(t0))

    if initial_noise:
        diag = np.concatenate([
            settings.initial_sensor_cov_diag(dtype, "cpu").numpy(),
            np.tile(settings.initial_point_cov_diag(dtype, "cpu").numpy(), capacity),
        ])
        eps = t(nrng.normal(size=state.xi0.dim()) * np.sqrt(diag))
        state = state._replace(xi0=settings.suite.chart.chart_inv(eps, state.xi0))

    pixel_noise = None
    if output_noise:
        pixel_noise = t(nrng.normal(size=(len(frame_times), capacity, 2)) * settings.measurement_noise)

    ftimes = t(frame_times)
    sel_ids, sel_pts = sim.get_vision_compact(ftimes, camera, max_features)
    true = sim.full_state(ftimes)
    return SimInputs(
        sim=sim, camera=camera, state0=tree_map(torch.Tensor.contiguous, state), ftimes=ftimes,
        idx=torch.as_tensor(idx_np), dts=t(dts_np), imu_all=imu_all, max_features=max_features,
        capacity=capacity, pixel_noise=pixel_noise, sel_ids=sel_ids, sel_pts=sel_pts,
        true_pos=true.sensor.pose.x, true_R=true.sensor.pose.R, true_vel=true.sensor.velocity,
        true_lm_full=true.landmarks if full_state else None,
    )


class _Frame(NamedTuple):
    """One frame's inputs to the step (a lane axis in front on a batch)."""

    k: torch.Tensor  # frame index, 0-dim
    imu: IMU  # [K] window samples
    dts: torch.Tensor  # [K]
    sel_ids: torch.Tensor  # [F]
    sel_pts: torch.Tensor  # [F, 3]
    noise: torch.Tensor | None  # [N, 2]
    true_pos: torch.Tensor  # [3]
    true_R: torch.Tensor  # [3, 3]
    true_vel: torch.Tensor  # [3]
    true_lm: torch.Tensor | None  # [P, 3], full-state mode only


def _frame_step(settings, camera, camera_offset, augment_true_landmarks, compute_nees, consistency,
                full_state, landmark_reset_every):
    """The frame step of one sequence: ``(state, tracker, _Frame) -> (state,
    tracker, outputs)``, where the outputs are the estimate's position,
    attitude and velocity, the NEES (NaN unless computed), the landmark
    count and, with ``consistency``, the pose and attitude NEES, the sensor
    error coordinates, the marginal Sigma diagonal and the landmark errors.
    Every branch is on a Python setting; per-frame choices are ``torch.where``."""
    suite = settings.suite
    wide = not full_state and not augment_true_landmarks

    def step(state, tracker, fr: _Frame):
        state = F.propagate_window(state, fr.imu, fr.dts, settings, suite, wide_factor=wide)
        reset = None
        if landmark_reset_every > 0:
            reset = torch.remainder(fr.k, landmark_reset_every) == 0
        if full_state:
            # slots are world points (id i in slot i); the frame's selection is measured
            vis = first_match(state.xi0.ids, fr.sel_ids)[0].any(dim=1)
            true_lms = fr.true_lm
            pixels = torch.where(vis[:, None], camera.project(true_lms), 0.0)
            if fr.noise is not None:
                pixels = pixels + fr.noise * vis[:, None]
            if reset is not None:
                snapped = F.set_landmarks(state, true_lms, state.xi0.ids, state.xi0.mask, settings)
                state = select(reset, snapped, state)
            state = F.update_vision(state, pixels, vis, camera, settings, suite)
        else:
            tracker = slot_tracker_step_compact(tracker, fr.sel_ids)
            pixels, vis, ids, true_pts = gather_slots_compact(fr.sel_ids, fr.sel_pts, tracker, camera)
            if fr.noise is not None:
                pixels = pixels + fr.noise * vis[:, None]
            if augment_true_landmarks:
                # lost landmarks leave; new ones enter at their true positions
                lost = state.xi0.mask & (~vis | (state.xi0.ids != ids))
                if reset is not None:
                    lost = lost | (state.xi0.mask & reset)
                state = F.remove_landmarks(state, lost, settings)
                state = F.augment_landmarks(state, vis & ~state.xi0.mask, ids, true_pts, settings)
                state = F.update_vision(state, pixels, vis, camera, settings, suite)
                state = F.remove_invalid_landmarks(state, settings)
            else:
                state = F.process_vision(state, pixels, vis, ids, camera, settings, suite)
            src = first_match(state.xi0.ids, fr.sel_ids)[1]
            dummy = const(DUMMY_POINT, fr.sel_pts.dtype, fr.sel_pts.device)
            true_lms = torch.where(state.xi0.mask[:, None], fr.sel_pts[src], dummy)

        est = F.state_estimate(state)
        out = (est.sensor.pose.x, est.sensor.pose.R, est.sensor.velocity)
        count = state.xi0.mask.sum()
        if not (consistency or compute_nees):
            return state, tracker, out + (torch.full_like(fr.true_pos[0], float("nan")), count)
        sensor = state.xi0.sensor._replace(
            pose=SE3(fr.true_R, fr.true_pos), velocity=fr.true_vel,
            bias=torch.zeros_like(state.xi0.sensor.bias), camera_offset=camera_offset,
        )
        truth = VIOState(sensor=sensor, landmarks=true_lms, ids=state.xi0.ids, mask=state.xi0.mask)
        if consistency:
            nees, *extras = F.consistency_outputs(state, truth, suite, settings)
            return state, tracker, out + (nees, count) + tuple(extras)
        return state, tracker, out + (F.compute_nees(state, truth, suite, settings), count)

    return step


class SimRunner:
    """A whole-sequence simulation run, built once and callable any number
    of times: ``run() -> SimRunResult``, each call from the initial state.

    ``step`` is the :class:`GraphStep` that advances every lane by one
    frame; ``frames`` is the sequence length.  ``lanes`` is ``None`` for
    one sequence, else the number of lanes this process runs.  With a
    ``mesh``, those are this rank's block of the lanes, and ``result()``
    (which every rank of the ``seq`` axis calls together) gathers every
    rank's lanes in rank order.
    """

    def __init__(self, frame_fn, state0, capacity: int, seq: dict, lanes: int | None, times: torch.Tensor,
                 truth: tuple, consistency: bool, device: torch.device, mesh=None):
        self.device = device
        self.lanes = lanes
        self.mesh = mesh
        self.times = times
        self._truth = truth
        self._consistency = consistency
        self._seq = seq
        self.frames = int(seq["idx"].shape[0])
        tracker0 = slot_tracker_init(capacity, device)
        if lanes is not None:
            if not seq["lanes"]:  # lanes of one sequence start from its one state
                state0 = broadcast_lanes(state0, lanes)
            tracker0 = broadcast_lanes(tracker0, lanes)
        self._carry0 = (state0, tracker0, torch.zeros((), dtype=torch.int64, device=device))

        frame0 = self._frame(torch.zeros(1, dtype=torch.int64, device=device))
        step = frame_fn
        if lanes is not None:  # absent inputs (None) have no lane axis
            step = torch.func.vmap(frame_fn, in_dims=(0, 0, _Frame(*(None if v is None else 0 for v in frame0))))
        self._step_fn = step
        # one frame's outputs, to size the [T, ...] buffers
        probe = step(state0, tracker0, frame0)[2]
        self._bufs = [torch.empty((self.frames,) + tuple(o.shape), dtype=o.dtype, device=device) for o in probe]

        def advance(carry):
            state, tracker, k = carry
            k1 = k.reshape(1)
            state, tracker, outs = step(state, tracker, self._frame(k1))
            for buf, o in zip(self._bufs, outs):
                buf.index_copy_(0, k1, o.unsqueeze(0))
            return (state, tracker, k + 1), None

        self.step = GraphStep(advance, self._carry0, [], device)

    def _frame(self, k1: torch.Tensor) -> _Frame:
        """Frame ``k1 [1]`` of every per-frame input, read on the device."""
        seq = self._seq
        lane_ax = 1 if seq["lanes"] else 0
        pick = lambda a: None if a is None else a.index_select(lane_ax, k1).squeeze(lane_ax)  # noqa: E731
        widx = seq["idx"].index_select(0, k1)[0]
        fr = _Frame(
            k=k1[0], imu=IMU(*(a.index_select(lane_ax, widx) for a in seq["imu"])),
            dts=seq["dts"].index_select(0, k1)[0], sel_ids=pick(seq["sel_ids"]), sel_pts=pick(seq["sel_pts"]),
            noise=pick(seq["noise"]), true_pos=pick(seq["true_pos"]), true_R=pick(seq["true_R"]),
            true_vel=pick(seq["true_vel"]), true_lm=pick(seq["true_lm"]),
        )
        if self.lanes is None:
            return fr
        lane = lambda a: None if a is None else a.expand(self.lanes, *a.shape)  # noqa: E731
        if seq["lanes"]:  # a fleet: only the frame index and the window's dts are shared
            return fr._replace(k=lane(fr.k), dts=lane(fr.dts))
        # lanes of one sequence share every input
        return _Frame(*(IMU(*map(lane, v)) if isinstance(v, IMU) else lane(v) for v in fr))

    def cost_analysis(self) -> dict:
        """The whole run's operations and bytes under XLA's key names
        (``flops``, ``bytes accessed``), as the JAX runner's
        ``run.cost_analysis()`` gives them: one frame step (every lane)
        counted by :func:`cost.count`, run eagerly on copies of the initial
        carry, times the frames (each frame runs the same ops on the same
        shapes), with ``flops_per_frame`` and ``bytes_per_frame`` beside.
        With a mesh it counts this rank's lanes, as XLA's cost analysis of a
        partitioned program counts one device's share."""
        state, tracker, k = tree_map(torch.clone, self._carry0)
        per = cost.count(self._step_fn, state, tracker, self._frame(k.reshape(1)))
        return {"flops": per["flops"] * self.frames, "bytes accessed": per["bytes accessed"] * self.frames,
                "flops_per_frame": per["flops"], "bytes_per_frame": per["bytes accessed"], "frames": self.frames}

    def replay(self, frames: int) -> None:
        """Advance every lane by ``frames`` frames (no synchronisation)."""
        for _ in range(frames):
            self.step()

    def reset(self) -> None:
        self.step.load(self._carry0)

    def result(self) -> SimRunResult:
        """The outputs of the frames run so far, as CPU tensors."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        outs = self._bufs
        if self.lanes is not None:
            outs = [o.transpose(0, 1) for o in outs]  # [T, B, ...] -> [B, T, ...]
            if self.mesh is not None:
                from .parallel.mesh import gather_batch

                outs = gather_batch(self.mesh, outs)
        outs = [o.cpu() for o in outs]
        extras = tuple(outs[5:]) if self._consistency else None
        return SimRunResult(self.times, *outs[:3], *self._truth, *outs[3:5], consistency=extras)

    def __call__(self) -> SimRunResult:
        self.reset()
        self.replay(self.frames)
        return self.result()


def _to(tree, device):
    return tree_map(lambda a: a.to(device) if isinstance(a, torch.Tensor) else a, tree)


def build_sim_runner(
    settings: F.Settings,
    inputs: SimInputs,
    augment_true_landmarks: bool = True,
    compute_nees: bool = True,
    batch: int | None = None,
    mesh=None,
    landmark_reset_every: int = 0,
    consistency: bool = False,
    full_state: bool = False,
    device: str = "cuda",
) -> SimRunner:
    """A reusable whole-sequence runner on ``device`` (``cuda`` unless the
    caller asks for ``cpu``; without a card the default raises).

    ``batch``: B filter instances of the same sequence over a lane axis
    (outputs gain a leading lane axis).  ``mesh``: a ``DeviceMesh`` with a
    ``seq`` axis (``parallel.make_mesh``) on ``device``'s type: each rank
    runs its ``batch / n`` lanes, and every rank's run returns all ``batch``
    lanes.  ``landmark_reset_every``: if > 0,
    drop and re-insert every landmark at its true position every N frames.
    ``consistency``: also the pose/attitude NEES, error coordinates,
    marginal variances and landmark errors.  ``full_state``: every world
    point stays in the state (the inputs must be prepared with it).
    """
    dev, _ = configure_runtime(device)
    lanes = batch
    if mesh is not None:
        if batch is None:
            raise ValueError("mesh= splits the lanes of a batch: give batch=")
        mine = _lane_block(mesh, batch, dev)
        lanes = mine.stop - mine.start
    inp = _to(inputs, dev)
    frame_fn = _frame_step(settings, inp.camera, inp.sim.camera_offset, augment_true_landmarks, compute_nees,
                           consistency, full_state, landmark_reset_every)
    seq = dict(lanes=False, idx=inp.idx, dts=inp.dts, imu=inp.imu_all, sel_ids=inp.sel_ids, sel_pts=inp.sel_pts,
               noise=inp.pixel_noise, true_pos=inp.true_pos, true_R=inp.true_R, true_vel=inp.true_vel,
               true_lm=inp.true_lm_full if full_state else None)
    truth = (inputs.true_pos, inputs.true_R, inputs.true_vel)
    if batch is not None:
        truth = tuple(a.expand(batch, *a.shape) for a in truth)
    return SimRunner(frame_fn, inp.state0, inp.capacity, seq, lanes, inputs.ftimes, truth, consistency, dev, mesh)


def _lane_block(mesh, lanes: int, dev: torch.device) -> slice:
    """This rank's block of ``lanes`` split over ``mesh``'s ``seq`` axis."""
    from .parallel.mesh import block

    if mesh.device_type != dev.type:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the run on {dev.type!r}")
    return block(lanes, mesh, "seq")


def build_fleet_runner(settings: F.Settings, inputs_list: list[SimInputs], augment_true_landmarks: bool = False,
                       mesh=None, device: str = "cuda") -> SimRunner:
    """K genuinely different sequences (worlds and noise per lane) as lanes
    of one step on ``device``; all inputs must share their frame and IMU
    timing.  Outputs have a leading lane axis; NEES is not computed.
    ``mesh``: as for :func:`build_sim_runner`; each rank stacks only its
    block of ``inputs_list``, whose length the ``seq`` axis must divide."""
    dev, _ = configure_runtime(device)
    proto = inputs_list[0]
    mine = inputs_list
    if mesh is not None:
        mine = inputs_list[_lane_block(mesh, len(inputs_list), dev)]
    stack = lambda get: torch.stack([get(i) for i in mine]).to(dev)  # noqa: E731
    noise = stack(lambda i: i.pixel_noise if i.pixel_noise is not None else torch.zeros(
        proto.ftimes.shape[0], proto.capacity, 2, dtype=proto.true_pos.dtype))
    seq = dict(lanes=True, idx=proto.idx.to(dev), dts=proto.dts.to(dev),
               imu=IMU(*(stack(lambda i, j=j: i.imu_all[j]) for j in range(len(IMU._fields)))),
               sel_ids=stack(lambda i: i.sel_ids), sel_pts=stack(lambda i: i.sel_pts), noise=noise,
               true_pos=stack(lambda i: i.true_pos), true_R=stack(lambda i: i.true_R),
               true_vel=stack(lambda i: i.true_vel), true_lm=None)
    state0 = tree_map(lambda *xs: torch.stack(xs).to(dev), *[i.state0 for i in mine])
    camera = _to(proto.camera, dev)
    frame_fn = _frame_step(settings, camera, _to(proto.sim.camera_offset, dev), augment_true_landmarks, False,
                           False, False, 0)
    truth = tuple(torch.stack([getattr(i, name) for i in inputs_list]) for name in ("true_pos", "true_R", "true_vel"))
    return SimRunner(frame_fn, state0, proto.capacity, seq, len(mine), proto.ftimes, truth, False, dev, mesh)


def run_prepared(settings: F.Settings, inputs: SimInputs, augment_true_landmarks: bool = True,
                 compute_nees: bool = True, **kwargs) -> SimRunResult:
    """Run the whole sequence once on prepared inputs."""
    return build_sim_runner(settings, inputs, augment_true_landmarks, compute_nees, **kwargs)()


def run_simulation(settings: F.Settings, augment_true_landmarks: bool = True, landmark_reset_every: int = 0,
                   consistency: bool = False, full_state: bool = False, device: str = "cuda",
                   **kwargs) -> SimRunResult:
    """Prepare the inputs and run the simulated VIO pipeline on ``device``."""
    configure_runtime(device)
    inputs = prepare_sim_inputs(settings, full_state=full_state, **kwargs)
    return run_prepared(settings, inputs, augment_true_landmarks, landmark_reset_every=landmark_reset_every,
                        consistency=consistency, full_state=full_state, device=device)


# ---------------------------------------------------------------------------
# Trajectory evaluation
# ---------------------------------------------------------------------------


def umeyama_alignment(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """SIM(3) Umeyama alignment est -> gt. Returns (s, R, t)."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    Xe = est - mu_e
    Xg = gt - mu_g
    cov = Xg.T @ Xe / len(est)
    U, d, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (Xe**2).sum() / len(est)
    s = np.trace(np.diag(d) @ S) / var_e if with_scale else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est_pos: np.ndarray, gt_pos: np.ndarray, with_scale: bool = True):
    """Absolute trajectory error after SIM(3)/SE(3) alignment: ``(rmse, scale)``."""
    s, R, t = umeyama_alignment(est_pos, gt_pos, with_scale)
    aligned = (s * (R @ est_pos.T)).T + t
    err = aligned - gt_pos
    return float(np.sqrt((err**2).sum(axis=-1).mean())), float(s)


def attitude_rmse(est_att: np.ndarray, gt_att: np.ndarray) -> float:
    """Attitude RMSE in degrees after rotation-only alignment of the first pose."""
    R_align = gt_att[0] @ est_att[0].T
    errs = []
    for Re, Rg in zip(est_att, gt_att):
        dR = Rg.T @ (R_align @ Re)
        c = np.clip((np.trace(dR) - 1) / 2, -1, 1)
        errs.append(np.degrees(np.arccos(c)))
    return float(np.sqrt(np.mean(np.square(errs))))
