"""The sharded paths run across ranks and held to their unsharded
counterparts (the cases of the JAX package's multi-device dry run,
``__graft_entry__.dryrun_multichip`` 1, 2, 2b, 2c and 3, as code that one
rank runs).

Run one process per rank::

    python -m eqvio_tpu_torch.parallel.dryrun <rank> <world> <port> --out DIR \\
        [--device cuda|cpu] [--backend nccl|gloo] [--spec SPEC.json]

The ranks meet at ``127.0.0.1:<port>`` (one rank starts its own group).
``SPEC.json`` maps each case to run onto its parameters; without it the
cases run at the JAX dry run's sizes (:func:`default_spec`).  Each rank
writes ``DIR/rank<r>.npz``: per case its largest errors and wall seconds,
and on rank 0 the trajectories.  A case whose error exceeds its bound
raises, so a failing rank exits nonzero.  The cases, in the order they run:

- ``mesh``: ``make_mesh()`` spans every rank, a shape that does not raises
  ``ValueError``, and ``shard_batch`` then ``gather_batch`` gives a seeded
  batch back bitwise; each rank's block is written.
- ``seq`` (cases 1 and 3): B lanes of one simulated sequence through
  ``build_sim_runner(batch=B, mesh=...)`` over a ``seq`` axis of every
  rank, against the same run without a mesh (bound 1e-3 m); the wall time
  of a run without a mesh and at each ``seq`` size that divides the ranks
  (below the world, a ``{"rep", "seq"}`` mesh whose replicas repeat the
  work).
- ``fleet``: K seeded sequences through ``build_fleet_runner(mesh=...)``,
  each rank's lanes against their own single-sequence runs (1e-8 m).
- ``lm``, ``lm_sqrt``, ``lm_big`` (cases 2, 2b, 2c): propagation and the
  landmark-sharded update over a few frames, dense and square root at
  capacity 16 (6 frames) and square root at capacity 256 (2 frames),
  against the local update in the same loop (trajectory 1e-3 m, Sigma
  1e-2); the loops are eager.
- ``update``: one landmark-sharded update of each state read from an
  ``.npz`` (the tests' seeded states); the output state's leaves are written
  by every rank.

When several processes share one card, their wall times measure the
overhead of the split, not scaling.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._pytree import tree_flatten, tree_unflatten

from .. import filter as F
from .. import runner as SR
from ..states import IMU
from .landmark_shard import sharded_vision_update
from .mesh import block, gather_batch, init_distributed, make_mesh, shard_batch

DTYPES = {"float32": torch.float32, "float64": torch.float64}
# the simulation settings of the JAX dry run's case 1 (and of bench.py's sim batch)
SEQ_SETTINGS = dict(measurement_noise=0.5, coordinate_choice="invdepth", fast_riccati=True,
                    use_discrete_innovation_lift=False, use_median_depth=False, initial_scene_depth=2.5)
SEQ_TOL_M = 1e-3
FLEET_TOL_M = 1e-8
LM_TOL_M, LM_SIGMA_TOL = 1e-3, 1e-2
LM_FRAMES, LM_BIG_FRAMES, LM_BIG_CAPACITY = 6, 2, 256
MESH_ROWS_PER_RANK = 4


def default_spec(world: int) -> dict:
    """The JAX dry run's cases at its sizes."""
    return {"seq": dict(capacity=8, max_features=6, end_time=2.0, dtype="float32", batch=world),
            "lm": {}, "lm_sqrt": {}, "lm_big": {}}


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _wall(fn, device: str) -> tuple[float, object]:
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return time.perf_counter() - t0, out


def case_mesh(rank: int, world: int, device: str) -> dict:
    mesh = make_mesh(device=device)
    seq_size = dist.get_world_size(mesh.get_group("seq"))
    try:
        make_mesh({"seq": world + 1}, device)
        raised = False
    except ValueError:
        raised = True
    rng = np.random.default_rng(0)
    B = MESH_ROWS_PER_RANK * world
    batch = (torch.tensor(rng.normal(size=(B, 2, 3))), torch.tensor(rng.integers(-5, 5, size=B)),
             torch.tensor(rng.uniform(size=B) < 0.5))
    blocks = shard_batch(mesh, batch)
    back = gather_batch(mesh, blocks)
    equal = all(torch.equal(a.cpu(), b) for a, b in zip(back, batch))
    if seq_size != world or not raised or not equal:
        raise RuntimeError(f"mesh: seq size {seq_size} of {world} ranks, ValueError raised {raised}, "
                           f"gathered batch equal {equal}")
    out = {"mesh/seq_size": seq_size, "mesh/raised": raised, "mesh/roundtrip_equal": equal}
    out.update({f"mesh/block{i}": b.cpu().numpy() for i, b in enumerate(blocks)})
    return out


def case_seq(rank: int, world: int, device: str, batch: int, dtype: str = "float32", reps: int = 1,
             **scene) -> dict:
    settings = F.Settings(**SEQ_SETTINGS)
    inputs = SR.prepare_sim_inputs(settings, dtype=DTYPES[dtype], **scene)
    opts = dict(augment_true_landmarks=False, compute_nees=False, batch=batch, device=device)
    # no mesh, then every seq size that divides the ranks, the whole world last
    meshes = {"local": None}
    for k in range(2, world):
        if world % k == 0:
            meshes[f"seq{k}"] = make_mesh({"rep": world // k, "seq": k}, device)
    meshes[f"seq{world}"] = make_mesh({"seq": world}, device)
    out, results = {}, {}
    for key, mesh in meshes.items():
        run = SR.build_sim_runner(settings, inputs, mesh=mesh, **opts)
        out[f"seq/first_s_{key}"], results[key] = _wall(run, device)  # the capture and a first run
        if reps:
            out[f"seq/wall_s_{key}"] = min(_wall(run, device)[0] for _ in range(reps))
            # the outputs read back: a copy to the host, after the gather with a mesh
            out[f"seq/result_s_{key}"] = min(_wall(run.result, device)[0] for _ in range(reps))
    sharded, local = results[f"seq{world}"].est_position, results["local"].est_position
    err = float((sharded - local).abs().max())
    if not torch.isfinite(sharded).all() or not err <= SEQ_TOL_M:
        raise RuntimeError(f"seq: the {world}-rank run is finite {bool(torch.isfinite(sharded).all())} and "
                           f"{err} m from the run without a mesh (bound {SEQ_TOL_M})")
    out["seq/err_m"] = err
    if rank == 0:
        out["seq/est_position"] = sharded.numpy()
    return out


def case_fleet(rank: int, world: int, device: str, seeds: int, dtype: str = "float64", **scene) -> dict:
    settings = F.Settings(**SEQ_SETTINGS)
    inputs = [SR.prepare_sim_inputs(settings, seed=k, dtype=DTYPES[dtype], **scene) for k in range(seeds)]
    mesh = make_mesh(device=device)
    res = SR.build_fleet_runner(settings, inputs, mesh=mesh, device=device)()
    mine = range(seeds)[block(seeds, mesh, "seq")]
    err = max(float((res.est_position[k] - SR.build_sim_runner(
        settings, inputs[k], augment_true_landmarks=False, compute_nees=False, device=device)().est_position
    ).abs().max()) for k in mine)
    if not torch.isfinite(res.est_position).all() or not err <= FLEET_TOL_M:
        raise RuntimeError(f"fleet: lanes {list(mine)} are {err} m from their single runs (bound {FLEET_TOL_M})")
    out = {"fleet/err_m": err}
    if rank == 0:
        out["fleet/est_position"] = res.est_position.numpy()
    return out


def _frame_inputs(capacity: int, device: str, window: int = 8, dtype=torch.float32):
    """One frame's inputs of the JAX dry run (``__graft_entry__._example_frame_inputs``):
    ``(imu_window, dts, pixels, vis, ids)``."""
    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(a, dtype=dtype, device=device)  # noqa: E731
    zeros = torch.zeros((window, 3), dtype=dtype, device=device)
    imu = IMU(t(np.linspace(0.0, 0.035, window)), t(rng.normal(size=(window, 3)) * 0.01),
              t(rng.normal(size=(window, 3)) * 0.01 + np.array([0.0, 0.0, 9.81])), zeros, zeros)
    pixels = t(rng.uniform(100, 500, size=(capacity, 2)))
    return (imu, torch.full((window,), 0.005, dtype=dtype, device=device), pixels,
            torch.ones(capacity, dtype=torch.bool, device=device), torch.arange(capacity, device=device))


def _lm_capacity(world: int) -> int:
    cap = max(16, world)
    return cap + (-cap) % world


def _lm_noise(world: int) -> tuple[np.ndarray, np.ndarray]:
    """The JAX dry run's pixel noise: cases 2 and 2b, then 2c, from one stream."""
    rng = np.random.default_rng(1)
    return (rng.normal(size=(LM_FRAMES, _lm_capacity(world), 2)) * 0.5,
            rng.normal(size=(LM_BIG_FRAMES, LM_BIG_CAPACITY, 2)) * 0.5)


def _case_lm(name: str, rank: int, world: int, device: str, sqrt: bool, big: bool) -> dict:
    capacity = LM_BIG_CAPACITY if big else _lm_capacity(world)
    noise = _lm_noise(world)[int(big)]
    dtype = torch.float32
    settings = F.Settings(measurement_noise=0.5, sqrt_covariance=sqrt)
    camera = SR.default_sim_camera(dtype, device)
    imu, dts, pixels0, vis, ids = _frame_inputs(capacity, device, dtype=dtype)
    state0 = F.add_landmarks(F.init_state(settings, capacity, dtype, device), pixels0, vis, ids, camera, settings)
    pix_seq = pixels0[None] + torch.tensor(noise, dtype=dtype, device=device)
    mesh = make_mesh({"lm": world}, device)
    sharded = sharded_vision_update(mesh, settings, camera)

    def local(state, pix, v):
        return F.update_vision(state, pix, v, camera, settings)

    def scan(update):
        state, traj = state0, []
        for pix in pix_seq:
            state = F.propagate_window(state, imu, dts, settings, settings.suite)
            state = update(state, pix, vis)
            traj.append(state.X.A.x)
        return state, torch.stack(traj)

    secs_s, (end_s, traj_s) = _wall(lambda: scan(sharded), device)
    secs_l, (end_l, traj_l) = _wall(lambda: scan(local), device)
    err = float((traj_s - traj_l).abs().max())
    err_sigma = float((end_s.Sigma - end_l.Sigma).abs().max())
    if not torch.isfinite(end_s.Sigma).all() or not (err <= LM_TOL_M and err_sigma <= LM_SIGMA_TOL):
        raise RuntimeError(f"{name}: trajectory {err} m (bound {LM_TOL_M}), Sigma {err_sigma} (bound "
                           f"{LM_SIGMA_TOL}) from the local update, finite {bool(torch.isfinite(end_s.Sigma).all())}")
    out = {f"{name}/err_m": err, f"{name}/err_sigma": err_sigma, f"{name}/capacity": capacity,
           f"{name}/frames": len(pix_seq), f"{name}/wall_s": secs_s, f"{name}/local_wall_s": secs_l}
    if rank == 0:
        out[f"{name}/trajectory"] = traj_s.cpu().numpy()
    return out


def case_update(rank: int, world: int, device: str, inputs: str, problems: dict) -> dict:
    """``problems`` maps a name to its ``Settings`` fields; ``inputs`` holds
    per name the state's leaves (``<name>/leaf<i>``, in the port's
    ``EqFState`` order), ``<name>/pixels`` and ``<name>/vis``."""
    data = np.load(inputs)
    mesh = make_mesh({"lm": world}, device)
    out = {}
    for name, fields in problems.items():
        settings = F.Settings(**fields)
        pixels = torch.tensor(data[f"{name}/pixels"], device=device)
        dtype = pixels.dtype
        N = int(data[f"{name}/vis"].shape[0])
        spec = tree_flatten(F.init_state(settings, N, dtype, "cpu"))[1]
        leaves = [torch.tensor(data[f"{name}/leaf{i}"], device=device) for i in range(spec.num_leaves)]
        state = tree_unflatten(leaves, spec)
        vis = torch.tensor(data[f"{name}/vis"], device=device)
        camera = SR.default_sim_camera(dtype, device)
        new = sharded_vision_update(mesh, settings, camera)(state, pixels, vis)
        ref = F.update_vision(state, pixels, vis, camera, settings)
        new_leaves = tree_flatten(new)[0]
        out[f"update/{name}/err_local"] = max(float((a - b).abs().max()) for a, b in
                                              zip(new_leaves, tree_flatten(ref)[0]) if a.is_floating_point())
        out.update({f"update/{name}/leaf{i}": a.cpu().numpy() for i, a in enumerate(new_leaves)})
    return out


CASES = {
    "mesh": case_mesh,
    "seq": case_seq,
    "fleet": case_fleet,
    "lm": lambda rank, world, device: _case_lm("lm", rank, world, device, sqrt=False, big=False),
    "lm_sqrt": lambda rank, world, device: _case_lm("lm_sqrt", rank, world, device, sqrt=True, big=False),
    "lm_big": lambda rank, world, device: _case_lm("lm_big", rank, world, device, sqrt=True, big=True),
    "update": case_update,
}


def main(rank: int, world: int, port: str | None, device: str = "cuda", backend: str | None = None,
         out: str = ".", spec: dict | None = None) -> dict:
    """Run ``spec``'s cases as rank ``rank`` of ``world``; returns what was
    written to ``out/rank<rank>.npz``.  With ``world == 1`` the process
    starts a one-rank group on the first mesh, and every call ends with the
    group destroyed."""
    init_distributed(f"127.0.0.1:{port}", world, rank, backend, device)
    spec = default_spec(world) if spec is None else spec
    results = {}
    for name, fn in CASES.items():
        if name in spec:
            results.update(fn(rank, world, device, **spec[name]))
    if dist.is_initialized():
        results["backend"] = str(dist.get_backend())
    os.makedirs(out, exist_ok=True)
    np.savez(os.path.join(out, f"rank{rank}.npz"), **results)
    if dist.is_initialized():
        dist.destroy_process_group()
    return results


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("port")
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    ap.add_argument("--spec", default=None, help="JSON file: case name -> parameters")
    a = ap.parse_args()
    spec = None
    if a.spec:
        with open(a.spec) as f:
            spec = json.load(f)
    res = main(a.rank, a.world, a.port, a.device, a.backend, a.out, spec)
    if a.rank == 0:
        for key in sorted(res):
            if np.ndim(res[key]) == 0:
                print(key, res[key], flush=True)
