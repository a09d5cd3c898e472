"""Multi-process worker: one batched VIO frame step with the sequence batch
split over every rank of a ``seq`` mesh (counterpart of
``eqvio_tpu/parallel/dist_worker.py``).

Run one process per rank::

    python -m eqvio_tpu_torch.parallel.dist_worker <process_id> <num_processes> <port> \\
        [--device cuda|cpu] [--backend nccl|gloo]

The ranks meet at ``127.0.0.1:<port>``.  The device is ``cuda`` unless
asked for ``cpu``; the backend is NCCL on ``cuda`` and gloo on ``cpu``
unless named (ranks that share one card need ``--backend gloo``: NCCL
refuses two ranks on one device).  The batch holds one lane per rank, each
rank steps its own lane, and the NaN check and the count of active
landmarks are reduced over all ranks.  Process 0 prints ``DIST_OK ...`` on
success; any failure raises.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from .. import filter as F
from ..runner import default_sim_camera
from ..states import IMU
from .batch import batch_sim_step, make_batched_states
from .mesh import init_distributed, make_mesh, shard_batch


def main(process_id: int, num_processes: int, port: str, device: str = "cuda", backend: str | None = None) -> None:
    init_distributed(coordinator=f"127.0.0.1:{port}", num_processes=num_processes, process_id=process_id,
                     backend=backend, device=device)
    mesh = make_mesh(device=device)
    n_global = dist.get_world_size()

    dtype = torch.float32
    settings = F.Settings(measurement_noise=0.5)
    camera = default_sim_camera(dtype, mesh.device_type)
    capacity, window = 16, 8
    B = n_global
    states = shard_batch(mesh, make_batched_states(settings, B, capacity, dtype, device))

    rng = np.random.default_rng(0)
    t = lambda a: torch.tensor(a, dtype=dtype)  # noqa: E731
    imu_win = IMU(
        stamp=t(np.broadcast_to(np.linspace(0.0, 0.035, window), (B, window))),
        gyr=t(rng.normal(size=(B, window, 3)) * 0.01),
        acc=t(rng.normal(size=(B, window, 3)) * 0.01 + np.array([0.0, 0.0, 9.81])),
        gyr_bias_vel=torch.zeros((B, window, 3), dtype=dtype),
        acc_bias_vel=torch.zeros((B, window, 3), dtype=dtype),
    )
    pixels = t(rng.uniform(100, 500, size=(B, capacity, 2)))
    inputs = shard_batch(mesh, (
        imu_win,
        torch.full((B, window), 0.005, dtype=dtype),
        pixels,
        torch.ones((B, capacity), dtype=torch.bool),
        torch.arange(capacity).expand(B, capacity),
    ))

    out = batch_sim_step(settings, camera)(states, *inputs)

    # the checks over the whole batch: each rank's count, summed over the ranks
    checks = torch.stack([torch.isnan(out.Sigma).sum(), out.xi0.mask.sum()])
    dist.all_reduce(checks)
    n_nan, n_active = (int(v) for v in checks.cpu())
    if n_nan or n_active != B * capacity:
        raise RuntimeError(f"rank {process_id}: {n_nan} NaN in Sigma, {n_active} active landmarks "
                           f"(expected {B * capacity})")
    if process_id == 0:
        print(f"DIST_OK processes={num_processes} global_devices={n_global} batch={B} active_landmarks={n_active}",
              flush=True)
    dist.destroy_process_group()


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("process_id", type=int)
    ap.add_argument("num_processes", type=int)
    ap.add_argument("port")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"))
    a = ap.parse_args()
    main(a.process_id, a.num_processes, a.port, a.device, a.backend)
