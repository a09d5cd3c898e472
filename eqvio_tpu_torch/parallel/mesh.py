"""The process mesh over ``torch.distributed`` (counterpart of
``eqvio_tpu/parallel/mesh.py``).

The JAX package's mesh is one process that sees every device, and GSPMD
makes its arrays global.  Torch is multi-controller: one process per device
(a rank), with explicit collectives.  So here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the process
group, :func:`shard_batch` hands each rank its own block of a batch, and
:func:`gather_batch` gives every rank all the blocks in rank order, which is
what a JAX global array reads as.  The axes of scale are the JAX package's:
the sequence batch (``seq``) and the landmark blocks of Sigma (``lm``).
"""

from __future__ import annotations

import math
import socket

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from ..runtime import configure_runtime

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}  # the backend of a device type unless the caller names one


def init_distributed(coordinator: str | None = None, num_processes: int | None = None,
                     process_id: int | None = None, backend: str | None = None, device: str = "cuda") -> None:
    """Join the process group of ``num_processes`` ranks as rank
    ``process_id``, meeting at ``coordinator`` (``host:port``).

    A no-op for one process, as in the JAX package; :func:`make_mesh` then
    starts a one-rank group itself.  ``backend`` is NCCL for ``cuda`` and
    gloo for ``cpu`` unless the caller names one (NCCL refuses two ranks on
    one card, so ranks that share a card name ``gloo``).
    """
    if num_processes is None or num_processes <= 1:
        return
    backend = backend or BACKENDS[torch.device(device).type]
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", rank=process_id,
                            world_size=num_processes)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def make_mesh(axis_sizes: dict[str, int] | None = None, device: str = "cuda"):
    """A ``DeviceMesh`` over every rank of the process group, on ``device``
    (``cuda`` unless the caller asks for ``cpu``; without a card the default
    raises).

    Default: a 1-D ``seq`` mesh over all ranks.  Pass e.g. ``{"seq": 2,
    "lm": 4}`` for a 2-D mesh with a landmark axis; a shape whose product is
    not the number of ranks raises ``ValueError``.  With no process group
    yet, a one-rank group is started on a free local port, so a
    single-process caller works as with the JAX package's ``make_mesh``.
    """
    from torch.distributed.device_mesh import init_device_mesh

    dev, _ = configure_runtime(device)
    if not dist.is_initialized():
        dist.init_process_group(BACKENDS[dev.type], init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"seq": world}
    shape = tuple(axis_sizes.values())
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} != {world} processes")
    return init_device_mesh(dev.type, shape, mesh_dim_names=tuple(axis_sizes))


def block(n_items: int, mesh, axis: str) -> slice:
    """This rank's contiguous block of ``n_items`` split over ``axis``
    (``NamedSharding``'s layout: rank r holds ``[r n / k, (r + 1) n / k)``)."""
    k, r = dist.get_world_size(mesh.get_group(axis)), mesh.get_local_rank(axis)
    if n_items % k:
        raise ValueError(f"{n_items} items do not split over the {k} ranks of mesh axis {axis!r}")
    b = n_items // k
    return slice(r * b, (r + 1) * b)


def shard_batch(mesh, tree, axis: str = "seq"):
    """This rank's block of every leaf's leading axis, on the rank's device."""
    dev = torch.device(mesh.device_type)
    return tree_map(lambda x: x[block(x.shape[0], mesh, axis)].to(dev), tree)


def all_gather(x: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


def gather_batch(mesh, tree, axis: str = "seq"):
    """Every rank's block of every leaf, in rank order along the leading
    axis: the global batch that :func:`shard_batch` split."""
    group = mesh.get_group(axis)
    return tree_map(lambda x: all_gather(x, group), tree)
