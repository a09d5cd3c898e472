"""The port's parallel slice (``eqvio_tpu_torch.parallel``) against
``eqvio_tpu`` on the CPU.

Every multi-rank run is a set of gloo processes (``parallel/dryrun.py`` and
``parallel/dist_worker.py`` with ``--device cpu --backend gloo``), so no
process group is ever started in the test worker.  The seeded inputs reach
the ranks through an ``.npz``; the JAX side runs here on the 8-device
virtual mesh of ``tests/conftest.py``.  Three launches start together when
the module's first test asks for them: two ranks (mesh, sequence-sharded
runner and fleet, square-root updates), four ranks (the dense update) and
two ``dist_worker`` processes.

- mesh: ``make_mesh()`` spans the 2 ranks, ``{"seq": 3}`` raises, and the
  ranks' ``shard_batch`` blocks are ``NamedSharding``'s and gather back
  bitwise;
- the landmark-sharded update against JAX's on ``{"lm": 8}`` and the port's
  local ``update_vision``: dense float64 on 4 ranks (Sigma 1e-9, X 1e-10),
  square root float32 and float64 on 2 ranks (1e-4 / 1e-9, and ``L L^T``
  against the dense update 5e-3 / 1e-8); every rank's state equals rank 0's
  bitwise;
- the sequence-sharded runner (batch 8, float64) against the port's run
  without a mesh (1e-12 m) and JAX's on ``{"seq": 8}`` (1e-8 m), and the
  sharded fleet of four seeds against JAX's fleet and each lane's own run
  (1e-8 m);
- two ``dist_worker`` processes print ``DIST_OK``.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from torch.utils._pytree import tree_flatten, tree_unflatten

from eqvio_tpu import filter as JF
from eqvio_tpu import runner as JR
from eqvio_tpu import states as JS
from eqvio_tpu.parallel import make_mesh as jax_make_mesh
from eqvio_tpu.parallel import sharded_vision_update as jax_sharded_update
from eqvio_tpu_torch import convert
from eqvio_tpu_torch import filter as F
from eqvio_tpu_torch.runner import default_sim_camera

from .utils import reasonable_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180
SEQ_SETTINGS = dict(measurement_noise=0.5, coordinate_choice="invdepth", fast_riccati=True,
                    use_discrete_innovation_lift=False, use_median_depth=False, initial_scene_depth=2.5)
SCENE = dict(capacity=8, max_features=6, end_time=3.0)
SEQ_BATCH, FLEET_SEEDS = 8, 4
N, N_VISIBLE = 16, 12
# the update problems: name -> (seed, JAX dtype, Settings fields, ranks)
PROBLEMS = {
    "dense64": (21, jnp.float64, dict(measurement_noise=0.5), 4),
    "sqrt32": (22, jnp.float32, dict(measurement_noise=0.5, sqrt_covariance=True), 2),
    "sqrt64": (22, jnp.float64, dict(measurement_noise=0.5, sqrt_covariance=True), 2),
}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class _Launch:
    """``world`` processes of ``python -m module <rank> <world> <port> ...``."""

    def __init__(self, module: str, world: int, args: list[str]):
        env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
        env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
        port = str(_free_port())
        self.procs = [subprocess.Popen([sys.executable, "-m", module, str(r), str(world), port] + args, cwd=REPO,
                                       env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                      for r in range(world)]
        self.outs = None

    def wait(self) -> list[str]:
        if self.outs is None:
            try:
                self.outs = [p.communicate(timeout=TIMEOUT_S)[0] for p in self.procs]
            finally:
                for p in self.procs:
                    p.kill()
            for p, out in zip(self.procs, self.outs):
                assert p.returncode == 0, out[-3000:]
        return self.outs


def _problem(name):
    """The JAX state, pixels and visibility of an update problem (the setups
    of ``tests/test_parallel.py``)."""
    seed, dtype, fields, _ = PROBLEMS[name]
    rng = np.random.default_rng(seed)
    cam = JR.default_sim_camera(dtype)
    settings = JF.Settings(**fields)
    xi0 = reasonable_state(rng, N, n_active=N_VISIBLE)
    xi0 = jax.tree.map(lambda a: a.astype(dtype) if a.dtype.kind == "f" else a, xi0)
    state = JF.init_state(settings, N, dtype)._replace(xi0=xi0)
    pix_true, _ = JS.measure_system(xi0, cam)
    pixels = (pix_true + jnp.asarray(rng.normal(size=(N, 2)) * 0.5)).astype(dtype)
    vis = jnp.asarray(np.arange(N) < N_VISIBLE)
    return settings, cam, state, pixels, vis


def _port_state(jax_state, dtype):
    return convert.eqf_state_from_numpy(jax_state, dtype, "cpu")


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("parallel")
    arrays, ranks = {}, {}
    for name, (_, dtype, fields, world) in PROBLEMS.items():
        _, _, state, pixels, vis = _problem(name)
        leaves = tree_flatten(_port_state(state, torch.float32 if dtype == jnp.float32 else torch.float64))[0]
        arrays.update({f"{name}/leaf{i}": a.numpy() for i, a in enumerate(leaves)})
        arrays[f"{name}/pixels"], arrays[f"{name}/vis"] = np.asarray(pixels), np.asarray(vis)
        ranks.setdefault(world, {})[name] = fields
    np.savez(tmp / "inputs.npz", **arrays)
    sim = dict(SCENE, dtype="float64")
    specs = {
        2: {"mesh": {}, "seq": dict(sim, batch=SEQ_BATCH, reps=0), "fleet": dict(sim, seeds=FLEET_SEEDS),
            "update": {"inputs": str(tmp / "inputs.npz"), "problems": ranks[2]}},
        4: {"update": {"inputs": str(tmp / "inputs.npz"), "problems": ranks[4]}},
    }
    runs = {}
    for world, spec in specs.items():
        with open(tmp / f"spec{world}.json", "w") as f:
            json.dump(spec, f)
        runs[world] = _Launch("eqvio_tpu_torch.parallel.dryrun", world, [
            "--device", "cpu", "--backend", "gloo", "--out", str(tmp / f"out{world}"),
            "--spec", str(tmp / f"spec{world}.json")])
    runs["worker"] = _Launch("eqvio_tpu_torch.parallel.dist_worker", 2, ["--device", "cpu", "--backend", "gloo"])

    def ranks_of(world):
        runs[world].wait()
        return [dict(np.load(tmp / f"out{world}" / f"rank{r}.npz")) for r in range(world)]

    yield ranks_of, runs["worker"]
    for run in runs.values():
        for p in run.procs:
            p.kill()


@pytest.fixture(scope="module")
def jax_sim_inputs():
    settings = JF.Settings(**SEQ_SETTINGS)
    return settings, [JR.prepare_sim_inputs(settings, seed=k, dtype=jnp.float64, **SCENE)
                      for k in range(FLEET_SEEDS)]


def test_sequence_sharded_runner_matches_jax(launches, jax_sim_inputs):
    ranks_of, _ = launches
    settings, inputs = jax_sim_inputs
    ref = JR.build_sim_runner(settings, inputs[0], augment_true_landmarks=False, compute_nees=False,
                              batch=SEQ_BATCH, mesh=jax_make_mesh({"seq": 8}))()
    out = ranks_of(2)
    got = out[0]["seq/est_position"]
    assert got.shape == (SEQ_BATCH, 55, 3) and np.isfinite(got).all()
    assert all(res["seq/err_m"] <= 1e-12 for res in out)  # against the port's run without a mesh
    np.testing.assert_allclose(got, np.asarray(ref.est_position), atol=1e-8, rtol=0)


def test_sequence_sharded_fleet_matches_jax(launches, jax_sim_inputs):
    ranks_of, _ = launches
    settings, inputs = jax_sim_inputs
    ref = JR.build_fleet_runner(settings, inputs)()
    out = ranks_of(2)
    got = out[0]["fleet/est_position"]
    assert got.shape == (FLEET_SEEDS, 55, 3)
    assert all(res["fleet/err_m"] <= 1e-8 for res in out)  # each lane against its own single run
    np.testing.assert_allclose(got, np.asarray(ref.est_position), atol=1e-8, rtol=0)
    assert np.abs(got[0] - got[2]).max() > 1e-6  # the ranks ran different sequences


def test_mesh_blocks_are_named_sharding_layout(launches):
    ranks_of, _ = launches
    out = ranks_of(2)
    for res in out:
        assert res["mesh/seq_size"] == 2 and res["mesh/raised"] and res["mesh/roundtrip_equal"]
    # the batch of parallel/dryrun.py's mesh case (4 rows per rank), laid out by JAX
    rng = np.random.default_rng(0)
    B = 8
    batch = (rng.normal(size=(B, 2, 3)), rng.integers(-5, 5, size=B), rng.uniform(size=B) < 0.5)
    devices = jax.devices()[:2]
    sharding = NamedSharding(Mesh(np.asarray(devices), ("seq",)), P("seq"))
    for i, leaf in enumerate(batch):
        shards = {s.device: np.asarray(s.data) for s in jax.device_put(leaf, sharding).addressable_shards}
        for r, res in enumerate(out):
            np.testing.assert_array_equal(res[f"mesh/block{i}"], shards[devices[r]])
            np.testing.assert_array_equal(res[f"mesh/block{i}"], leaf[r * B // 2:(r + 1) * B // 2])


@pytest.mark.parametrize("name", list(PROBLEMS))
def test_sharded_update_matches_jax_and_local(launches, name):
    ranks_of, _ = launches
    _, dtype, fields, world = PROBLEMS[name]
    settings, cam, state, pixels, vis = _problem(name)
    ref_jax = jax.jit(jax_sharded_update(jax_make_mesh({"lm": 8}), settings, cam))(state, pixels, vis)
    out = ranks_of(world)

    tdtype = torch.float32 if dtype == jnp.float32 else torch.float64
    settings_t = F.Settings(**fields)
    state_t = _port_state(state, tdtype)
    spec = tree_flatten(state_t)[1]
    leaves = [[torch.as_tensor(res[f"update/{name}/leaf{i}"]) for i in range(spec.num_leaves)] for res in out]
    for r in range(1, world):  # the state is replicated: every rank ends with rank 0's
        for a, b in zip(leaves[r], leaves[0]):
            assert torch.equal(a, b), f"rank {r}"
    got = tree_unflatten(leaves[0], spec)
    local = F.update_vision(state_t, torch.tensor(np.asarray(pixels)), torch.tensor(np.asarray(vis)),
                            default_sim_camera(tdtype, "cpu"), settings_t)

    tol_sigma, tol_x = {"dense64": (1e-9, 1e-10), "sqrt32": (1e-4, 1e-4), "sqrt64": (1e-9, 1e-9)}[name]
    for ref in (ref_jax, local):
        np.testing.assert_allclose(got.Sigma.numpy(), np.asarray(ref.Sigma), atol=tol_sigma)
        np.testing.assert_allclose(got.X.A.R.numpy(), np.asarray(ref.X.A.R), atol=tol_x)
        np.testing.assert_allclose(got.X.Q.a.numpy(), np.asarray(ref.X.Q.a), atol=tol_x)
    assert all(res[f"update/{name}/err_local"] <= tol_sigma for res in out)
    if settings_t.sqrt_covariance:
        # the factor reconstructs the dense-mode update's covariance
        dense = JF.update_vision(state._replace(Sigma=(state.Sigma @ state.Sigma.T).astype(dtype)), pixels, vis,
                                 cam, JF.Settings(measurement_noise=0.5))
        np.testing.assert_allclose((got.Sigma @ got.Sigma.T).numpy(), np.asarray(dense.Sigma),
                                   atol=5e-3 if dtype == jnp.float32 else 1e-8)


def test_dist_worker_two_processes(launches):
    _, worker = launches
    outs = worker.wait()
    assert "DIST_OK processes=2 global_devices=2 batch=2 active_landmarks=32" in outs[0], outs[0][-2000:]
