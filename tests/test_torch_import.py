"""The PyTorch port stands alone: importing it loads neither JAX nor the JAX
package (nor PyYAML or PIL, which the GPU machine may lack), its KLT wrapper
takes the plain path on CPU tensors without counting a launch, its entry
points run on the card unless asked for the CPU, and ``chip_smoke.py`` fails
without a card."""

import os
import shutil
import subprocess
import sys
from unittest import mock

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import eqvio_tpu_torch
names = [m.name for m in pkgutil.walk_packages(eqvio_tpu_torch.__path__, "eqvio_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "eqvio_tpu", "yaml", "PIL"))
print(len(names), bad)
assert not bad, bad
"""


def _clean_env():
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env["PYTHONPATH"] = REPO
    return env


SIM_MODULES = ("eqvio_tpu_torch.sim", "eqvio_tpu_torch.runner", "eqvio_tpu_torch.app.run_sim",
               "eqvio_tpu_torch.parallel", "eqvio_tpu_torch.parallel.batch", "eqvio_tpu_torch.graph",
               "eqvio_tpu_torch.parallel.mesh", "eqvio_tpu_torch.parallel.landmark_shard",
               "eqvio_tpu_torch.parallel.dist_worker", "eqvio_tpu_torch.parallel.dryrun")


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL + "print(' '.join(names))"], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    lines = res.stdout.splitlines()
    n_modules = int(lines[0].split()[0])
    assert n_modules >= 50
    # the simulation and parallel slices are walked and imported too, and load no jax
    assert set(SIM_MODULES) <= set(lines[1].split())


def test_runner_loads_no_app_or_front_end():
    """The simulation runner is a library layer: it takes the captured step
    from ``graph`` and loads no CLI app, image front end, data server or io."""
    code = ("import sys, eqvio_tpu_torch.runner\n"
            "print(' '.join(sorted(m for m in sys.modules if m.startswith('eqvio_tpu_torch.'))))")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    loaded = res.stdout.split()
    assert "eqvio_tpu_torch.graph" in loaded
    assert not [m for m in loaded if m.split(".")[1] in ("app", "frontend", "data", "io", "kernels")], loaded


def test_klt_wrapper_uses_plain_path_on_cpu():
    from eqvio_tpu_torch.kernels import klt as K

    rng = np.random.default_rng(0)
    pyr0 = [torch.tensor(rng.uniform(0, 1, (60 >> i, 80 >> i)).astype(np.float32)) for i in range(3)]
    pyr1 = [p.roll(1, dims=1) for p in pyr0]
    pos = torch.tensor(rng.uniform(15, 45, (5, 2)).astype(np.float32))
    before = K.klt_track_pyramid.launches
    out = K.klt_track_pyramid(pyr0, pyr1, pos, pos, win=7, iters=4)
    ref = K.klt_track_pyramid_plain(pyr0, pyr1, pos, pos, win=7, iters=4)
    assert K.klt_track_pyramid.launches == before == 0
    torch.testing.assert_close(out, ref, rtol=0, atol=0)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(tmp_path, where):
    """Without CUDA (or outside the repo) the script exits nonzero and
    prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: chip_smoke.py would run for real")
    if where == "repo":
        cwd, env = REPO, _clean_env()
    else:
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd, env = str(tmp_path), {k: v for k, v in _clean_env().items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_runtime_device_policy():
    """CPU runs the filter in float64; CUDA is float32 and is never silently
    replaced by the CPU; TF32 is off for matmul and cuDNN."""
    from eqvio_tpu_torch.runtime import configure_runtime

    dev, dtype = configure_runtime("cpu")
    assert dev.type == "cpu" and dtype == torch.float64
    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            configure_runtime("cuda")
    with pytest.raises(ValueError):
        configure_runtime("mps")



def test_entry_points_default_to_the_card():
    """``configure_runtime``, ``run_dataset`` and the CLI's ``--device``
    default to CUDA; without a card that default raises rather than running
    on the CPU."""
    from eqvio_tpu_torch.app import run_opt
    from eqvio_tpu_torch.data import SyntheticASLReader
    from eqvio_tpu_torch.io import bench_config
    from eqvio_tpu_torch.runtime import configure_runtime

    seen = {}

    def fake_run(dataset, config, **kwargs):
        seen.update(kwargs)
        return None, {"healthy": True, "frames": 0, "fps": 0.0, "landmarks": 0}

    with mock.patch.object(run_opt, "load_config", return_value={}), \
            mock.patch.object(run_opt, "run_dataset", side_effect=fake_run):
        run_opt.main(["dataset_dir", "config.yaml"])
    assert seen["device"] == "cuda"

    if torch.cuda.is_available():
        dev, dtype = configure_runtime()
        assert dev.type == "cuda" and dtype == torch.float32
        return
    with pytest.raises(RuntimeError, match="cuda"):
        configure_runtime()
    reader = SyntheticASLReader(end_time=0.5, frame_freq=10.0, num_points=50)
    with pytest.raises(RuntimeError, match="cuda"):
        run_opt.run_dataset(reader, bench_config(), limit_frames=1)


def test_parallel_entry_points_default_to_the_card():
    """``make_batched_states`` and ``make_mesh`` run on CUDA unless asked
    for the CPU; without a card the default raises before a process group
    is started."""
    import torch.distributed as dist

    from eqvio_tpu_torch.filter import Settings
    from eqvio_tpu_torch.parallel import make_batched_states, make_mesh

    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        make_batched_states(Settings(), 2, 4)
    with pytest.raises(RuntimeError, match="cuda"):
        make_mesh()
    assert not dist.is_initialized()
    assert make_batched_states(Settings(), 2, 4, device="cpu").Sigma.shape[0] == 2
