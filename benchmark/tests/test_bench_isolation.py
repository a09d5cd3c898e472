"""The harness loads neither JAX nor the JAX package, and gives no result
where it cannot run: without a card, or without the program beside it."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "eqvio_tpu"}


def _env():
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return env


def test_no_source_imports_jax():
    for dirpath, _, files in os.walk(BENCH):
        for name in files:
            if not name.endswith(".py"):
                continue
            with open(os.path.join(dirpath, name)) as f:
                tree = ast.parse(f.read())
            for node in ast.walk(tree):
                mods = []
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                    mods = [node.module]
                assert not {m.split(".")[0] for m in mods} & FORBIDDEN, (name, mods)


def test_a_run_loads_no_jax(tmp_path):
    """A small cell run end to end (set-up, window, check) in its own
    process: afterwards ``sys.modules`` holds no top-level name of JAX or of
    the JAX package, compared whole (the port's name begins with the JAX
    package's)."""
    code = f"""
import json, sys, torch
torch.set_num_threads(4)
from benchmark.run import run_cell, forbidden_modules
from benchmark.tests.small import small_cell, window_seconds
cell = small_cell("mh03.batch")
res = run_cell(cell, 99, window_seconds(cell), False, device="cpu", out_root={str(tmp_path)!r})
print(json.dumps({{"correct": res["correct"], "forbidden": forbidden_modules(),
                  "port": "eqvio_tpu_torch" in sys.modules}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"correct": True, "forbidden": [], "port": True}


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "mh03.seq", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_without_the_program_no_result(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark's own files alone:
    the run stops when it reaches for the program."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("from benchmark.run import Cell, run_cell\n"
            "print(run_cell(Cell('mh03.seq'), 1, 1.0, False, device='cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env={**_env(), "PYTHONPATH": ""},
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "eqvio_tpu_torch" in out.stderr
