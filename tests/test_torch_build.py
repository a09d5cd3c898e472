"""The port's kernel build (``eqvio_tpu_torch/kernels/build.py``) on the CPU.

``nvcc`` and the loader are stood in for, so the bookkeeping runs without a
card: a library is built once per source text, and its ``ptxas -v`` report
stays readable when a later process loads the library from disk.
"""

import subprocess
from pathlib import Path

import pytest

from eqvio_tpu_torch.kernels import build

REPORT = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z18klt_pyramid_kernelILi2EEv10KltPyramidPKfS2_PfS3_ii' for 'sm_90a'
ptxas info    : Function properties for _Z18klt_pyramid_kernelILi2EEv10KltPyramidPKfS2_PfS3_ii
    8 bytes stack frame, 8 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 64 registers, used 2 barriers, 8 bytes cumulative stack size
"""


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """``nvcc`` writes an empty library and prints REPORT; ``CDLL`` returns
    the path it was given.  Returns the list of nvcc command lines."""
    calls = []

    def run(cmd, capture_output, text):
        calls.append(cmd)
        Path(cmd[cmd.index("-o") + 1]).write_bytes(b"")
        return subprocess.CompletedProcess(cmd, 0, stdout="", stderr=REPORT)

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", run)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    return calls


def test_load_twice_builds_once_and_keeps_the_ptxas_report(fake_toolchain, monkeypatch):
    assert build.ptxas_summary("klt_cuda.cu") == {}
    first = build.load("klt_cuda.cu")
    summary = build.ptxas_summary("klt_cuda.cu")
    assert summary == {"_Z18klt_pyramid_kernelILi2EEv10KltPyramidPKfS2_PfS3_ii":
                       {"registers": 64, "spill_bytes": 24, "smem_bytes": 0}}
    assert build.load("klt_cuda.cu") == first  # the same process: no second build
    monkeypatch.setattr(build, "_loaded", {})  # a later process, the library on disk
    assert build.load("klt_cuda.cu") == first
    assert len(fake_toolchain) == 1
    assert build.ptxas_summary("klt_cuda.cu") == summary
    assert Path(first) == build.library_path("klt_cuda.cu")
    assert Path(first).with_suffix(".ptxas.txt").read_text() == REPORT


def test_failed_build_leaves_no_library(fake_toolchain, monkeypatch):
    def fail(cmd, capture_output, text):
        return subprocess.CompletedProcess(cmd, 1, stdout="", stderr="error: bad source")

    monkeypatch.setattr(build.subprocess, "run", fail)
    with pytest.raises(RuntimeError, match="bad source"):
        build.load("klt_cuda.cu")
    assert not build.library_path("klt_cuda.cu").exists()
    assert build.ptxas_summary("klt_cuda.cu") == {}
