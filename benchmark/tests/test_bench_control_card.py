"""The control on the card at a size a test run can hold: the reference at
the control's precision (TF32 matmuls, a bfloat16 pyramid) put in the
program's place exceeds a limit of each cell, where the program on the same
stretches stays inside them."""

from __future__ import annotations

import pytest
import torch

from benchmark.compare import judge
from benchmark.drivers import load
from benchmark.spans import Spans
from benchmark.tests.small import small_cell, window_seconds


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mh03.seq", "racing.seq", "mh03.batch"])
def test_control_fails_where_the_program_passes(workload, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 matmuls run only on an NVIDIA card")
    cell = small_cell(workload)
    drv = load(cell.mix["driver"])(cell.cfg, cell.mix, cell.config, 2**31 + 5, "cuda", Spans(), str(tmp_path))
    drv.setup()
    drv.window(window_seconds(cell))
    program, control = drv.readings("cuda")
    assert judge(program, cell.limits)[0]
    assert not judge(control, cell.limits)[0]
