"""A run with the timed path broken underneath comes out not correct; the
same small run, sound, comes out correct.  The harness's look for a card is
skipped (``run_cell`` on the CPU); the faults are the ones each cell can
have: a step that returns its state unchanged, half of the lanes left out,
an answer altered where it is produced (every tracked pixel, or a tenth of
the tracks: the slots 0, 10, 20 and 30).  The limits are the cells' own."""

from __future__ import annotations

import pytest
import torch

from benchmark.run import run_cell
from benchmark.tests.small import small_cell, window_seconds


def _moved(pixels: torch.Tensor, fault: str) -> torch.Tensor:
    """``pixels [..., 2N]`` with every track, or every tenth slot's, moved a
    quarter pixel."""
    if fault == "altered":
        return pixels + 0.25
    shift = torch.zeros(pixels.shape[-1] // 2, 2, dtype=pixels.dtype, device=pixels.device)
    shift[::10] = 0.25
    return pixels + shift.reshape(-1)


def _frame_fault(monkeypatch, fault):
    from eqvio_tpu_torch.app import run_opt

    make = run_opt._make_frame_fn

    def broken(tcfg, *args, **kw):
        fn = make(tcfg, *args, **kw)
        N = tcfg.max_features

        def frame_fn(carry, img, meta):
            new, out = fn(carry, img, meta)
            if fault == "unchanged":
                return carry, out
            return new, torch.cat([out[:34 + 5 * N], _moved(out[34 + 5 * N:34 + 7 * N], fault), out[34 + 7 * N:]])
        return frame_fn

    monkeypatch.setattr(run_opt, "_make_frame_fn", broken)


def _hook(monkeypatch, workload, fault):
    def hook(drv):
        if workload.endswith(".seq"):
            _frame_fault(monkeypatch, fault)
            return
        step, run = drv.runner.step, drv.runner.run
        B = drv.mix["lanes"]

        def broken(imgs, meta, outs=None):
            if fault == "unchanged":  # every frame from the chunk's first carry
                carry = [t.clone() for t in step.snapshot()]
                for i in range(imgs.shape[1]):
                    step.restore(carry)
                    outs[:, i].copy_(step(imgs[:, i], meta[:, i]))
                return outs
            res = run(imgs, meta, outs)
            if fault == "half":
                res[B // 2:] = 0.0  # the second half of the lanes left out
            else:  # tracked pixels moved a quarter pixel where the row is written
                px = res[..., 34 + 5 * drv.N:34 + 7 * drv.N]
                px.copy_(_moved(px, fault))
            return res
        drv.runner.run = broken
    return hook


CASES = [("mh03.seq", "unchanged"), ("mh03.seq", "altered"), ("mh03.seq", "tenth"), ("racing.seq", "tenth"),
         ("mh03.batch", "half"), ("mh03.batch", "unchanged"), ("mh03.batch", "altered"), ("mh03.batch", "tenth")]


@pytest.mark.parametrize("workload,fault", CASES, ids=[f"{w}-{f}" for w, f in CASES])
def test_fault_is_not_correct(workload, fault, monkeypatch, tmp_path):
    torch.set_num_threads(4)
    cell = small_cell(workload)
    res = run_cell(cell, 424242, window_seconds(cell), False, device="cpu", out_root=str(tmp_path),
                   driver_hook=_hook(monkeypatch, workload, fault))
    assert res["correct"] is False
    assert any(c["value"] is None or c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("workload", ["mh03.seq", "racing.seq", "mh03.batch"])
def test_sound_run_is_correct(workload, tmp_path):
    torch.set_num_threads(4)
    cell = small_cell(workload)
    res = run_cell(cell, 2**31 + 77, window_seconds(cell), False, device="cpu", out_root=str(tmp_path))
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0 and set(res) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(res)[-1] == "checks"
