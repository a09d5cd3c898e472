"""The readings that the comparison's limits are set from: for each seed,
one run of the cell (set-up, a short window, the check) and the control in
the program's place over the same stretches, in one process.

    python3 -m benchmark.control --workload mh03.seq --seeds 11 12 13 --seconds 5 \\
        --control-seeds 2 --out build/control.jsonl

Prints and appends one JSON line per seed: ``{"workload", "seed",
"program": {...}, "control": {...}}`` with ``pos_gap_m``, ``px_gap``,
``px_gap_median``, ``id_mismatch`` and the stretches; the control is read
on the first ``--control-seeds`` seeds (all by default) and is null after.
On a card only: the control's TF32 matmuls exist only there.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control-seeds", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    import torch

    from . import drivers
    from .run import ROOT, Cell
    from .spans import Spans

    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    cell = Cell(args.workload)
    out_dir = os.path.join(ROOT, "build", "bench_control", cell.name)
    n_control = len(args.seeds) if args.control_seeds is None else args.control_seeds
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        drv = drivers.load(cell.mix["driver"])(cell.cfg, cell.mix, cell.config, seed, "cuda", Spans(), out_dir)
        drv.setup()
        drv.window(args.seconds)
        t1 = time.perf_counter()
        prog, ctrl = drv.readings("cuda", control=i < n_control)
        line = {"workload": cell.name, "seed": seed, "failed": drv.failed, "program": prog, "control": ctrl,
                "run_s": t1 - t0, "check_s": time.perf_counter() - t1}
        print(json.dumps(line, default=float), flush=True)
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(line, default=float) + "\n")
        del drv
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
