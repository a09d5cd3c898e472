#!/usr/bin/env python3
"""Time the CUDA KLT kernel of the PyTorch port on one GPU.

    python scripts/klt_timing.py [--parent DIR] [--scan] [--out FILE]

Inputs are the main path's KLT shapes (``eqvio_tpu_torch/kernels/klt_bench.py``):
frames 100 and 101 of the benchmark scene (752x480, 4 levels, win 21,
8 steps) with the 30 detected corners, and with the 8 border features added
(38).  For each it prints:

- the kernel's device ms per launch from ``torch.profiler`` and from the
  replay of 50 launches captured in one CUDA graph;
- the wrapper's host ms per call (``time.perf_counter``, no synchronise);
- max |dpos| against the plain version over tracked features, and whether
  the tracked masks agree.

``--parent DIR`` also times the kernel of another checkout (an older commit
unpacked with ``git archive`` into a git-ignored directory) on the same
inputs in the same process, in turns: parent, this tree, this tree, parent.
``--scan`` times this tree's kernel at N = 30 with 1 to 4 levels and 1 to 16
Gauss-Newton steps and fits launch, per-level and per-step parts.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_PX = 2e-4


def load_kernels(checkout: str):
    """``eqvio_tpu_torch.kernels.klt`` of another checkout, imported under
    its own package name so that it sits beside this tree's."""
    pkg = os.path.join(os.path.abspath(checkout), "eqvio_tpu_torch", "kernels")
    spec = importlib.util.spec_from_file_location("parent_kernels", os.path.join(pkg, "__init__.py"),
                                                  submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["parent_kernels"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("parent_kernels.klt")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", default=None, help="checkout whose kernel is timed in turns with this tree's")
    ap.add_argument("--scan", action="store_true", help="split the time into launch, level and step parts")
    ap.add_argument("--out", default=None, help="write every number as JSON here")
    args = ap.parse_args()

    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("klt_timing: needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    from eqvio_tpu_torch.kernels import klt as K
    from eqvio_tpu_torch.kernels import klt_bench as B
    from eqvio_tpu_torch.runtime import configure_runtime

    dev, _ = configure_runtime("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    case = B.klt_case(dev)
    trees = {"this tree": K}
    if args.parent:
        trees["parent"] = load_kernels(args.parent)
    result = {"card": card, "torch": torch.__version__,
              "build_s": {name: mod.build_kernel() for name, mod in trees.items()},
              "ptxas": K.build.ptxas_summary(K._SOURCE), "runs": []}

    def time_tree(label, mod):
        for size, pos in (("main", case.main), ("pair", case.pair)):
            run = lambda: mod.klt_track_pyramid(case.pyr0, case.pyr1, pos, pos, case.win, case.iters)  # noqa: E731
            pos_k, err_k = run()
            pos_p, err_p = K.klt_track_pyramid_plain(case.pyr0, case.pyr1, pos, pos, case.win, case.iters)
            ok = err_p < case.max_error
            row = {"tree": label, "n": len(pos), "profiler_ms": B.profiler_ms(run, "klt_pyramid_kernel"),
                   "graph_ms": B.graph_ms(run), "host_ms": B.host_ms(run),
                   "max_dpos_px": float((pos_k - pos_p).abs()[ok].max()),
                   "masks_equal": bool(torch.equal(ok, err_k < case.max_error))}
            result["runs"].append(row)
            print(f"{label}: n={row['n']}: profiler {row['profiler_ms']} ms, graph {row['graph_ms']:.5f} ms, "
                  f"host {row['host_ms']:.5f} ms/call, max |dpos| {row['max_dpos_px']:.3g} px, masks equal "
                  f"{row['masks_equal']} ({card})", flush=True)

    order = ["parent", "this tree", "this tree", "parent"] if args.parent else ["this tree"]
    for label in order:
        time_tree(label, trees[label])

    if args.scan:
        result["scan"] = []
        for nlev in range(1, len(case.pyr0) + 1):
            for steps in (1, 2, 4, 8, 16):
                run = lambda: K.klt_track_pyramid(case.pyr0[:nlev], case.pyr1[:nlev], case.main,  # noqa: E731
                                                  case.main, case.win, steps)
                row = {"levels": nlev, "iters": steps, "profiler_ms": B.profiler_ms(run, "klt_pyramid_kernel", 20),
                       "graph_ms": B.graph_ms(run)}
                result["scan"].append(row)
                print(f"scan levels {nlev} iters {steps}: profiler {row['profiler_ms']} ms, "
                      f"graph {row['graph_ms']:.5f} ms", flush=True)
        A = np.array([[1.0, r["levels"], r["levels"] * r["iters"]] for r in result["scan"]])
        y = np.array([r["graph_ms"] for r in result["scan"]])
        coef = np.linalg.lstsq(A, y, rcond=None)[0]
        result["scan_fit_ms"] = {"launch": coef[0], "per_level": coef[1], "per_step": coef[2]}
        print(f"scan fit: {result['scan_fit_ms']}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "scan"}), flush=True)
    bad = [r for r in result["runs"]
           if not (r["masks_equal"] and np.isfinite(r["max_dpos_px"]) and r["max_dpos_px"] <= TOL_PX)]
    if bad:
        print(f"klt_timing: {len(bad)} runs disagree with the plain version: {bad[:3]}", file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
