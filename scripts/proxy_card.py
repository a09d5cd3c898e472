#!/usr/bin/env python3
"""The EuRoC proxy scenes at full length through the PyTorch port's fused
path on one GPU, in float32 (square-root covariance).

    python scripts/proxy_card.py [v101] [distractor] [mh03] [--out FILE]

``v101``: the 144 s V1_01 proxy with ``configs/config_v101_proxy.yaml``
(gate 0.038 m, 1.2x a fresh ``eqvio_tpu`` float64 run's 0.03166 m on the
same scene, ``scripts/proxy_witness.py``; scale within 0.05 of 1);
``distractor``: the 45 s distractor scene with the same config, the
epipolar gate on and off (the gate must beat gate-off and stay below
0.15 m); ``mh03``: the 132 s MH_03 proxy (gate 0.056 m), as
``chip_smoke.py`` phase 10 runs it.  One JSON line per run: the card and
its power limit, frames, position RMSE after a similarity alignment,
scale, host ms/frame without the set-up, device ms/frame and the seconds
the scene took to build on the host.  Exits nonzero if a gate fails.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# V1_01: 1.2x today's eqvio_tpu float64 result (0.03166 m); the committed
# 0.0804 m (tests/test_proxy_slow.py's 0.097 m gate) is not reproduced by it
GATES = {"v101": 0.038, "mh03": 0.056, "distractor": 0.15}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scenes", nargs="*", default=["v101", "distractor"])
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args()
    import numpy as np
    import torch

    from eqvio_tpu_torch.app.run_opt import run_dataset
    from eqvio_tpu_torch.data import distractor_proxy, mh03_proxy, v101_proxy
    from eqvio_tpu_torch.io import mh03_proxy_config, v101_proxy_config
    from eqvio_tpu_torch.runner import ate_rmse

    if not torch.cuda.is_available():
        sys.exit("proxy_card.py: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    readers = {"v101": (v101_proxy, v101_proxy_config), "mh03": (mh03_proxy, mh03_proxy_config),
               "distractor": (distractor_proxy, v101_proxy_config)}
    failed = []
    for name in args.scenes:
        make, config = readers[name]
        t0 = time.perf_counter()
        reader = make()
        build_s = time.perf_counter() - t0
        cfg_on = config()
        runs = [("", cfg_on)]
        if name == "distractor":
            cfg_off = copy.deepcopy(cfg_on)
            cfg_off["GIFT"]["ransacParams"]["inlierThreshold"] = 0.0  # the gate off
            runs = [(" gate on", cfg_on), (" gate off", cfg_off)]
        rmse = {}
        for tag, cfg in runs:
            t0 = time.perf_counter()
            _, summary = run_dataset(reader, cfg, device="cuda", chunk_size=16)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            gt = reader.groundtruth
            gt_pos = np.stack([np.interp(summary["stamps"], gt.stamps, gt.position[:, i]) for i in range(3)], -1)
            rmse[tag], scale = ate_rmse(summary["positions"], gt_pos)
            line = {"scene": name + tag, "card": card, "frames": summary["frames"], "healthy": summary["healthy"],
                    "rmse_m": rmse[tag], "scale": scale,
                    "ms_per_frame": (wall - summary["setup_s"]) * 1e3 / summary["frames"],
                    "device_ms_per_frame": summary.get("device_ms_per_frame"), "scene_build_s": build_s}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
            if not summary["healthy"] or not rmse[tag] < GATES[name] or (name != "distractor" and
                                                                         abs(scale - 1.0) > 0.05):
                failed.append(name + tag)
        if name == "distractor" and not rmse[" gate on"] < rmse[" gate off"]:
            failed.append("distractor: the gate did not beat gate-off")
    if failed:
        sys.exit(f"proxy_card.py: outside the gates: {failed}")


if __name__ == "__main__":
    main()
