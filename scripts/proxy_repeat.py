#!/usr/bin/env python3
"""Run-to-run reproducibility of a EuRoC proxy through the PyTorch port's
fused path on one GPU, in float32 (square-root covariance).

    python scripts/proxy_repeat.py mh03 [--variants plain plain smoke plain] [--frames N]
        [--deterministic] [--out FILE]

Builds the scene once, then runs it once per variant in one process:
``plain`` is ``run_dataset(chunk_size=16)``; ``eager`` first runs 20 frames
eagerly (``chunk_size=1``); ``traced`` traces chunk 2 of the fused run
(``profile_chunk=2``); ``smoke`` does both, as ``chip_smoke.py`` phase 10
does.  Per run, one
JSON line: position RMSE after a similarity alignment, scale, and against
the first run the first frame whose position differs, the largest
difference, and the first frame whose tracked ids differ.
``--deterministic`` calls ``torch.use_deterministic_algorithms(True,
warn_only=True)``, so each operation without a deterministic CUDA
implementation warns once; set ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the
environment with it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)  # build/ under it is git-ignored


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scene", choices=["mh03", "v101"])
    ap.add_argument("--variants", nargs="+", default=["plain", "plain", "smoke", "plain"],
                    choices=["plain", "eager", "traced", "smoke"])
    ap.add_argument("--frames", type=int, default=None, help="only the first N frames")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = ap.parse_args()
    import numpy as np
    import torch

    from eqvio_tpu_torch.app.run_opt import run_dataset
    from eqvio_tpu_torch.data import mh03_proxy, v101_proxy
    from eqvio_tpu_torch.io import mh03_proxy_config, v101_proxy_config
    from eqvio_tpu_torch.runner import ate_rmse

    if not torch.cuda.is_available():
        sys.exit("proxy_repeat.py: needs an NVIDIA GPU")
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    make, config = {"mh03": (mh03_proxy, mh03_proxy_config), "v101": (v101_proxy, v101_proxy_config)}[args.scene]
    reader, cfg = make(), config()
    gt = reader.groundtruth
    first = None
    for i, variant in enumerate(args.variants):
        t0 = time.perf_counter()
        opts = {}
        if variant in ("eager", "smoke"):
            run_dataset(reader, cfg, device="cuda", chunk_size=1, limit_frames=20)
        if variant in ("traced", "smoke"):
            opts = dict(profile_dir=os.path.join(ROOT, "build", "repeat_profile"), profile_chunk=2)
        _, s = run_dataset(reader, cfg, device="cuda", chunk_size=16, limit_frames=args.frames, **opts)
        torch.cuda.synchronize()
        pos, ids = s["positions"], s["feature_ids"]
        gt_pos = np.stack([np.interp(s["stamps"], gt.stamps, gt.position[:, j]) for j in range(3)], -1)
        rmse, scale = ate_rmse(pos, gt_pos)
        line = {"scene": args.scene, "run": i, "variant": variant, "deterministic": args.deterministic,
                "card": card, "frames": s["frames"], "rmse_m": rmse, "scale": scale,
                "s": time.perf_counter() - t0}
        if first is None:
            first = (pos, ids)
        else:
            d = np.abs(pos - first[0]).max(1)
            bad_ids = (ids != first[1]).any(1)
            line.update(first_frame_pos_differs=int(np.argmax(d > 0)) if (d > 0).any() else None,
                        max_dpos_m=float(d.max()),
                        first_frame_ids_differ=int(np.argmax(bad_ids)) if bad_ids.any() else None)
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
