#!/usr/bin/env python3
"""Count the device records ``torch.profiler`` loses from a traced chunk of
the PyTorch port's fused path, on one GPU.

    python scripts/trace_loss.py [--reps 3] [--tail 0 0.2] [--out FILE]

Each repetition runs 32 frames of the benchmark scene through
``run_dataset(chunk_size=16, profile_chunk=1)``, once with the benchmark
config in float32 and once with ``configs/config_template.yaml``'s switches
(accurate Riccati, dense covariance) in float64, for each ``--tail`` value
of ``run_opt.TRACE_TAIL_S`` (how long the trace stays open after the
chunk's device work ends).  Every graph launch replays the same captured
graph, so a launch that shows fewer device events than the most any launch
shows lost records in the tracer.  One JSON line per run: the events lost
per graph launch and the ``klt_pyramid_kernel`` launches each shows.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--tail", type=float, nargs="+", default=[0.0, 0.2])
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import torch

    import chip_smoke as S
    import eqvio_tpu_torch.app.run_opt as R
    from eqvio_tpu_torch.data import bench_scene
    from eqvio_tpu_torch.io import bench_config, template_config

    if not torch.cuda.is_available():
        sys.exit("trace_loss: needs an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    reader = bench_scene(8.0)
    configs = (("bench_f32", bench_config(), torch.float32), ("template_f64", template_config(), torch.float64))
    lines = []
    for name, cfg, dtype in configs:
        for tail in args.tail:
            R.TRACE_TAIL_S = tail
            for rep in range(args.reps):
                trace_dir = os.path.join(HERE, "build", "trace_loss", f"{name}_{tail}_{rep}")
                R.run_dataset(reader, cfg, device="cuda", chunk_size=16, limit_frames=32, dtype=dtype,
                              profile_dir=trace_dir, profile_chunk=1)
                _, events, replays, _ = S.trace_counts(os.path.join(trace_dir, "trace.json"))
                per, _ = S.klt_in_graph_launches(events, replays)
                full = max(n for n, _ in per)
                line = {"config": name, "tail_s": tail, "rep": rep, "events_per_launch": full,
                        "lost_per_launch": [full - n for n, _ in per], "klt_per_launch": [k for _, k in per],
                        "card": card}
                lines.append(line)
                print(json.dumps(line), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write("".join(json.dumps(line) + "\n" for line in lines))


if __name__ == "__main__":
    main()
