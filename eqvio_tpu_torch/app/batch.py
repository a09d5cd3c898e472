"""Batch dataset runner and analysis (counterpart of ``eqvio_tpu/app/batch.py``,
the reference's ``run_and_analyse_dataset.py``).

Reads a dataset-list YAML (``datasets:`` entries of ``name``, ``location``
and optionally ``mode``, ``config``, ``camera``, ``start``, ``stop``,
``groundtruth``, ``gt_format``), runs the pipeline over each sequence one
after another, analyses each output directory against its ground truth into
``<output>/<name>/results.yaml``, and writes the roll-up ``summary.yaml``,
merged with the results already on disk.  With ``--checkpointEvery`` a
sequence whose ``<output>/<name>/checkpoint.npz`` exists resumes from it.

Usage:
    python -m eqvio_tpu_torch.app.batch datasets.yaml config.yaml --output out/
        [--device cuda|cpu] [--noPlots] [--noTiming] [--checkpointEvery N]

On the card (``cuda``, the default) the filter runs in float32; ``--device
cpu`` runs it in float64.  The figures need matplotlib; ``--noPlots`` runs
without it.
"""

from __future__ import annotations

import argparse
import glob
import os

from ..analysis import analyse_output_dir, make_report, summarise_results
from ..io import load_config
from .run_opt import run_dataset


def run_batch(dataset_list: str, config_path: str, output_root: str, device: str = "cuda", dtype=None,
              plots: bool = True, timing: bool = True, checkpoint_every: int = 0,
              config_path_by_entry: bool = True, runs: dict | None = None) -> dict:
    """Run and analyse every sequence of ``dataset_list``; returns the
    roll-up summary (also written to ``<output_root>/summary.yaml``).
    ``runs``, if given, receives each sequence's ``run_dataset`` summary
    under its name."""
    import yaml

    with open(dataset_list) as f:
        datasets = yaml.safe_load(f)
    config = load_config(config_path)

    result_files = []
    for entry in datasets.get("datasets", []) if isinstance(datasets, dict) else datasets:
        name = entry["name"]
        out_dir = os.path.join(output_root, name)
        print(f"=== {name} ===", flush=True)
        # an entry may carry its own config, so that sequences tuned apart share one batch
        cfg = load_config(entry["config"]) if (config_path_by_entry and entry.get("config")) else config
        ckpt = os.path.join(out_dir, "checkpoint.npz")
        resume = ckpt if (checkpoint_every and os.path.exists(ckpt)) else None
        if resume:
            print(f"  resuming from {ckpt}", flush=True)
        _, summary = run_dataset(
            entry["location"], cfg, mode=entry.get("mode", "asl"), output_dir=out_dir, start=entry.get("start"),
            stop=entry.get("stop"), camera_yaml=entry.get("camera"), timing=timing, device=device, dtype=dtype,
            checkpoint_every=checkpoint_every, resume=resume,
        )
        if runs is not None:
            runs[name] = summary
        print(f"  {summary['frames']} frames @ {summary['fps']:.1f} fps "
              f"(device {summary.get('device_ms_per_frame', '?')} ms/frame, "
              f"dispatch {summary.get('dispatch_ms_per_frame', '?')} ms/frame, "
              f"decoder {summary['decoder']} {summary['decode_ms_per_frame']} ms/frame)", flush=True)
        gt = entry.get("groundtruth") or os.path.join(entry["location"], "mav0", "state_groundtruth_estimate0",
                                                      "data.csv")
        gt_format = entry.get("gt_format", "asl")
        if os.path.exists(gt):
            res = analyse_output_dir(out_dir, gt, gt_format=gt_format)
            print(f"  position rmse: {res['position (m)']['rmse']:.4f} m  scale: {res['scale']:.4f}", flush=True)
            result_files.append(os.path.join(out_dir, "results.yaml"))
            if plots:
                make_report(out_dir, gt, gt_format=gt_format)

    # merged with the per-sequence results already on disk, so that a rerun of
    # part of the list updates the roll-up instead of replacing it
    all_results = sorted(set(result_files) | set(glob.glob(os.path.join(output_root, "*", "results.yaml"))))
    summary = summarise_results(all_results)
    with open(os.path.join(output_root, "summary.yaml"), "w") as f:
        yaml.safe_dump(summary, f)
    print(f"mean position rmse: {summary['mean position rmse']:.4f} m ({summary['completed']} sequences)")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description="Run and analyse a list of datasets (PyTorch / CUDA port)")
    ap.add_argument("datasets")
    ap.add_argument("config")
    ap.add_argument("--output", default="batch_out")
    ap.add_argument("--device", default="cuda", choices=["cpu", "cuda"],
                    help="cuda (the default): float32 filter and the CUDA KLT kernel; cpu: float64")
    ap.add_argument("--noPlots", action="store_true")
    ap.add_argument("--noTiming", action="store_true")
    ap.add_argument("--checkpointEvery", type=int, default=0, dest="checkpoint_every")
    args = ap.parse_args(argv)
    run_batch(args.datasets, args.config, args.output, device=args.device, plots=not args.noPlots,
              timing=not args.noTiming, checkpoint_every=args.checkpoint_every)


if __name__ == "__main__":
    main()
