"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload mh03.seq --seed 12345 --seconds 20 --trace 0

From the root of a checkout on a machine with an NVIDIA card.  The cell
names a configuration (``benchmark/configs/<config>.json`` and the YAML it
names) and a traffic mix (``benchmark/traffic/<traffic>.json``, read by the
driver it names, ``benchmark/drivers/<driver>.py``); its comparison limits are
``benchmark/limits/<cell>.json`` and each per-layer metric is read by
``benchmark/metrics/<metric>.py``.  Set-up (the scene from the seed, the
warm-up) counts in ``setup_s``; then the window runs ``--seconds`` and ends
at the first pass or chunk boundary after it.  With ``--trace 1``
a steady stretch after the window is traced and the line carries the
per-layer metrics instead of the end-to-end ones.  Then the reference
checks what the window produced.  The last line of standard output is the
result, the last lines of standard error the numbers compared with their
limits.  Without a card, or with fewer than the cell asks for, it exits 2
and prints no result; with JAX or the JAX package loaded, 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "eqvio_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def by_name(items: list, name: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no entry named {name!r}")


class Cell:
    """A cell and everything it is found by, by name (``limits`` given
    stand for the cell's file: a cell that ``BENCHMARK.json`` does not name
    yet has none)."""

    def __init__(self, workload: str, manifest: dict | None = None, root: str = ROOT, limits: dict | None = None):
        self.manifest = manifest or load_json(os.path.join(root, "BENCHMARK.json"))
        self.cell = by_name(self.manifest["workloads"], workload)
        self.name = workload
        entry = by_name(self.manifest["configs"], self.cell["config"])
        self.cfg = load_json(os.path.join(root, entry["file"]))
        self.mix = load_json(os.path.join(HERE, "traffic", self.cell["traffic"] + ".json"))
        self.limits = limits or load_json(os.path.join(HERE, "limits", workload + ".json"))["limits"]
        import yaml

        with open(os.path.join(os.path.dirname(os.path.join(root, entry["file"])), self.cfg["settings"])) as f:
            self.config = yaml.safe_load(f)

    def metrics(self, kind: str) -> list:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.manifest[kind] if self.name in m.get("workloads", [self.name])]


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def read_metric(name: str, driver):
    """The per-layer metric ``name`` read by ``metrics/<name>.py``; None
    where it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}",
                                                  os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(driver)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda", out_root: str | None = None,
             t_start: float | None = None, driver_hook=None) -> dict:
    """Set up, window, trace and check one run; returns the result line's
    object.  ``driver_hook(driver)`` runs after set-up (tests plant faults
    there)."""
    import torch

    from .compare import judge
    from . import drivers
    from .spans import Spans
    from .tracing import breakdown

    t_start = T_START if t_start is None else t_start
    out_dir = os.path.join(out_root or os.path.join(ROOT, "build", "bench"), cell.name)
    spans = Spans()
    drv = drivers.load(cell.mix["driver"])(cell.cfg, cell.mix, cell.config, seed, device, spans, out_dir)
    drv.setup()
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    if driver_hook is not None:
        driver_hook(drv)
    with spans.span("window"):
        rates = drv.window(seconds)
    leaked = forbidden_modules()
    if leaked:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: {', '.join(leaked)}")
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    metrics, extra = {}, {}
    if trace:
        with spans.span("trace"):
            drv.trace()
        for m in cell.metrics("per_layer"):
            v = read_metric(m["name"], drv)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        if drv.view is not None:
            extra = {"busy_s": drv.view["busy_s"], "window_s": drv.view["window_s"]}
    else:
        values = {**rates, "setup_s": setup_s}
        for m in cell.metrics("end_to_end"):
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    with spans.span("check"):
        numbers = drv.check()
    ok, rows = judge(numbers, cell.limits)
    result = {
        "correct": bool(ok and drv.failed == 0),
        "attempted": int(drv.attempted),
        "failed": int(drv.failed),
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": int(cell.cell["chips"]), "memory_peak_bytes": int(peak), **extra},
    }
    if trace and drv.view is not None:
        result["breakdown"] = breakdown(drv.view, drv.records["host"])
    # a gap that is not finite (nothing comparable, or outputs that are not) prints as null
    result["checks"] = {name: {"value": v if math.isfinite(v) else None, "limit": lim} for name, v, lim in rows}
    result["checks"]["failed_frames"] = {"value": int(drv.failed), "limit": 0}
    spans.write(os.path.join(out_dir, "spans.jsonl"))
    with open(os.path.join(out_dir, "check.json"), "w") as f:
        json.dump({"numbers": numbers, "seed": seed}, f, default=str)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.cell["chips"]:
        print(f"benchmark: the cell needs {cell.cell['chips']} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    # the program's kernel caches live in the checkout, at fixed paths
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    try:
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    except SystemExit as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
