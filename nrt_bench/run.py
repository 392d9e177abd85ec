"""Runs one cell of the benchmark and prints its result line.

    python3 -m nrt_bench.run --workload flagship.train --seed 7 --seconds 30 --trace 0

The cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration is ``nrt_bench/configs/<config>.json``, its traffic mix
``nrt_bench/traffic/<traffic>.json`` (which names its driver,
``nrt_bench/drivers/<driver>.py``), the limits of its output check
``nrt_bench/limits/<cell>.json``, and each per-layer metric a reader
``nrt_bench/metrics/<metric>.py``.  With ``--trace 0`` the line carries the
cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics.  The
last line of standard output is one JSON object; the numbers compared are
the last lines of standard error and the last key of that object.
"""

from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "neural_raytracing_tpu")


def load(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def cell_spec(name: str, bench: dict) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"nrt_bench: no workload {name!r} in BENCHMARK.json")


def metrics_for(cell: str, entries: list) -> list:
    return [m for m in entries if "workloads" not in m or cell in m["workloads"]]


def per_layer_for(cell: str, bench: dict) -> list:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in metrics_for(cell, bench["end_to_end"])}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m else m["moves"] in e2e)]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(f"nrt_bench_metric_{name}",
                                                  BENCH / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             variant=None, bench: dict | None = None, start: float | None = None,
             mix_changes: dict | None = None, all_numbers: bool = False) -> dict:
    """Set-up, the window, the output check and, traced, the per-layer
    metrics of cell ``name`` -> the result object (``checks`` last).
    ``variant`` plants a fault or the lower-precision control, and
    ``mix_changes`` shrinks the mix, for the tests and the calibration
    only; ``all_numbers`` adds every number the check worked out, limited
    or not, under ``numbers``, for the calibration."""
    import torch
    start = PROCESS_START if start is None else start
    bench = bench or json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = cell_spec(name, bench)
    cfg, mix = load("configs", cell["config"]), load("traffic", cell["traffic"])
    mix.update(mix_changes or {})
    limits = load("limits", name)
    module = importlib.import_module(f"nrt_bench.drivers.{mix['driver']}")
    driver = module.Driver(cfg, mix, seed, device, variant=variant)
    driver.setup()
    setup_s = time.perf_counter() - start
    measured = driver.window(seconds, trace)
    cuda = torch.device(device).type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    driver.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers = driver.check()
    checks = {k: {"value": numbers[k], "limit": limit} for k, limit in limits["limits"].items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    measured["setup_s"] = setup_s
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics, extra = {}, {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    if trace:
        ctx = driver.trace_context()
        ctx["cell"] = name
        for m in per_layer_for(name, bench):
            value = reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
        device_info.update(busy_s=ctx["summary"]["busy_s"], window_s=ctx["summary"]["window_s"])
        extra["breakdown"] = ctx["summary"]["breakdown"]
    else:
        for m in metrics_for(name, bench["end_to_end"]):
            metrics[m["name"]] = {"value": measured[m["name"]], "unit": m["unit"]}
    if all_numbers:
        extra["numbers"] = numbers
    return {"correct": correct, "attempted": driver.attempted, "failed": 0, "metrics": metrics,
            "device": device_info, **extra, "checks": checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    chips = cell_spec(args.workload, bench)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"nrt_bench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"nrt_bench: the process loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
