"""The program's own spans and counters in a traced stretch.

The program names its layers with ``nrt.`` spans (``profiling.annotate``:
``record_function`` ranges on the profiler's one clock with the device's
kernels) and counts its work at the same boundaries (``profiling.count``),
both only while a profiler session records.  ``reduce`` attributes the
stretch to those spans:

- a kernel (or copy) belongs to the innermost span that holds its launch
  call, found by its correlation id;
- each idle nanosecond of the device, between its busy intervals, goes to
  the innermost span open on the host at that time;
- a host call that blocks on the device (``SYNC_CALLS``) counts for the
  innermost span it was made in.

Containment is by time, across threads: autograd launches the backward from
its own thread while the main thread waits inside ``nrt.step.backward``.

Run on a card, ``python3 -m nrt_bench.spans --workload <cell> --seed <n>
--seconds <s>`` runs a cell's window with its traced stretch and prints one
JSON object: the spans, the host waits by span, the counters, the idle gaps
named by span, and the traced stretch's wall seconds a unit.
"""

from __future__ import annotations

import bisect

SPAN_PREFIX = "nrt."
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
              "cudaMemcpy")
# K1, the shading nets' kernel, on each of its routes (not its weight packs)
K1_KERNELS = ("nrt_mlp_tile_f32", "nrt_mlp_tile_bf16", "nrt_fused_mlp_kernel")
NO_HOST_OP = "(no host operation)"


def program_counters() -> dict:
    """The program's counts made while a profiler session recorded; empty
    where the program keeps none."""
    try:
        from neural_raytracing_tpu_torch.profiling import counters
    except ImportError:
        return {}
    return counters()


def traced_profile():
    """The ``torch.profiler`` session of the traced stretch that the cell's
    driver holds (the readers' context carries the stretch's summary, not
    its events), or None."""
    import gc

    from .tracing import Stretch
    gc.collect()                # drop the stretches of drivers already gone
    for obj in gc.get_objects():
        if type(obj) is Stretch and obj.prof is not None:
            return obj.prof
    return None


def syncs_per_unit(ctx: dict):
    """The host's blocking calls inside the program's spans in the traced
    stretch, over its units; None where the stretch holds no span."""
    prof = traced_profile()
    if prof is None or not ctx["units"]:
        return None
    out = reduce(prof)
    if not out["spans"]:
        return None
    return sum(out["syncs"].values()) / ctx["units"]


def k1_roofline(ctx: dict):
    """``100 x`` the least time of the rows the program handed K1 in the
    traced stretch (``k1.flops``, ``k1.bytes``) over K1's device seconds
    there; None without either."""
    from .counts import share
    from .tracing import seconds_of
    c = program_counters()
    if not ctx["units"] or not c.get("k1.flops"):
        return None
    seconds = sum(seconds_of(ctx["summary"], k) for k in K1_KERNELS)
    return share(c["k1.flops"], seconds, c.get("k1.bytes", 0))


class _Timeline:
    """The innermost span open at each time, across threads: the spans'
    starts and ends cut the time into segments, each held by the shortest
    span open over it (None where no span is open)."""

    def __init__(self, spans):
        opens, closes = {}, {}
        for i, (_, start, end) in enumerate(spans):
            if end > start:
                opens.setdefault(start, []).append(i)
                closes.setdefault(end, []).append(i)
        self.starts, self.owner = sorted(opens.keys() | closes.keys()), []
        active = set()
        for t in self.starts:
            active.difference_update(closes.get(t, ()))
            active.update(opens.get(t, ()))
            self.owner.append(min(active, key=lambda i: spans[i][2] - spans[i][1])
                              if active else None)

    def at(self, t):
        k = bisect.bisect_right(self.starts, t) - 1
        return self.owner[k] if k >= 0 else None

    def split(self, a, b):
        """``[(span index or None, ns)]`` covering ``[a, b)``."""
        out = []
        k = bisect.bisect_right(self.starts, a) - 1
        while a < b:
            hi = min(b, self.starts[k + 1]) if k + 1 < len(self.starts) else b
            out.append((self.owner[k] if k >= 0 else None, hi - a))
            a, k = hi, k + 1
        return out


def reduce_events(host, device, top: int = 10) -> dict:
    """``host``: ``(start_ns, end_ns, name, correlation_id)`` of the host's
    events; ``device``: the same of the device's kernels and copies.
    Returns ``spans`` (by name: ``count``, ``host_s``, ``self_s``,
    ``device_s``, ``idle_s``), ``syncs`` (by span name) and ``breakdown``
    (``spans`` and ``idle_by_span`` as ``[[name, seconds]]`` of the ``top``
    spans, and ``idle_gaps``, the ``top`` longest gaps named
    ``<span>:<host op>``)."""
    from .tracing import LAUNCH_CALLS
    spans = [(name, start, end) for start, end, name, _ in host
             if name.startswith(SPAN_PREFIX)]
    line = _Timeline(spans)
    stats = {}

    def entry(i):
        name = spans[i][0]
        if name not in stats:
            stats[name] = {"count": 0, "host_s": 0.0, "self_s": 0.0, "device_s": 0.0,
                           "idle_s": 0.0}
        return stats[name]

    for i, (_, start, end) in enumerate(spans):
        e = entry(i)
        e["count"] += 1
        e["host_s"] += 1e-9 * (end - start)
    for k, owner in enumerate(line.owner[:-1]):
        if owner is not None:
            entry(owner)["self_s"] += 1e-9 * (line.starts[k + 1] - line.starts[k])
    # a kernel's launch call: the runtime call (cu*) of the same correlation id
    calls = {cid: start for start, _, name, cid in host if name.startswith("cu") and cid}
    for start, end, _, cid in device:
        owner = line.at(calls[cid]) if cid in calls else None
        if owner is not None:
            entry(owner)["device_s"] += 1e-9 * (end - start)
    merged = []
    for start, end, _, _ in sorted(device):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    for a, b in gaps:
        for owner, ns in line.split(a, b):
            if owner is not None:
                entry(owner)["idle_s"] += 1e-9 * ns
    syncs = {}
    for start, _, name, _ in host:
        if name in SYNC_CALLS:
            owner = line.at(start)
            if owner is not None:
                syncs[spans[owner][0]] = syncs.get(spans[owner][0], 0) + 1
    ops = [(start, end, name) for start, end, name, _ in host
           if not name.startswith(SPAN_PREFIX) and not name.startswith(LAUNCH_CALLS)]
    named = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = (a + b) // 2
        inside = [(end - start, name) for start, end, name in ops if start <= mid <= end]
        op = min(inside)[1] if inside else None
        owner = line.at(mid)
        span = spans[owner][0] if owner is not None else None
        label = f"{span}:{op}" if span and op else (span or op or NO_HOST_OP)
        named.append([label, 1e-9 * (b - a)])
    ranked = lambda key: [[k, v[key]] for k, v in
                          sorted(stats.items(), key=lambda kv: -kv[1][key])[:top]]
    return {"spans": stats, "syncs": syncs,
            "breakdown": {"spans": ranked("device_s"), "idle_by_span": ranked("idle_s"),
                          "idle_gaps": named}}


def reduce(prof, top: int = 10) -> dict:
    """``reduce_events`` of a ``torch.profiler`` session's events."""
    from torch.autograd import DeviceType
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        row = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.correlation_id())
        if e.device_type() == DeviceType.CPU:
            host.append(row)
        elif e.device_type() == DeviceType.CUDA and e.duration_ns() > 0 \
                and not e.is_user_annotation():
            device.append(row)
    return reduce_events(host, device, top)


def report(name: str, seed: int, seconds: float, device="cuda",
           mix_changes: dict | None = None) -> dict:
    """Set-up and the window of cell ``name`` with its traced stretch ->
    the stretch's spans, host waits and counters; its wall seconds a traced
    unit (the profiler's start and stop left out) and, for views, each
    traced view's milliseconds; and the untraced units' wall seconds a
    unit."""
    import importlib
    import json
    import time

    from . import run
    bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
    cell = run.cell_spec(name, bench)
    cfg, mix = run.load("configs", cell["config"]), run.load("traffic", cell["traffic"])
    mix.update(mix_changes or {})
    driver = importlib.import_module(f"nrt_bench.drivers.{mix['driver']}").Driver(
        cfg, mix, seed, device)
    driver.setup()
    if program_counters():
        from neural_raytracing_tpu_torch.profiling import reset_counters
        reset_counters()
    t = time.perf_counter()
    driver.window(seconds, True)
    window_s = time.perf_counter() - t
    units = len(driver.traced)
    summary = driver.stretch.summary()
    out = reduce(driver.stretch.prof)
    views = getattr(driver, "view_ms", None)
    return {"cell": name, "seed": seed, "units": units,
            "traced_s_per_unit": summary["window_s"] / units,
            "untraced_s_per_unit": (window_s - driver.trace_wall) / max(driver.attempted - units, 1),
            "busy_s": summary["busy_s"], "counters": program_counters(),
            "traced_view_ms": [views[i] for i in driver.traced] if views else None,
            "syncs": out["syncs"],
            "spans": out["spans"], "breakdown": out["breakdown"]}


def main(argv=None) -> int:
    import argparse
    import json
    ap = argparse.ArgumentParser(description="The span report of a cell's traced stretch.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    print(json.dumps(report(args.workload, args.seed, args.seconds)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
