"""The traced stretch: one torch.profiler session (host and device), kept in
memory and reduced to what the per-layer metrics read.

``summary`` gives the stretch's wall seconds, the seconds in which some
operation ran on the device (the union of the device's intervals), the
device seconds and count of each kernel by name, the host's kernel launch
calls, and the ``breakdown``: the device operations that took the most time
and the longest idle gaps on the device, each named by the innermost host
operation running at the gap's middle.
"""

from __future__ import annotations

import contextlib
import time

import torch

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx", "cudaGraphLaunch")


class Stretch:
    """``with stretch.record(): ...`` profiles the block; ``summary()``
    reduces it afterwards (the block ends in a synchronise)."""

    def __init__(self):
        self.prof = None
        self.wall_s = 0.0

    @contextlib.contextmanager
    def record(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            start = time.perf_counter()
            yield
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self.wall_s = time.perf_counter() - start
        self.prof = prof

    def summary(self, top: int = 10) -> dict:
        from torch.autograd import DeviceType
        device, host = [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.duration_ns() <= 0 and e.device_type() != DeviceType.CPU:
                continue
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation():
                    continue
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
            elif e.device_type() == DeviceType.CPU:
                host.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        device.sort()
        kernels, counts = {}, {}
        busy_ns, merged = 0, []
        for start, end, name in device:
            kernels[name] = kernels.get(name, 0.0) + 1e-9 * (end - start)
            counts[name] = counts.get(name, 0) + 1
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        busy_ns = sum(end - start for start, end in merged)
        launches = sum(1 for _, _, name in host if name.startswith(LAUNCH_CALLS))
        gaps = sorted(((merged[i + 1][0] - merged[i][1], merged[i][1], merged[i + 1][0])
                       for i in range(len(merged) - 1)), reverse=True)[:top]
        idle = []
        for length, a, b in gaps:
            mid = (a + b) // 2
            inside = [(end - start, name) for start, end, name in host
                      if start <= mid <= end and not name.startswith(LAUNCH_CALLS)]
            idle.append([min(inside)[1] if inside else "(no host operation)", 1e-9 * length])
        ranked = sorted(kernels.items(), key=lambda kv: -kv[1])[:top]
        return {
            "window_s": self.wall_s,
            "busy_s": 1e-9 * busy_ns,
            "kernels": kernels,
            "kernel_counts": counts,
            "launches": launches or sum(counts.values()),
            "breakdown": {"device_ops": [[k, v] for k, v in ranked], "idle_gaps": idle},
        }


def seconds_of(summary: dict, prefix: str) -> float:
    """Device seconds of the kernels whose name holds ``prefix``."""
    return sum(v for k, v in summary["kernels"].items() if prefix in k)


def idle_share(ctx: dict):
    """``100 x`` the share of an untraced step (or view) in which nothing ran
    on the device: one minus the device's busy seconds a traced unit over
    the wall seconds an untraced unit of the same window took; None where
    the trace saw no device time."""
    busy, untraced = ctx["summary"]["busy_s"], ctx["untraced"]
    if not busy or not ctx["units"] or not untraced["units"]:
        return None
    return 100.0 * (1.0 - (busy / ctx["units"]) / (untraced["seconds"] / untraced["units"]))


def mfu(ctx: dict, ops: float):
    """``100 x`` the operations the untraced units of the window needed
    (``ops`` over the traced units, scaled to the untraced ones) over their
    seconds and the float32 peak; None where no device ran."""
    from .counts import share
    untraced = ctx["untraced"]
    if not ctx["summary"]["busy_s"] or not ctx["units"] or not untraced["units"]:
        return None
    return share(ops / ctx["units"] * untraced["units"], untraced["seconds"])
