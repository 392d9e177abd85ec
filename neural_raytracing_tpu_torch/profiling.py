"""Tracing, profiling and numerics-debug utilities.

Counterpart of ``neural_raytracing_tpu/profiling.py``:
  * ``trace(logdir)``: a ``torch.profiler`` session over the block (the host
    and, where there is one, the card), written to ``logdir`` as a Chrome
    trace (open in Perfetto or ``chrome://tracing``);
  * ``annotate(name)``: a ``torch.profiler.record_function`` range, which
    names a phase on the trace's timeline, while a profiler session
    records, and a shared no-op otherwise;
  * ``count(name, n)`` / ``counters()``: work the program counts at its
    layer boundaries (rows, rays, operations, bytes), added up while a
    profiler session records;
  * ``collect()``: the counts a block makes, gathered apart whether or not
    a session records (a CUDA graph's capture, whose replays give them
    back through ``count``);
  * ``Throughput``: a rays/s and step-time meter with moving averages;
  * ``StepTimer``: host-clock time per named phase, synchronising the
    device of the tensors it is given;
  * ``debug_nans(enable)``: autograd's anomaly mode with its NaN check.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block and write ``logdir/trace_<pid>_<ns>.json``.
    Yields the ``torch.profiler.profile``; its ``trace_path`` is set when
    the block ends."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


_NO_SPAN = contextlib.nullcontext()
_COUNTERS: Dict[str, int] = {}
_COLLECTED: Optional[Dict[str, int]] = None   # the open ``collect()`` block's counts


def recording() -> bool:
    """True while a ``torch.profiler`` session records.  Spans and counts
    are made only then, so the program pays a check and no more without
    one."""
    return torch._C._autograd._profiler_enabled()


def annotate(name: str):
    """A named range on the profiler's timeline (a context manager): a
    ``record_function`` range while a session records, which then sits on
    the session's one clock with the device's kernels, else a shared
    no-op context."""
    return torch.profiler.record_function(name) if recording() else _NO_SPAN


def counting() -> bool:
    """True while ``count`` keeps what it is given: a session records, or a
    ``collect()`` block is open.  A count that costs work to work out is
    made only then."""
    return _COLLECTED is not None or recording()


def count(name: str, n: int) -> None:
    """Add ``n`` to the counter ``name`` while a session records, or to the
    open ``collect()`` block's counts, whether or not one records.  ``n`` is
    a number the host holds (a shape, a width), never a tensor's value,
    which would wait for the card."""
    if _COLLECTED is not None:
        _COLLECTED[name] = _COLLECTED.get(name, 0) + n
    elif recording():
        _COUNTERS[name] = _COUNTERS.get(name, 0) + n


@contextlib.contextmanager
def collect():
    """Gather the counts made in the block into a dict of their own (the
    value yielded), whether or not a session records, and keep them out of
    ``counters()``.  A CUDA graph's capture records work that it does not
    do; each replay does it, and gives the capture's counts back through
    ``count``.  Blocks do not nest."""
    global _COLLECTED
    if _COLLECTED is not None:
        raise RuntimeError("profiling.collect() blocks do not nest")
    _COLLECTED = {}
    try:
        yield _COLLECTED
    finally:
        _COLLECTED = None


def counters() -> Dict[str, int]:
    """A copy of the counts made so far."""
    return dict(_COUNTERS)


def reset_counters() -> None:
    _COUNTERS.clear()


def debug_nans(enable: bool = True) -> None:
    """Turn autograd's anomaly mode on or off, with its NaN check.  It
    catches a backward function that returns NaN and names the forward
    operation that made it (with the forward's stack); it does not check
    forward values, nor work done outside autograd (a ``no_grad`` render, a
    kernel's output), where ``jax_debug_nans`` checks every operation's
    output.  It slows every backward."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)


class Throughput:
    """Rays/s and step-time meter with exponential moving averages."""

    def __init__(self, ema: float = 0.9):
        self.ema = ema
        self.rays_per_sec: Optional[float] = None
        self.step_time: Optional[float] = None
        self._last: Optional[float] = None
        self.total_rays = 0
        self.total_time = 0.0

    def step(self, n_rays: int) -> None:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            rps = n_rays / max(dt, 1e-9)
            self.step_time = (dt if self.step_time is None
                              else self.ema * self.step_time + (1 - self.ema) * dt)
            self.rays_per_sec = (rps if self.rays_per_sec is None
                                 else self.ema * self.rays_per_sec + (1 - self.ema) * rps)
            self.total_rays += n_rays
            self.total_time += dt
        self._last = now

    def summary(self) -> Dict[str, float]:
        return {
            "rays_per_sec_ema": self.rays_per_sec or 0.0,
            "step_time_ema": self.step_time or 0.0,
            "rays_per_sec_total": self.total_rays / max(self.total_time, 1e-9),
        }


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


class StepTimer:
    """Accumulates host-clock seconds per named phase."""

    def __init__(self):
        self.times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        """Time the block; with ``block_on`` (tensors, or a tree of them)
        wait first for the devices those on the card live on."""
        t0 = time.perf_counter()
        yield
        if block_on is not None:
            for device in {t.device for t in _tensors(block_on) if t.is_cuda}:
                torch.cuda.synchronize(device)
        self.times[name] = self.times.get(name, 0.0) + (time.perf_counter() - t0)
