"""Shared pieces of the benchmark's own tests, which run on the CPU with the
program's plain paths at a tiny size:

    python -m pytest nrt_bench/tests -q
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a few views of a few pixels; the configurations keep their widths
TINY = {
    "train": {"views": 4, "size": 32, "n_views": 2, "crop": 12, "max_steps": 16,
              "warmup_steps": 3, "block_steps": 1, "trace_steps": 1},
    "render": {"size": 16, "chunk": 8, "max_steps": 24, "warmup_views": 1,
               "trace_at": 1, "trace_views": 1, "check_views": 2},
}
CELLS = ["flagship.train", "nerv_gear.relight_hard", "flagship.view",
         "nerv_gear.relight_learned"]


def tiny(cell: str) -> dict:
    return TINY["train" if cell.endswith(".train") else "render"]


@pytest.fixture
def run_tiny():
    """``run_tiny(cell, seed, trace=False, variant=None)`` -> the result
    object of a tiny CPU run of ``cell``."""
    import time

    from nrt_bench.run import run_cell

    def go(cell, seed=1_234_567_890_123, trace=False, variant=None):
        return run_cell(cell, seed, 0.0, trace, device="cpu", variant=variant,
                        start=time.perf_counter(), mix_changes=tiny(cell))
    return go
