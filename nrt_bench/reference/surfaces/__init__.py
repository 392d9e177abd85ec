"""The surface kinds the benchmark knows, one module each, found by the name
in a configuration's ``surface["kind"]``: ``reference/surfaces/<kind>.py``.

A kind's module provides four names, each computed from the configuration's
``surface`` block (``spec``):

- ``shapes(spec)``: ``{dotted leaf name: shape}`` of its ``shape.*`` leaves;
- ``eval_ops(spec)``: the operations of one SDF evaluation at one point,
  counted as ``nrt_bench.counts`` counts them;
- ``eval_bytes(spec)``: the bytes a march reads once, its weights and
  tables, and not what each ray moves;
- ``Surface(spec, weights)``: the plain float32 SDF over the flat weights,
  whose ``__call__(p [..., 3])`` gives ``[...]``.

Living under ``reference/``, a kind imports nothing of the program.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path


def surface_kind(spec: dict):
    """The module of the surface kind ``spec["kind"]``."""
    name = spec["kind"]
    path = Path(__file__).parent / f"{name}.py"
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", name):
        raise ValueError(f"surface kind {name!r} is not a module name (looked for {path})")
    try:
        return importlib.import_module(f"{__name__}.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"{__name__}.{name}":
            raise
        raise ValueError(f"no surface kind {name!r}: {path} does not exist") from None
