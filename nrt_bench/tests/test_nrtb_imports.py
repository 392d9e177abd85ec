"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program.  Module names are compared by
their top-level name as a whole: the port's name begins with the JAX
package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

from conftest import ROOT, TINY

FORBIDDEN = {"jax", "jaxlib", "flax", "neural_raytracing_tpu"}
PROGRAM = "neural_raytracing_tpu_torch"


def top_level_imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and "." in node.value and " " not in node.value:
            # a dotted module path handed to importlib
            names.add(node.value.split(".")[0])
    return names


def test_no_module_names_jax_or_the_jax_package():
    for path in (ROOT / "nrt_bench").rglob("*.py"):
        assert not top_level_imports(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "nrt_bench" / "reference").rglob("*.py"):
        assert PROGRAM not in top_level_imports(path), path


def test_a_run_loads_no_jax():
    code = ("import json, sys, time; from nrt_bench.run import run_cell, forbidden_modules; "
            f"run_cell('nerv_gear.relight_hard', 9, 0.0, True, device='cpu', "
            f"start=time.perf_counter(), mix_changes={json.dumps(TINY['render'])}); "
            "print(json.dumps(forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
