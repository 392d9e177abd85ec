"""A cell added as files (a traffic mix, a limits file and an entry in
BENCHMARK.json) in a copy of the benchmark runs with no code edited."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from conftest import ROOT, TINY


def test_added_cell_is_found(tmp_path):
    shutil.copytree(ROOT / "nrt_bench", tmp_path / "nrt_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((ROOT / "nrt_bench/traffic/relight_hard.json").read_text())
    mix.update(TINY["render"], chunk=16, occlusion="none", elev=[20.0, 30.0])
    (tmp_path / "nrt_bench/traffic/relight_plain.json").write_text(json.dumps(mix))
    (tmp_path / "nrt_bench/limits/nerv_gear.relight_plain.json").write_text(
        json.dumps({"limits": {"rel_err": 1e-5}}))
    bench["workloads"].append({"name": "nerv_gear.relight_plain", "config": "nerv_gear",
                               "traffic": "relight_plain", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if "render_rays_per_s" == m["name"]:
            m["workloads"].append("nerv_gear.relight_plain")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    os.symlink(ROOT / "neural_raytracing_tpu_torch", tmp_path / "neural_raytracing_tpu_torch")
    os.symlink(ROOT / "scripts", tmp_path / "scripts")
    code = ("import json, time; from nrt_bench.run import run_cell; "
            "r = run_cell('nerv_gear.relight_plain', 42, 0.0, False, device='cpu', "
            "start=time.perf_counter()); print(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600, env={**os.environ, "PYTHONPATH": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and set(result["metrics"]) == {"render_rays_per_s", "setup_s"}
