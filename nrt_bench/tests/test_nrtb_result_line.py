"""The result line's keys, the exit without a card, and the per-layer
metrics a traced run reports."""

from __future__ import annotations

import json

import pytest

from conftest import CELLS, ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(run_tiny, trace):
    result = run_tiny("nerv_gear.relight_hard", trace=trace)
    want = KEYS[:5] + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == want
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(result)


@pytest.mark.parametrize("cell", CELLS)
def test_untraced_metrics_are_the_cells_end_to_end(run_tiny, cell):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}
    got = run_tiny(cell)["metrics"]
    assert set(got) == want
    assert all(v["value"] > 0 for v in got.values())


def test_no_card_no_result(monkeypatch, capsys):
    import torch

    from nrt_bench import run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "flagship.view", "--seed", "3", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == "" and "CUDA" in out.err


def test_every_cell_has_its_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell in bench["workloads"]:
        for path in (f"configs/{cell['config']}.json", f"traffic/{cell['traffic']}.json",
                     f"limits/{cell['name']}.json"):
            assert (ROOT / "nrt_bench" / path).is_file(), path
    for m in bench["per_layer"]:
        assert (ROOT / "nrt_bench" / "metrics" / f"{m['name']}.py").is_file()
