"""The plain reference agrees with the program's plain path (the port on the
CPU runs no kernel) at a tiny size, through the whole harness: the numbers
the output check compares come out at rounding."""

from __future__ import annotations

import json

import pytest
import torch

from conftest import CELLS, ROOT

# float32 rounding of the same operations in another order: on the CPU the
# program's plain path and the reference agree to a few ulps.  The first
# gradient's gaps read at most 3.2e-6 (worst leaf) and 2.8e-7 (median leaf)
# over 13 seeds of the tiny training run: ten times that, far under the
# cell's limits of 8e-2 and 6e-3
AGREE = {"loss_gap_first": 1e-6, "grad_gap_worst": 3e-5, "grad_gap_median": 3e-6,
         "update_gap_median": 1e-5, "rel_err": 1e-5}


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_plain_path(run_tiny, cell):
    result = run_tiny(cell)
    assert result["correct"]
    for name, check in result["checks"].items():
        assert check["value"] <= AGREE[name], (name, check)


def test_reference_surface_matches_program_surface():
    from nrt_bench import program, weights
    from nrt_bench.reference.model import Surface
    cfg = json.loads((ROOT / "nrt_bench/configs/nerv_gear.json").read_text())
    w = weights.make(cfg, 0, "cpu")
    scene = program.build_scene(cfg, w, "cpu")
    p = torch.rand(500, 3, generator=torch.Generator().manual_seed(3)) * 2.0 - 1.0
    with torch.no_grad():
        torch.testing.assert_close(Surface(cfg, w)(p), scene.shape.sdf(p), rtol=1e-5, atol=1e-6)


def test_seeded_weights_follow_the_rules():
    from nrt_bench import weights
    cfg = json.loads((ROOT / "nrt_bench/configs/flagship.json").read_text())
    a, b = weights.make(cfg, 5, "cpu"), weights.make(cfg, 5, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["shape.centers"], weights.make(cfg, 6, "cpu")["shape.centers"])
    assert float(a["shape.centers"].abs().max()) <= 0.15
    assert not a["shape.shift.init.w"].any() and not a["shape.tfs"].any()
    assert float(a["bsdf.bsdfs.0.mlp.init.w"].abs().max()) <= 1 / 131 ** 0.5
    assert not a["bsdf.sp_var_fn.init.b"].any()
    assert 100 < float(a["bsdf.sp_var_fn.B"].std()) < 160
