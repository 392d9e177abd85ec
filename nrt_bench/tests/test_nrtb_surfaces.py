"""Surface kinds: the ``spheres`` kind holds the numbers the harness read
before surfaces had a module each, and a new kind needs one new module and
nothing else."""

from __future__ import annotations

import copy
import hashlib
import json
import sys
import types

import pytest
import torch

from conftest import ROOT
from nrt_bench import counts, weights
from nrt_bench.reference.model import Net, Scene, Surface

# Frozen from the harness of commit af0f213, before the surface kinds moved
# into reference/surfaces/ (weights.shapes, counts.sdf_ops, counts.march_bytes
# and reference.model.Surface written for spheres alone), by these helpers on
# an x86-64 CPU with torch 2.13.0.  The weights come from the CPU generator;
# the SDF's exp and log are the CPU build's, so another torch build may have
# to freeze SDF_500 again from that commit.
SHAPE_LEAVES = {"shape.centers": (128, 3), "shape.radii": (128,), "shape.tfs": (128, 3, 3)}
LEAVES = {"flagship": (223, "a8c40e533ed4f945093c8903c123116f18f5d334ab886d80f9666e346a427a3e"),
          "nerv_gear": (207, "b9986768077b252982c243c6ad194e73bb93bfaaf9653515d3f69ad89e9afb67")}
SDF_OPS = 334_976                                   # 2 x 165,504 + 31 x 128
MARCH_BYTES_38400 = {1: 1_748_868, 2: 1_902_468}    # outputs 1 (K3, K4) and 2 (K2)
TRAIN_STEP_OPS = 2_791_486_259_200                  # flagship, (38,400, 20,000, 2e6, 4,953,600)
VIEW_OPS = 868_321_920_000                          # nerv_gear, (20,000, 2e6, 300,000, 5,000)
WEIGHTS_SEED_0 = "50fc33deb66781b04a67a0180cc061aa979e4bcd128669c26d8a04b31d7b7d56"
SDF_500 = {"flagship": "ebf5fa0dd35f85175c51fe0d8be72a85244bee791ad21b070f2b99295942b595",
           "nerv_gear": "a3810539edd088631edb68d9d91e4e571886f23248c9e83f1ed756630939997e"}


def cfg(name: str) -> dict:
    return json.loads((ROOT / f"nrt_bench/configs/{name}.json").read_text())


def leaves_digest(shapes: dict) -> str:
    return hashlib.sha256(json.dumps(sorted((k, list(v)) for k, v in shapes.items()))
                          .encode()).hexdigest()


def tensors_digest(tensors: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(tensors):
        h.update(k.encode())
        h.update(tensors[k].detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def points() -> torch.Tensor:
    return torch.rand(500, 3, generator=torch.Generator().manual_seed(3)) * 2.0 - 1.0


@pytest.mark.parametrize("config", ["flagship", "nerv_gear"])
def test_sphere_leaves_are_unchanged(config):
    shapes = weights.shapes(cfg(config))
    assert {k: v for k, v in shapes.items() if k.startswith("shape.")
            and not k.startswith("shape.shift.")} == SHAPE_LEAVES
    assert (len(shapes), leaves_digest(shapes)) == LEAVES[config]


def test_sphere_counts_are_unchanged():
    f, n = cfg("flagship"), cfg("nerv_gear")
    assert counts.sdf_ops(f) == counts.sdf_ops(n) == SDF_OPS
    for outputs, want in MARCH_BYTES_38400.items():
        assert counts.march_bytes(f, 38_400, outputs) == want
    assert counts.train_step_ops(f, 38_400, 20_000, 2_000_000, 4_953_600) == TRAIN_STEP_OPS
    assert counts.view_ops(n, 20_000, 2_000_000, 300_000, 5_000) == VIEW_OPS


def test_seeded_sphere_weights_are_unchanged():
    assert tensors_digest(weights.make(cfg("flagship"), 0, "cpu")) == WEIGHTS_SEED_0


@pytest.mark.parametrize("config", ["flagship", "nerv_gear"])
def test_sphere_reference_sdf_is_unchanged(config):
    c = cfg(config)
    with torch.no_grad():
        got = Surface(c, weights.make(c, 0, "cpu"))(points())
    assert tensors_digest({"sdf": got}) == SDF_500[config]


# ---- a new kind ------------------------------------------------------------------

class _Ball:
    """``|p| - radius`` plus a shift net: a kind with a leaf of its own."""

    def __init__(self, spec, w):
        self.w = w
        self.shift = Net(spec["shift"], w, "shape.shift.")

    def __call__(self, p):
        return torch.linalg.norm(p, dim=-1) - self.w["shape.radius"] + self.shift(p)[..., 0]


def _ball_module():
    ball = types.ModuleType("nrt_bench.reference.surfaces.ball")
    ball.shapes = lambda spec: {"shape.radius": (1,),
                                **weights.net_shapes("shape.shift.", spec["shift"])}
    ball.eval_ops = lambda spec: counts.net_ops(spec["shift"]) + 6
    ball.eval_bytes = lambda spec: counts.weight_bytes(spec["shift"]) + 4
    ball.Surface = _Ball
    return ball


def _ball_config() -> dict:
    c = copy.deepcopy(cfg("flagship"))
    c["surface"] = {"kind": "ball", "shift": {
        "in_size": 3, "out": 1, "num_layers": 2, "hidden_size": 16, "skip": 3, "freqs": 4,
        "sigma": 1.0, "activation": "softplus"}}
    c["weights"]["init"].insert(0, ["shape.radius", "uniform", 0.5, 0.5])
    c["bsdf"]["lobes"] = 2
    return c


def test_a_new_kind_needs_only_its_module(monkeypatch):
    monkeypatch.setitem(sys.modules, "nrt_bench.reference.surfaces.ball", _ball_module())
    c = _ball_config()
    w = weights.from_seed(c, 11, "cpu")
    assert w["shape.radius"].tolist() == [0.5]
    assert "shape.centers" not in w and "shape.shift.out.w" in w
    f = counts.net_ops(c["surface"]["shift"]) + 6
    assert counts.sdf_ops(c) == f
    assert counts.march_bytes(c, 10, 1) == 4 * 10 * 7 + counts.weight_bytes(
        c["surface"]["shift"]) + 4
    assert counts.train_step_ops(c, 10, 4, 100, 1290) == 100 * f + 1290 * f + 3 * (
        10 * 3 * f + 4 * counts.shading_ops(c))
    scene = Scene(c, w, {"max_steps": 32})
    p = points()
    with torch.no_grad():
        # the shift net starts at zero, so the SDF is the ball's own
        assert torch.equal(scene.sdf(p), torch.linalg.norm(p, dim=-1) - 0.5)
    # rays from (0, 0, 2): towards the ball, and away from it
    r_d = torch.tensor([[0.0, 0.0, -1.0], [0.05, 0.0, -1.0], [0.0, 0.0, 1.0]])
    rays = torch.cat([torch.tensor([0.0, 0.0, 2.0]).expand(3, 3),
                      r_d / r_d.norm(dim=-1, keepdim=True)], dim=-1)
    rgb, hit, it, _ = scene.direct(rays, primary=True)
    assert hit.tolist() == [True, True, False]
    assert float(it["p"][0, 2].detach()) == pytest.approx(0.5, abs=1e-2)
    assert torch.isfinite(rgb).all() and torch.isfinite(it["throughput"]).all()


@pytest.mark.parametrize("kind", ["nosuch", "spheres.x"])
@pytest.mark.parametrize("call", ["shapes", "sdf_ops", "march_bytes", "Surface"])
def test_an_unknown_kind_names_the_file(kind, call):
    c = copy.deepcopy(cfg("flagship"))
    c["surface"]["kind"] = kind
    run = {"shapes": lambda: weights.shapes(c), "sdf_ops": lambda: counts.sdf_ops(c),
           "march_bytes": lambda: counts.march_bytes(c, 1), "Surface": lambda: Surface(c, {})}
    with pytest.raises(ValueError, match=f"nrt_bench/reference/surfaces/{kind}.py"):
        run[call]()
