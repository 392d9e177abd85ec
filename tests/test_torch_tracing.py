"""The port's spans and counters (``profiling.annotate``, ``count``).

Without a profiler session the port enters no ``record_function`` and
counts nothing; under one, a small ``pathtrace`` with ``Direct`` and hard
shadows, one ``build_step_fn`` step and a 2-step ``train`` give their spans,
nested as each layer holds the next, and K1's counters equal a count by hand.
Everything runs on the CPU at a tiny size.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from neural_raytracing_tpu_torch import profiling
from neural_raytracing_tpu_torch.bsdf import Diffuse
from neural_raytracing_tpu_torch.cameras import NeRFCamera, nerf_c2w
from neural_raytracing_tpu_torch.integrators import Direct
from neural_raytracing_tpu_torch.kernels.fused_mlp import FusedSkipConnMLP, k1_work
from neural_raytracing_tpu_torch.lights import PointLights
from neural_raytracing_tpu_torch.nn.mlp import SkipConnMLP
from neural_raytracing_tpu_torch.render import pathtrace
from neural_raytracing_tpu_torch.scene import Scene
from neural_raytracing_tpu_torch.shapes import SDF, SphereSDF
from neural_raytracing_tpu_torch.training import (
    TrainState, build_step_fn, make_optimizer, train,
)

SIZE, CHUNK, CROP = 16, 8, 12
FOCAL = 0.5 * SIZE / np.tan(0.5 * 0.6911)
C2W = np.stack([nerf_c2w(30, 45, 1.2), nerf_c2w(10, 160, 1.2)])[:, :3].astype(np.float32)


def small_scene(occlusion="hard", throughput_steps=8):
    shift = SkipConnMLP(in_size=3, out=1, num_layers=3, hidden_size=8, freqs=2,
                        init="zeros")
    scene = Scene(shape=SDF(SphereSDF(n=4, mlp=shift), max_steps=8,
                            throughput_steps=throughput_steps),
                  bsdf=Diffuse(), lights=PointLights(location=(0.0, 2.0, 1.0)),
                  occlusion=occlusion)
    scene.init(torch.Generator().manual_seed(0), device="cpu")
    with torch.no_grad():
        scene.shape.radii.add_(0.3)
    return scene


def camera(idxs=(0,)):
    return NeRFCamera(torch.from_numpy(C2W[list(idxs)]), FOCAL)


def render(scene):
    return pathtrace(scene, camera(), Direct(training=False), size=SIZE,
                     chunk_size=CHUNK, bundle_size=1, key=3, device="cpu")


def profiled(fn):
    """``fn()`` under a CPU profiler session -> ``[(name, start, end)]`` of
    the ``nrt.`` spans it recorded, and the counts it made."""
    profiling.reset_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events() if e.name().startswith("nrt.")]
    counts = profiling.counters()
    profiling.reset_counters()
    return spans, counts


def names(spans) -> dict:
    out = {}
    for name, _, _ in spans:
        out[name] = out.get(name, 0) + 1
    return out


def assert_nested(spans, child: str, parent: str):
    """Every ``child`` span lies inside some ``parent`` span."""
    parents = [(a, b) for n, a, b in spans if n == parent]
    children = [(a, b) for n, a, b in spans if n == child]
    assert children, child
    for a, b in children:
        assert any(pa <= a and b <= pb for pa, pb in parents), (child, parent)


def step_parts(scene):
    spec = make_optimizer({"shape": 1e-3, "bsdf": 1e-3, "lights": 1e-3})
    state = TrainState(scene, spec.init(scene), 0)
    return spec, state


def test_no_session_no_span_and_no_count(monkeypatch):
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    profiling.reset_counters()
    assert not profiling.recording()
    assert profiling.annotate("nrt.a") is profiling.annotate("nrt.b")
    scene = small_scene()
    render(scene)
    spec, state = step_parts(scene)
    step = build_step_fn(scene, Direct(training=True), spec, size=SIZE, crop_size=CROP)
    exp, mask = torch.rand(1, CROP, CROP, 3), torch.ones(1, CROP, CROP)
    step(state, camera(), (1, 2), exp, mask, torch.Generator().manual_seed(1))
    assert entered == []
    assert profiling.counters() == {}


def test_pathtrace_spans_nest_and_count():
    scene = small_scene(occlusion="hard")
    spans, counts = profiled(lambda: render(scene))
    tiles = (SIZE // CHUNK) ** 2
    got = names(spans)
    assert got["nrt.pathtrace"] == 1 and got["nrt.pathtrace.tile"] == tiles
    for name in ("nrt.direct.intersect", "nrt.direct.emitter", "nrt.direct.shadow",
                 "nrt.direct.bsdf", "nrt.sdf.march", "nrt.sdf.normals", "nrt.sdf.shadow"):
        assert got[name] == tiles, name
    assert "nrt.sdf.scan" not in got                    # no throughput off training
    assert_nested(spans, "nrt.pathtrace.tile", "nrt.pathtrace")
    for name in ("nrt.direct.intersect", "nrt.direct.emitter", "nrt.direct.shadow",
                 "nrt.direct.bsdf"):
        assert_nested(spans, name, "nrt.pathtrace.tile")
    assert_nested(spans, "nrt.sdf.march", "nrt.direct.intersect")
    assert_nested(spans, "nrt.sdf.normals", "nrt.direct.intersect")
    assert_nested(spans, "nrt.sdf.shadow", "nrt.direct.shadow")
    assert counts == {"march.rays": SIZE * SIZE, "shadow.rays": SIZE * SIZE}


def test_step_spans_nest_and_count():
    scene = small_scene(occlusion="none", throughput_steps=8)
    spec, state = step_parts(scene)
    step = build_step_fn(scene, Direct(training=True), spec, size=SIZE, crop_size=CROP)
    exp, mask = torch.rand(2, CROP, CROP, 3), torch.ones(2, CROP, CROP)
    spans, counts = profiled(lambda: step(state, camera((0, 1)), (1, 2), exp, mask,
                                          torch.Generator().manual_seed(1)))
    got = names(spans)
    phases = ["nrt.step.zero_grad", "nrt.step.render", "nrt.step.loss",
              "nrt.step.backward", "nrt.step.optimizer"]
    assert all(got[p] == 1 for p in phases)
    starts = [next(a for n, a, _ in spans if n == p) for p in phases]
    assert starts == sorted(starts)
    assert_nested(spans, "nrt.direct.intersect", "nrt.step.render")
    assert_nested(spans, "nrt.direct.bsdf", "nrt.step.render")
    assert_nested(spans, "nrt.sdf.scan", "nrt.direct.intersect")
    assert "nrt.direct.shadow" not in got and "nrt.pathtrace" not in got
    rays = 2 * CROP * CROP
    assert counts == {"march.rays": rays, "scan.samples": rays * (8 + 1)}


def test_train_spans_nest_and_count():
    scene = small_scene(occlusion="none")
    spec, state = step_parts(scene)
    rng = np.random.default_rng(0)
    imgs = rng.uniform(size=(2, SIZE, SIZE, 3)).astype(np.float32)
    masks = np.ones((2, SIZE, SIZE), np.float32)
    make_camera = lambda idxs: camera(idxs)
    spans, counts = profiled(lambda: train(
        scene, Direct(training=True), spec, state, make_camera, imgs, masks,
        torch.Generator().manual_seed(2), size=SIZE, crop_size=CROP, iters=2,
        n_views=2, log_every=0))
    got = names(spans)
    assert got["nrt.train.upload"] == 1
    assert got["nrt.train.step"] == 2 and got["nrt.train.draw"] == 2
    # a step resolves the loss of the one before; the last is read after the loop
    assert got["nrt.train.resolve"] == 2 and got["nrt.step.backward"] == 2
    assert_nested(spans, "nrt.train.draw", "nrt.train.step")
    for phase in ("nrt.step.render", "nrt.step.loss", "nrt.step.backward",
                  "nrt.step.optimizer"):
        assert_nested(spans, phase, "nrt.train.step")
    step_spans = [(a, b) for n, a, b in spans if n == "nrt.train.step"]
    inside = [any(sa <= a and b <= sb for sa, sb in step_spans)
              for n, a, b in spans if n == "nrt.train.resolve"]
    assert inside == [True, False]
    upload = next((a, b) for n, a, b in spans if n == "nrt.train.upload")
    assert upload[1] <= min(a for a, _ in step_spans)
    assert counts["train.upload_bytes"] == 4 * (imgs.size + masks.size)


def test_k1_counts_by_hand():
    # the bf16 net takes K1's autograd path on the CPU, with the kernel's
    # plain version in its place
    net = FusedSkipConnMLP(in_size=3, out=2, num_layers=3, hidden_size=16, freqs=4,
                           compute_dtype=torch.bfloat16)
    p = torch.rand(5, 7, 3)
    spans, counts = profiled(lambda: net(p))
    assert names(spans) == {"nrt.k1": 1}
    enc = 3 + 2 * 4
    # layer 0 is a skip layer (it takes [h, enc]); layers 1 and 2 are not
    macs = enc * 16 + (16 + enc) * 16 + 16 * 16 + 16 * 16 + 16 * 2
    weights = 3 * 4 + macs + 16 * 4 + 2                  # B, matrices, biases
    rows = 35
    assert counts == {"k1.calls": 1, "k1.rows": rows, "k1.flops": 2 * rows * macs,
                      "k1.bytes": 4 * rows * (3 + 2) + 4 * weights}
    assert k1_work(net, rows) == {"flops": counts["k1.flops"], "bytes": counts["k1.bytes"]}


@pytest.mark.parametrize("rows", [0, 1, 4096])
def test_k1_work_scales_with_rows(rows):
    net = SkipConnMLP(in_size=3, out=1, num_layers=8, hidden_size=128, freqs=32)
    one = k1_work(net, 1)
    work = k1_work(net, rows)
    # the shift net of SphereSDF: 165,504 multiply-adds a row
    assert one["flops"] == 2 * 165_504
    assert work["flops"] == rows * one["flops"]
    assert work["bytes"] - k1_work(net, 0)["bytes"] == 4 * rows * (3 + 1)


def test_collect_gathers_counts_without_a_session():
    profiling.reset_counters()
    assert not profiling.counting()
    with profiling.collect() as counts:
        assert profiling.counting() and not profiling.recording()
        profiling.count("a", 2)
        profiling.count("b", 1)
        profiling.count("a", 3)
        with pytest.raises(RuntimeError, match="do not nest"):
            with profiling.collect():
                pass
        profiling.count("a", 1)       # the open block still collects
    assert counts == {"a": 6, "b": 1}
    assert not profiling.counting() and profiling.counters() == {}
    # K1's counts too, which are worked out only while counted
    net = FusedSkipConnMLP(in_size=3, out=2, num_layers=3, hidden_size=16, freqs=4,
                           compute_dtype=torch.bfloat16)
    with profiling.collect() as k1:
        net(torch.rand(7, 3))
    work = k1_work(net, 7)
    assert k1 == {"k1.calls": 1, "k1.rows": 7, "k1.flops": work["flops"],
                  "k1.bytes": work["bytes"]}
    assert profiling.counters() == {}


def test_collected_counts_come_back_only_while_recording():
    profiling.reset_counters()
    with profiling.collect() as counts:
        profiling.count("k1.flops", 10)
        profiling.count("scan.samples", 4)

    def give_back():
        for name, n in counts.items():
            profiling.count(name, n)

    give_back()
    assert profiling.counters() == {}
    with profile(activities=[ProfilerActivity.CPU]):
        give_back()
        give_back()
        # under a session a collect() block still keeps its counts apart
        with profiling.collect() as apart:
            profiling.count("k1.flops", 1)
        assert profiling.counters() == {"k1.flops": 20, "scan.samples": 8}
    assert apart == {"k1.flops": 1}
    profiling.reset_counters()
