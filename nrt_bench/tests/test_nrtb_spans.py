"""The reduction of the program's spans (``nrt_bench.spans``), the readers
of K1's roofline and the host's waits a step, and the program's count of
K1's operations against the yardstick's."""

from __future__ import annotations

import importlib
import json

import pytest
import torch

from conftest import ROOT
from nrt_bench import counts, spans
from nrt_bench.run import reader
from nrt_bench.tracing import Stretch

K1 = "void nrt_mlp_tile_f32_kernel<256, 64, 32>(float const*, float*, int)"
US = 1000


def host(start, end, name, cid=0):
    return (start * US, end * US, name, cid)


def timeline():
    """A step on the main thread: its render launches a kernel from inside
    K1's span, its backward waits while autograd's thread (another thread,
    the same clock) launches two kernels; the device idles between them.
    Times in microseconds."""
    h = [host(0, 100, "nrt.train.step"),
         host(0, 10, "nrt.train.draw"), host(2, 4, "cudaStreamSynchronize"),
         host(10, 40, "nrt.step.render"), host(12, 20, "nrt.k1"),
         host(13, 14, "cudaLaunchKernel", 7),
         host(40, 90, "nrt.step.backward"),
         host(45, 46, "cudaLaunchKernel", 8),       # autograd's thread
         host(70, 71, "cudaLaunchKernel", 9),       # autograd's thread
         host(72, 80, "autograd::engine::evaluate_function: MulBackward0"),
         host(90, 100, "nrt.train.resolve"), host(91, 99, "aten::_local_scalar_dense"),
         host(92, 98, "cudaStreamSynchronize"), host(92, 98, "cudaMemcpy"),
         host(140, 160, "cudaStreamSynchronize")]   # outside every span
    d = [host(14, 30, K1, 7), host(50, 60, "gemm", 8), host(74, 95, "reduce", 9)]
    return h, d


def test_attribution_by_time_across_threads():
    out = spans.reduce_events(*timeline())
    s = out["spans"]
    assert set(s) == {"nrt.train.step", "nrt.train.draw", "nrt.step.render", "nrt.k1",
                      "nrt.step.backward", "nrt.train.resolve"}
    assert s["nrt.k1"]["device_s"] == pytest.approx(16e-6)
    # launched from autograd's thread while the main thread waits in the backward
    assert s["nrt.step.backward"]["device_s"] == pytest.approx(31e-6)
    assert s["nrt.step.render"]["device_s"] == 0.0
    # idle 30-50 (render 30-40, backward 40-50) and 60-74 (backward)
    assert s["nrt.step.render"]["idle_s"] == pytest.approx(10e-6)
    assert s["nrt.step.backward"]["idle_s"] == pytest.approx(24e-6)
    assert s["nrt.train.step"]["idle_s"] == 0.0
    assert s["nrt.train.step"]["host_s"] == pytest.approx(100e-6)
    assert s["nrt.train.step"]["self_s"] == 0.0            # its children cover it
    assert s["nrt.step.render"]["self_s"] == pytest.approx(22e-6)
    assert s["nrt.step.render"]["count"] == 1
    assert out["syncs"] == {"nrt.train.draw": 1, "nrt.train.resolve": 2}
    b = out["breakdown"]
    assert b["spans"][0] == ["nrt.step.backward", pytest.approx(31e-6)]
    assert b["idle_by_span"][:2] == [["nrt.step.backward", pytest.approx(24e-6)],
                                     ["nrt.step.render", pytest.approx(10e-6)]]
    # gaps named by their middle: 40 (no host op) and 67 (no host op, autograd's
    # launch at 70 is a launch call)
    assert [g[0] for g in b["idle_gaps"]] == ["nrt.step.backward", "nrt.step.backward"]


def test_gap_names_carry_span_and_op():
    h, d = timeline()
    h.append(host(30, 50, "aten::empty_strided"))
    d.append(host(200, 210, "late", 0))
    out = spans.reduce_events(h, d)
    names = [g[0] for g in out["breakdown"]["idle_gaps"]]
    # 95-200 has no span at its middle but the sync outside every span
    assert names == ["cudaStreamSynchronize", "nrt.step.backward:aten::empty_strided",
                     "nrt.step.backward"]


def test_no_spans_no_attribution():
    h, d = timeline()
    h = [e for e in h if not e[2].startswith("nrt.")]
    out = spans.reduce_events(h, d)
    assert out["spans"] == {} and out["syncs"] == {}
    assert out["breakdown"]["spans"] == [] and out["breakdown"]["idle_by_span"] == []
    assert [g[0] for g in out["breakdown"]["idle_gaps"]] == [spans.NO_HOST_OP] * 2


def test_cpu_profile_keeps_the_summary_and_adds_spans():
    from neural_raytracing_tpu_torch import profiling
    stretch = Stretch()
    with stretch.record():
        with profiling.annotate("nrt.step.render"):
            with profiling.annotate("nrt.k1"):
                torch.randn(64, 64) @ torch.randn(64, 64)
    summary = stretch.summary()
    assert set(summary) == {"window_s", "busy_s", "kernels", "kernel_counts", "launches",
                            "breakdown"}
    assert summary["busy_s"] == 0 and summary["kernels"] == {}
    out = spans.reduce(stretch.prof)
    assert out["spans"]["nrt.step.render"]["count"] == 1
    assert out["spans"]["nrt.k1"]["host_s"] <= out["spans"]["nrt.step.render"]["host_s"]
    assert out["syncs"] == {}


class _Event:
    def __init__(self, start, end, name, cid, device):
        from torch.autograd import DeviceType
        self._row = (start, end, name, cid)
        self._device = DeviceType.CUDA if device else DeviceType.CPU

    def start_ns(self):
        return self._row[0]

    def duration_ns(self):
        return self._row[1] - self._row[0]

    def name(self):
        return self._row[2]

    def correlation_id(self):
        return self._row[3]

    def device_type(self):
        return self._device

    def is_user_annotation(self):
        return False


class _Profile:
    def __init__(self, h, d):
        events = [_Event(*e, False) for e in h] + [_Event(*e, True) for e in d]
        self.profiler = type("P", (), {"kineto_results": type(
            "R", (), {"events": staticmethod(lambda: events)})})()


def ctx(units=5, kernels=None):
    return {"units": units, "summary": {"kernels": kernels or {}}, "cfg": {}, "work": {},
            "untraced": {"units": 10, "seconds": 1.0}}


def test_readers_read_nothing_without_counters(monkeypatch):
    monkeypatch.setattr(spans, "program_counters", lambda: {})
    monkeypatch.setattr(spans, "traced_profile", lambda: None)
    for name in ("k1_roofline.train", "k1_roofline.render", "syncs_per_step.train"):
        assert reader(name)(ctx(kernels={K1: 1.0})) is None, name
    h, d = timeline()
    no_spans = _Profile([e for e in h if not e[2].startswith("nrt.")], d)
    monkeypatch.setattr(spans, "traced_profile", lambda: no_spans)
    assert reader("syncs_per_step.train")(ctx()) is None


def test_readers_on_synthetic_counts(monkeypatch):
    flops, n_bytes = 67e12 * 2e-3, 1e6
    monkeypatch.setattr(spans, "program_counters",
                        lambda: {"k1.flops": flops, "k1.bytes": n_bytes, "k1.rows": 10})
    kernels = {K1: 3e-3, "void nrt_mlp_tile_pack_kernel(float*)": 5.0,
               "void nrt_fused_mlp_kernel(float const*)": 1e-3}
    for name in ("k1_roofline.train", "k1_roofline.render"):
        assert reader(name)(ctx(kernels=kernels)) == pytest.approx(50.0)
        assert reader(name)(ctx(kernels={})) is None        # no K1 seconds
        assert reader(name)(ctx(units=0, kernels=kernels)) is None
    monkeypatch.setattr(spans, "traced_profile", lambda: _Profile(*timeline()))
    assert reader("syncs_per_step.train")(ctx(units=3)) == pytest.approx(1.0)
    assert reader("syncs_per_step.train")(ctx(units=0)) is None


def test_traced_profile_finds_the_drivers_stretch():
    stretch = Stretch()
    with stretch.record():
        torch.ones(2) + 1
    assert spans.traced_profile() is stretch.prof


def _net_of(cfg: dict, name: str):
    """The configuration's net a module of the program's scene is."""
    if name.endswith("shift"):
        return cfg["surface"]["shift"]
    if name == "bsdf.sp_var_fn":
        return cfg["bsdf"]["weight_net"]
    if name.startswith("bsdf.bsdfs."):
        return cfg["bsdf"]["lobe"]
    if name == "lights.mlp":
        return cfg["light"]["net"]
    if name == "occ":
        return cfg["occlusion_net"]
    raise KeyError(name)


@pytest.mark.parametrize("config", ["flagship", "nerv_gear"])
def test_program_k1_flops_per_row_is_the_yardsticks(config):
    from neural_raytracing_tpu_torch.kernels.fused_mlp import k1_work
    from neural_raytracing_tpu_torch.nn.mlp import SkipConnMLP
    cfg = json.loads((ROOT / f"nrt_bench/configs/{config}.json").read_text())
    module = importlib.import_module(f"neural_raytracing_tpu_torch.{cfg['program']['module']}")
    scene = getattr(module, cfg["program"]["scene"])()
    nets = [(n, m) for n, m in scene.named_modules() if isinstance(m, SkipConnMLP)]
    if config == "nerv_gear":
        scene = scene.replace(occlusion="learned")
        nets = [(n, m) for n, m in scene.named_modules() if isinstance(m, SkipConnMLP)]
        assert any(n == "occ" for n, _ in nets)
    assert len(nets) == cfg["bsdf"]["lobes"] + 2 + (cfg["light"]["kind"] == "light_field") \
        + (config == "nerv_gear")
    for name, net in nets:
        want = _net_of(cfg, name)
        assert k1_work(net, 1)["flops"] == counts.net_ops(want), name
        assert k1_work(net, 0)["bytes"] == counts.weight_bytes(want), name
