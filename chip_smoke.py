"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases, each of which fails loudly (a non-zero exit and no result line):
  1. the card's name and power limit; build the CUDA kernels from
     neural_raytracing_tpu_torch/csrc (nvcc, sm_90a) and print the build time;
  2. K1 fused_mlp_forward against its plain version on each of the four
     flagship nets at full width, 65,536 seeded points each;
  3. K2 fused_march against its plain version on a 256x256 NeRFCamera view
     (65,536 rays) through the full 128-sphere set with a non-zero 8x128
     shift: bounded (256 steps, march_bound 1.2) and unbounded (64 steps);
  4. the slice: the flagship eval scene of scripts/nerf_synthetic.py
     (max_steps 256, march_bound 1.2) renders 3 views at 256x256 through
     pathtrace with the kernels, launch counts reset just before and read
     just after, then again with every kernel switched off; one validation
     view (64 steps, unbounded) the same way.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.

Tolerances: K1 |kernel - plain| <= 1e-4 |plain| + 1e-5 + 4e-7 max|x.B| (the
float32 rounding of the Fourier argument x.B, amplified by the net); K2 hit
agreement >= 99% and |depth difference| <= 1e-3 where both hit (float32
sums in another order, accumulated over up to 256 steps); the slice's
images finite, hit fraction > 0, mask agreement >= 99% and mean |difference|
<= 1e-3 between the kernel and plain renders.

Needs torch with CUDA and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s and the
# float32 rate outside the tensor cores, at the full 700 W power limit
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
N_POINTS = 65_536
SIZE = 256
CHUNK = 128
FOCAL = 0.5 * SIZE / math.tan(0.5 * 0.6911)


def fail(msg: str):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg: str):
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def bound_ms(n_bytes: float, flops: float):
    """-> (least milliseconds on the card, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, flops / PEAK_F32
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def mlp_macs(mlp) -> int:
    """Multiply-adds of the net's linear layers for one point."""
    return sum(w.shape[0] * w.shape[1] for w in mlp.flat_weights()[0::2])


def weight_bytes(mlp) -> int:
    return 4 * (mlp.B.numel() + sum(w.numel() for w in mlp.flat_weights()))


def flagship_nets():
    from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP
    # the flagship configurations; the shift net gets a uniform (non-zero)
    # init here so the comparison exercises its weights
    return {
        "sdf_shift 8x128 F32": FusedSkipConnMLP(
            in_size=3, out=1, num_layers=8, hidden_size=128, freqs=32,
            activation="softplus", init="uniform"),
        "weight_net 16x256 F128": FusedSkipConnMLP(
            in_size=3, out=8, num_layers=16, hidden_size=256, freqs=128,
            sigma=128.0, init="xavier"),
        "lobe 6x96 F64": FusedSkipConnMLP(
            in_size=3, out=3, num_layers=6, hidden_size=96, freqs=64),
        "light_field 10x256 F16": FusedSkipConnMLP(
            in_size=3, out=3, num_layers=10, hidden_size=256),
    }


def phase_mlp(torch, dev):
    from neural_raytracing_tpu_torch.kernels import fused_mlp_forward
    from neural_raytracing_tpu_torch.nn import SkipConnMLP

    gen = torch.Generator().manual_seed(1)
    totals = dict(ms=0.0, plain_ms=0.0, bytes=0.0, flops=0.0, err=0.0)
    for name, mlp in flagship_nets().items():
        mlp.reset_parameters(gen)
        mlp.to(dev)
        x = (torch.rand(N_POINTS, 3, generator=gen) - 0.5).to(dev)
        weights = [w.detach() for w in mlp.flat_weights()]
        with torch.no_grad():
            got = fused_mlp_forward(mlp, x, mlp.B, weights)
            want = SkipConnMLP.forward(mlp, x)
            torch.cuda.synchronize()
            err = (got - want).abs()
            arg = (x @ mlp.B).abs().max().item()
            tol = 1e-4 * want.abs() + 1e-5 + 4e-7 * arg
            check(torch.isfinite(got).all().item(), f"K1 {name}: non-finite output")
            check(bool((err <= tol).all()),
                  f"K1 {name}: max |err| {err.max().item():.3e} over tolerance")
            ms = cuda_ms(lambda: fused_mlp_forward(mlp, x, mlp.B, weights), 5)
            plain_ms = cuda_ms(lambda: SkipConnMLP.forward(mlp, x), 5)
        flops = 2.0 * mlp_macs(mlp) * N_POINTS
        n_bytes = 4 * N_POINTS * (mlp.in_size + mlp.out_size) + weight_bytes(mlp)
        b_ms, b_by = bound_ms(n_bytes, flops)
        max_err = err.max().item()
        rel = max_err / max(want.abs().max().item(), 1e-30)
        print(f"K1 {name}: {N_POINTS} points, max |err| {max_err:.3e} "
              f"(rel {rel:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), {flops / ms / 1e9:.1f} TFLOP/s")
        totals["ms"] += ms
        totals["plain_ms"] += plain_ms
        totals["bytes"] += n_bytes
        totals["flops"] += flops
        totals["err"] = max(totals["err"], max_err)
    totals["bound_ms"], totals["bound_by"] = bound_ms(totals["bytes"], totals["flops"])
    return totals


def view_rays(torch, dev, elev=30.0, azim=45.0):
    """The 65,536 rays of one 256x256 NeRFCamera view, flattened."""
    from neural_raytracing_tpu_torch.cameras import NeRFCamera, nerf_c2w
    from neural_raytracing_tpu_torch.render import _tile_positions
    c2w = torch.from_numpy(nerf_c2w(elev, azim, 2.0)[None, :3]).to(dev)
    rays = NeRFCamera(c2w, FOCAL).sample_positions(
        _tile_positions(0.0, 0.0, SIZE, dev), size=SIZE)
    return rays.reshape(-1, 6).contiguous()


def phase_march(torch, dev):
    from neural_raytracing_tpu_torch.kernels import (
        fused_march, march_plain, set_kernel_mode,
    )
    from neural_raytracing_tpu_torch.shapes import SphereSDF, march_interval

    gen = torch.Generator().manual_seed(2)
    nets = flagship_nets()
    module = SphereSDF(n=128, k=32.0, mlp=nets["sdf_shift 8x128 F32"])
    module.reset_parameters(gen)
    with torch.no_grad():
        # a non-zero, moderate shift and spheres large enough to cover part
        # of the view
        module.shift.out.w.mul_(0.1)
        module.shift.out.b.mul_(0.1)
        module.radii.copy_(0.3 + 0.5 * module.radii)
    module.to(dev)
    rays = view_rays(torch, dev)
    r_o, r_d = rays[:, :3].contiguous(), rays[:, 3:].contiguous()
    set_kernel_mode(module, "off")   # the plain march evaluates the plain shift
    per_eval_flops = 2.0 * mlp_macs(module.shift) + 31.0 * module.n
    results = {}
    for label, steps, bound in (("bounded", 256, 1.2), ("unbounded", 64, None)):
        if bound is None:
            t0, t1 = None, 10.0
        else:
            t0, t1 = march_interval(r_o, r_d, bound, 10.0)
        kernel = lambda: fused_march(module, r_o, r_d, t1, max_steps=steps,
                                     epsilon=1e-3, t_start=t0)
        plain = lambda: march_plain(module, r_o, r_d, t1, t0, max_steps=steps,
                                    epsilon=1e-3)
        depth, hit = kernel()
        pdepth, phit, evals = plain()
        torch.cuda.synchronize()
        agree = (hit == phit).float().mean().item()
        both = hit & phit
        derr = (depth - pdepth)[both].abs().max().item() if both.any() else 0.0
        frac = phit.float().mean().item()
        check(frac > 0, f"K2 {label}: no ray hit the surface")
        check(agree >= 0.99, f"K2 {label}: hit agreement {agree:.4f} < 0.99")
        check(derr <= 1e-3, f"K2 {label}: max |depth err| {derr:.3e} > 1e-3")
        ms = cuda_ms(kernel, 5)
        plain_ms = cuda_ms(plain, 3)
        n_evals = evals.sum().item()
        n_bytes = 4 * N_POINTS * (6 + (2 if bound else 0)) + 5 * N_POINTS \
            + weight_bytes(module.shift) + 4 * 13 * module.n
        b_ms, b_by = bound_ms(n_bytes, per_eval_flops * n_evals)
        print(f"K2 {label} ({steps} steps): hit fraction {frac:.4f}, hit "
              f"agreement {agree:.6f}, max |depth err| {derr:.3e}, SDF "
              f"evaluations needed {n_evals} ({n_evals / N_POINTS:.2f}/ray), "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.3f} ms "
              f"({b_by}), {per_eval_flops * n_evals / ms / 1e9:.1f} TFLOP/s")
        results[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                              bound_by=b_by, err=derr)
    return results


def flagship_eval_scene(max_steps, march_bound):
    """scripts/nerf_synthetic.py build_scene, in the port."""
    import neural_raytracing_tpu_torch as T
    from neural_raytracing_tpu_torch.bsdf import ComposeSpatialVarying, NeuralBSDF
    from neural_raytracing_tpu_torch.lights import LightField
    from neural_raytracing_tpu_torch.shapes import SDF, SphereSDF
    return T.Scene(
        shape=SDF(SphereSDF(n=128), max_steps=max_steps, throughput_steps=128,
                  dist=2.2, march_bound=march_bound),
        bsdf=ComposeSpatialVarying([NeuralBSDF(activation="softplus")
                                    for _ in range(8)]),
        lights=LightField())


def render_views(torch, scene, views, dev):
    """-> (images [V, 256, 256, 3], seconds per view) with the settings of
    training/eval.py's evaluate: chunk 128, bundle 1, background 0, jitter
    1e-3 from a seeded key per view."""
    import neural_raytracing_tpu_torch as T
    from neural_raytracing_tpu_torch.cameras import NeRFCamera, nerf_c2w
    from neural_raytracing_tpu_torch.integrators import Direct
    images, secs = [], []
    for i, (elev, azim) in enumerate(views):
        cam = NeRFCamera(torch.from_numpy(nerf_c2w(elev, azim, 2.0)[None, :3]), FOCAL)
        torch.cuda.synchronize()
        start = time.perf_counter()
        img, _ = T.pathtrace(scene, cam, Direct(training=False), size=SIZE,
                             chunk_size=CHUNK, bundle_size=1, background=0.0,
                             key=i, with_noise=1e-3, device=dev)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - start)
        images.append(img)
    return torch.stack(images), secs


def profile_view(torch, scene, view, dev):
    """Device time by kernel for one rendered view (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        render_views(torch, scene, [view], dev)
        wall_ms = 1e3 * (time.perf_counter() - start)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = 1e-3 * sum(e.self_device_time_total for e in kernels)
    if busy_ms == 0.0:
        print("  profile: the profiler saw no device time")
        return
    print(f"  profile of one view: device busy {busy_ms:.1f} ms of {wall_ms:.1f} ms "
          f"wall under the profiler (idle share {1 - busy_ms / wall_ms:.3f}); "
          f"top kernels by device time:")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {1e-3 * e.self_device_time_total:9.3f} ms  x{e.count:<5d} {e.key[:100]}")


def phase_slice(torch, dev, label, max_steps, march_bound, views, profile=False):
    from neural_raytracing_tpu_torch.kernels import (
        launch_counts, reset_launch_counts, set_kernel_mode,
    )
    scene = flagship_eval_scene(max_steps, march_bound)
    scene.init(torch.Generator().manual_seed(0), device=dev)
    render_views(torch, scene, views[:1], dev)      # warm-up, not counted
    reset_launch_counts()
    got, secs = render_views(torch, scene, views, dev)
    counts = launch_counts()
    if profile:
        profile_view(torch, scene, views[0], dev)
    set_kernel_mode(scene, "off")
    render_views(torch, scene, views[:1], dev)      # warm-up
    want, plain_secs = render_views(torch, scene, views, dev)
    set_kernel_mode(scene, "auto")

    for name, n in counts.items():
        check(n > 0, f"{label}: kernel {name} was not launched on the path")
    check(bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()),
          f"{label}: non-finite image")
    mask, pmask = got.abs().sum(-1) > 0, want.abs().sum(-1) > 0
    frac = pmask.float().mean().item()
    agree = (mask == pmask).float().mean().item()
    diff = (got - want).abs()
    check(frac > 0, f"{label}: no pixel hit the surface")
    check(agree >= 0.99, f"{label}: mask agreement {agree:.4f} < 0.99")
    check(diff.mean().item() <= 1e-3, f"{label}: mean |diff| {diff.mean().item():.3e}")
    ms_view = 1e3 * sum(secs) / len(secs)
    plain_ms_view = 1e3 * sum(plain_secs) / len(plain_secs)
    print(f"{label}: {len(views)} view(s) 256x256, kernels {ms_view:.1f} ms/view "
          f"({SIZE * SIZE / (ms_view / 1e3):.0f} rays/s), plain "
          f"{plain_ms_view:.1f} ms/view ({SIZE * SIZE / (plain_ms_view / 1e3):.0f} "
          f"rays/s); per-view ms {[round(1e3 * s, 1) for s in secs]} / "
          f"{[round(1e3 * s, 1) for s in plain_secs]}; hit fraction "
          f"{frac:.4f}, mask agreement {agree:.6f}, mean |diff| "
          f"{diff.mean().item():.3e}, max |diff| {diff.max().item():.3e}; "
          f"launches {counts}")
    return counts


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an "
             "NVIDIA GPU")
    sys.path.insert(0, str(ROOT))
    import neural_raytracing_tpu_torch
    if not Path(neural_raytracing_tpu_torch.__file__).resolve().is_relative_to(ROOT):
        fail("neural_raytracing_tpu_torch must be the package beside this script")
    from neural_raytracing_tpu_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False   # plain versions in IEEE f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")
    print("kernels: fused_mlp_forward, fused_march")
    secs = _build.build()
    print(f"kernel build: {secs:.1f} s")
    for stem in sorted(_build.library_paths()):
        for line in _build.ptxas_report(stem).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {stem}: {line.strip()}")

    k1 = phase_mlp(torch, dev)
    k2 = phase_march(torch, dev)
    eval_views = [(30.0, 45.0), (30.0, 165.0), (30.0, 285.0)]
    counts = phase_slice(torch, dev, "eval render (bounded, 256 steps)", 256, 1.2,
                         eval_views, profile=True)
    phase_slice(torch, dev, "validation render (unbounded, 64 steps)", 64, None,
                [(30.0, 45.0)], profile=True)

    kernels = [
        dict(name="fused_mlp_forward", route="cuda",
             source="neural_raytracing_tpu_torch/csrc/fused_mlp.cu",
             replaces="neural_raytracing_tpu/kernels/fused_mlp.py:129",
             launches=counts["fused_mlp_forward"], max_abs_err=k1["err"],
             ms=k1["ms"], plain_ms=k1["plain_ms"], bound_ms=k1["bound_ms"],
             bound_by=k1["bound_by"], library_ms=None),
        dict(name="fused_march", route="cuda",
             source="neural_raytracing_tpu_torch/csrc/fused_march.cu",
             replaces="neural_raytracing_tpu/kernels/fused_march.py:405",
             launches=counts["fused_march"], max_abs_err=k2["bounded"]["err"],
             ms=k2["bounded"]["ms"], plain_ms=k2["bounded"]["plain_ms"],
             bound_ms=k2["bounded"]["bound_ms"], bound_by=k2["bounded"]["bound_by"],
             library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
