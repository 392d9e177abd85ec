"""The port's CUDA kernels: package rules and the kernel switch on the CPU,
and, on a machine with an NVIDIA GPU, each kernel against its plain version.

The tests marked ``cuda`` skip without a card.  They import neither JAX nor
the JAX package, so they run on the card with

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances on the card: K1 |kernel - plain| <= 1e-4 |plain| + 1e-5 +
4e-7 max|x.B| (float32 rounding of the Fourier argument, amplified by the
net); K2 hit agreement >= 99% and |depth difference| <= 1e-3 where both hit
(float32 sums in another order over up to 256 steps); K3 index agreement
>= 99.9%, and where the indices differ the two SDF values within 1e-5 (near
ties, float32 sums in another order); K6/K7 each gradient within 1e-4 of
max|plain| (float32 sums in another order; on the general route atomics in
a varying one, on the tile the same bits from launch to launch); K4
not-blocked agreement >= 99.9% (a near-eps step may fall on either side in
another sum order), the same flags bit for bit across launches and
permutations, zero-direction rays exactly the plain loop's, and its launch
statistics within 1% of the plain loop's evaluations; K5 as K1, its first and second derivatives (recomputed
through the plain version) rtol/atol 1e-4, and its two routes the same
bits; K8 2e-5 absolute + 2e-5 relative (exp and products in another order),
two launches the same bits, its gradients (recomputed through the plain
version) 1e-4 absolute + 1e-3 relative; K2 relaxed as K2, and on the
exact one-sphere rule cases the plain version's hit flags, depths within
1e-3.  The bf16-operand variants against their plain versions: a float32
difference (x.B by fmaf against a matmul, sums in another order) can tip a
bf16 rounding, which moves that operand by one bf16 step and its row from
there on; so K1-bf16 holds half of its rows within K1's tolerance and its
mean error below a quarter of the mean |bf16 - float32| difference of the
plain versions; K2-bf16 hit agreement >= 99%, and where both hit the depths
within 1e-3 on 99% of the rays and within 1e-2 on 99.9% (a depth sums the
steps, and each step's SDF carries the bf16 noise of the shift, up to one
bf16 step of its output where a rounding tips); K4-bf16 as K4; K3-bf16
index agreement >= 99% and, where the indices differ, the two SDF values
within 1e-3 (ties at twice that noise).  Each bf16 kernel must also
differ from its float32 kernel on the same non-zero net: one that silently
ran in float32 fails.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from neural_raytracing_tpu_torch.kernels import (
    FusedSkipConnMLP, FusedSphereSDF, composite_apply, composite_plain,
    fused_composite, fused_march, fused_march_bf16, fused_min_scan,
    fused_min_scan_bf16, fused_mlp_apply, fused_mlp_backward,
    fused_mlp_ckpt_forward, fused_mlp_forward, fused_mlp_forward_bf16,
    fused_mlp_segment_backward, fused_shadow_march, fused_shadow_march_bf16,
    fused_sphere_sdf, launch_counts, march_info, march_plain, min_scan_blocks_per_sm,
    min_scan_plain, mlp_backward,
    mlp_forward_bf16_operands, reset_launch_counts, set_kernel_mode,
    shadow_march_plain, sphere_sdf_eval_plain, sphere_sdf_plain, supports,
)
from neural_raytracing_tpu_torch.kernels import (
    _build, k5_route, k5_tile_info, k5_tile_spheres, pack_tile_transposes, pack_tile_weights,
    route_counts, tile_bwd_info, tile_info, tile_pack, tile_pack_plain, tile_transposes_plain,
)
from neural_raytracing_tpu_torch.nn import SkipConnMLP
from neural_raytracing_tpu_torch.shapes import (
    SDF, NeRFLE, SphereSDF, march_interval, volumetric_integrate,
)

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "neural_raytracing_tpu")
KERNEL_NAMES = ("fused_mlp_forward", "fused_march", "fused_min_scan",
                "fused_mlp_backward", "fused_mlp_ckpt_forward",
                "fused_mlp_segment_backward", "fused_shadow_march",
                "fused_sphere_sdf", "fused_composite", "fused_mlp_forward_bf16",
                "fused_march_bf16", "fused_min_scan_bf16", "fused_shadow_march_bf16",
                "pack_tile_weights", "pack_tile_transposes")

FLAGSHIP = {
    "sdf_shift": dict(in_size=3, out=1, num_layers=8, hidden_size=128,
                      freqs=32, activation="softplus", init="uniform"),
    "weight_net": dict(in_size=3, out=8, num_layers=16, hidden_size=256,
                       freqs=128, sigma=128.0, init="xavier"),
    "lobe": dict(in_size=3, out=3, num_layers=6, hidden_size=96, freqs=64),
    "light_field": dict(in_size=3, out=3, num_layers=10, hidden_size=256),
}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    files = sorted((ROOT / "neural_raytracing_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"


def test_chip_smoke_refuses_to_run_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "is_available" in out.stderr


def test_mlp_mode_switch_on_cpu_tensors():
    g = torch.Generator().manual_seed(0)
    x = torch.rand(16, 3, generator=g)
    nets = {m: FusedSkipConnMLP(num_layers=2, hidden_size=8, freqs=2, mode=m)
            for m in ("auto", "force", "off")}
    nets["off"].reset_parameters(g)
    for m in ("auto", "force"):
        nets[m].load_state_dict(nets["off"].state_dict())
    reset_launch_counts()
    assert torch.equal(nets["auto"](x), SkipConnMLP.forward(nets["off"], x))
    assert torch.equal(nets["off"](x), SkipConnMLP.forward(nets["off"], x))
    with pytest.raises(RuntimeError, match="CUDA"):
        nets["force"](x)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_forward(nets["off"], x, nets["off"].B, nets["off"].flat_weights())
    with pytest.raises(ValueError, match="mode"):
        FusedSkipConnMLP(mode="on")
    assert launch_counts() == {name: 0 for name in KERNEL_NAMES}


def test_set_kernel_mode_reaches_every_net_and_sdf():
    sdf = SDF(SphereSDF(n=4, mlp=FusedSkipConnMLP(in_size=3, out=1, num_layers=2,
                                                  hidden_size=8, freqs=2)))
    set_kernel_mode(sdf, "off")
    assert sdf.fused_loops == "off" and sdf.module.shift.mode == "off"
    set_kernel_mode(sdf, "auto")
    assert sdf.fused_loops == "auto" and sdf.shift.mode == "auto"
    with pytest.raises(ValueError):
        set_kernel_mode(sdf, "fast")


def test_build_without_nvcc_fails_loudly(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    assert set(_build.library_paths()) == {"fused_mlp", "fused_mlp_tile", "fused_march",
                                           "fused_minscan", "fused_mlp_bwd",
                                           "fused_mlp_bwd_tile", "fused_shadow",
                                           "fused_sdf", "composite"}
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


# ---- on the card -----------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _net(cfg, seed, device):
    mlp = FusedSkipConnMLP(**cfg)
    mlp.reset_parameters(torch.Generator().manual_seed(seed))
    return mlp.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLAGSHIP))
def test_fused_mlp_kernel_matches_plain(cuda, name):
    mlp = _net(FLAGSHIP[name], 0, cuda)
    x = (torch.rand(4099, 3, generator=torch.Generator().manual_seed(1)) - 0.5).to(cuda)
    with torch.no_grad():
        reset_launch_counts()
        got = fused_mlp_forward(mlp, x, mlp.B, mlp.flat_weights())
        want = SkipConnMLP.forward(mlp, x)
        torch.cuda.synchronize()
    assert launch_counts()["fused_mlp_forward"] == 1
    tol = 1e-4 * want.abs() + 1e-5 + 4e-7 * (x @ mlp.B).abs().max()
    assert ((got - want).abs() <= tol).all(), (got - want).abs().max().item()


@pytest.mark.cuda
def test_fused_mlp_gradients_through_the_kernel(cuda):
    mlp = _net(FLAGSHIP["sdf_shift"], 2, cuda)
    x = (torch.rand(512, 3, generator=torch.Generator().manual_seed(3)) - 0.5).to(cuda)

    def grads(fn):
        xx = x.clone().requires_grad_()
        (gx,) = torch.autograd.grad(fn(xx).sum(), xx, create_graph=True)
        (gw,) = torch.autograd.grad(gx.square().sum(), mlp.layers[0].w)
        return gx, gw

    got = grads(lambda xx: fused_mlp_apply(mlp, xx))
    want = grads(lambda xx: SkipConnMLP.forward(mlp, xx))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def _surface(device, stable_min=False, shift=FLAGSHIP["sdf_shift"]):
    module = SphereSDF(n=128, mlp=FusedSkipConnMLP(**shift), stable_min=stable_min)
    module.reset_parameters(torch.Generator().manual_seed(4))
    with torch.no_grad():
        module.shift.out.w.mul_(0.1)
        module.shift.out.b.mul_(0.1)
        module.radii.copy_(0.3 + 0.5 * module.radii)
    return module.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("stable_min", [False, True])
@pytest.mark.parametrize("max_steps,bound", [(64, None), (256, 1.2)])
def test_fused_march_matches_plain(cuda, max_steps, bound, stable_min):
    module = _surface(cuda, stable_min)
    g = torch.Generator().manual_seed(5)
    r_o = torch.tensor([0.0, 0.0, 2.0]).expand(3001, 3).contiguous()
    r_d = torch.tensor([0.0, 0.0, -1.0]) + 0.3 * torch.randn(3001, 3, generator=g)
    r_o, r_d = r_o.to(cuda), torch.nn.functional.normalize(r_d, dim=-1).to(cuda)
    t0, t1 = (None, 10.0) if bound is None else march_interval(r_o, r_d, bound, 10.0)
    reset_launch_counts()
    depth, hit = fused_march(module, r_o, r_d, t1, max_steps=max_steps,
                             epsilon=1e-3, t_start=t0)
    assert launch_counts()["fused_march"] == 1
    set_kernel_mode(module, "off")
    pdepth, phit, _ = march_plain(module, r_o, r_d, t1, t0, max_steps=max_steps,
                                  epsilon=1e-3)
    torch.cuda.synchronize()
    assert phit.float().mean() > 0
    assert (hit == phit).float().mean() >= 0.99
    both = hit & phit
    assert (depth - pdepth)[both].abs().max() <= 1e-3


@pytest.mark.cuda
def test_sdf_intersect_goes_through_both_kernels(cuda):
    module = _surface(cuda)
    sdf = SDF(module, max_steps=64, march_bound=1.2)
    rays = torch.cat([torch.tensor([0.0, 0.0, 2.0]).expand(256, 3),
                      torch.nn.functional.normalize(
                          torch.tensor([0.0, 0.0, -1.0]) + 0.2 * torch.randn(
                              256, 3, generator=torch.Generator().manual_seed(6)),
                          dim=-1)], dim=-1).to(cuda)
    reset_launch_counts()
    with torch.no_grad():
        it, hit = sdf.intersect(rays, primary=False)
    counts = launch_counts()
    assert counts["fused_march"] == 1 and counts["fused_mlp_forward"] == 1
    set_kernel_mode(sdf, "off")
    with torch.no_grad():
        pit, phit = sdf.intersect(rays, primary=False)
    both = hit & phit
    assert both.any() and (hit == phit).float().mean() >= 0.99
    torch.testing.assert_close(it.n[both], pit.n[both], rtol=0, atol=1e-3)


def test_new_kernels_raise_on_cpu_tensors():
    module = SphereSDF(n=4, mlp=FusedSkipConnMLP(in_size=3, out=1, num_layers=2,
                                                 hidden_size=8, freqs=2))
    mlp = FusedSkipConnMLP(num_layers=2, hidden_size=8, freqs=2)
    x, g = torch.rand(8, 3), torch.rand(8, 3)
    ws = [w.detach() for w in mlp.flat_weights()]
    with pytest.raises(ValueError, match="CUDA"):
        fused_min_scan(module, x, x, 0.1, steps=4)
    with pytest.raises(ValueError, match="CUDA"):
        fused_shadow_march(module, x, x, 1.0, max_steps=4, epsilon=1e-3)
    with pytest.raises(ValueError, match="CUDA"):
        fused_sphere_sdf(module, x)
    with pytest.raises(ValueError, match="CUDA"):
        fused_composite(torch.rand(4, 8), torch.rand(4, 8, 3), torch.rand(4))
    with pytest.raises(ValueError, match="omega"):
        fused_march(module, x, x, 1.0, max_steps=4, epsilon=1e-3, omega=2.0)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_backward(mlp, x, g, mlp.B, ws)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_ckpt_forward(mlp, x, mlp.B, ws, [0, 2])
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_segment_backward(mlp, x, mlp.B, ws, torch.rand(8, 7),
                                   torch.rand(8, 8), torch.rand(8, 8), 0, 2)
    assert launch_counts()["fused_min_scan"] == 0
    assert launch_counts()["fused_shadow_march"] == 0
    assert launch_counts()["fused_sphere_sdf"] == 0
    assert launch_counts()["fused_composite"] == 0


def test_fused_sphere_sdf_modes_and_kernel_support():
    gen = torch.Generator().manual_seed(0)
    shift = dict(in_size=3, out=1, num_layers=2, hidden_size=8, freqs=2,
                 activation="softplus", init="uniform")
    fused = {m: FusedSphereSDF(n=4, mlp=SkipConnMLP(**shift), mode=m)
             for m in ("auto", "force", "off")}
    fused["off"].reset_parameters(gen)
    for m in ("auto", "force"):
        fused[m].load_state_dict(fused["off"].state_dict())
    plain = SphereSDF(n=4, mlp=SkipConnMLP(**shift))
    plain.load_state_dict(fused["off"].state_dict())
    x = torch.rand(16, 3, generator=gen) - 0.5
    reset_launch_counts()
    assert torch.equal(fused["auto"](x), plain(x))
    assert torch.equal(fused["off"](x), plain(x))
    with pytest.raises(RuntimeError, match="CUDA"):
        fused["force"](x)
    with pytest.raises(ValueError, match="mode"):
        FusedSphereSDF(n=4, mode="on")
    assert launch_counts()["fused_sphere_sdf"] == 0
    # K2, K3 and K4 take either surface, as the JAX supports() does
    assert supports(fused["auto"]) and supports(plain)
    assert not supports(FusedSphereSDF(n=4, mlp=SkipConnMLP(in_size=3, out=2)))
    assert SDF(fused["auto"], fused_loops="force")._use_kernel(x)
    sdf = SDF(fused["auto"])
    set_kernel_mode(sdf, "off")
    assert fused["auto"].mode == "off" and not sdf._use_kernel(x)


# K3's cases: the flagship shift, a jittered step (a 0-d tensor on the card),
# the exact smooth-min, a leaky_relu shift, a net whose widths K3 pads, and
# one wider than 128 (the 64-row, 256-column layout)
SCAN_SHIFTS = {
    "leaky_relu": dict(FLAGSHIP["sdf_shift"], activation="leaky_relu"),
    "padded": dict(in_size=3, out=1, num_layers=5, hidden_size=72, freqs=20, skip=2,
                   activation="softplus", init="uniform"),
    "wide": dict(in_size=3, out=1, num_layers=4, hidden_size=160, freqs=24,
                 activation="softplus", init="uniform"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["flagship", "jitter", "stable_min", "leaky_relu",
                                  "padded", "wide"])
@pytest.mark.parametrize("n_rays", [1, 31, 3001])
@pytest.mark.parametrize("steps", [1, 64, 127, 128])
def test_fused_min_scan_matches_plain(cuda, steps, n_rays, case, dtype):
    """K3 (f32) and K3-bf16 against min_scan_plain over the SDF of their
    precision; K3-bf16 must differ from K3 where it has rays to show it."""
    bf16 = dtype == torch.bfloat16
    module = _surface(cuda, case == "stable_min",
                      SCAN_SHIFTS.get(case, FLAGSHIP["sdf_shift"]))
    g = torch.Generator().manual_seed(7)
    r_o = torch.tensor([0.0, 0.0, 2.0]).expand(3001, 3)[:n_rays].contiguous()
    r_d = (torch.tensor([0.0, 0.0, -1.0])
           + 0.3 * torch.randn(3001, 3, generator=g))[:n_rays]
    r_o, r_d = r_o.to(cuda), torch.nn.functional.normalize(r_d, dim=-1).to(cuda)
    step = 2.2 / steps
    if case == "jitter":
        step = torch.tensor((2.2 + 0.3 * 2.0 / steps) / steps, device=cuda)
    name = "fused_min_scan_bf16" if bf16 else "fused_min_scan"
    reset_launch_counts()
    idx = (fused_min_scan_bf16 if bf16 else fused_min_scan)(module, r_o, r_d, step,
                                                            steps=steps)
    counts = launch_counts()
    # and one pack of the new module's shift net, which the next launches reuse
    assert counts[name] == 1 and counts["pack_tile_weights"] == 1
    assert sum(counts.values()) == 2
    set_kernel_mode(module, "off")
    sdf = _bf16_sdf(module) if bf16 else module
    pidx = min_scan_plain(sdf, r_o, r_d, step, steps=steps)
    torch.cuda.synchronize()
    assert idx.shape == pidx.shape == (n_rays,) and idx.dtype == torch.float32
    differ = idx != pidx
    assert (~differ).float().mean() >= (0.99 if bf16 else 0.999)
    if differ.any():
        s = torch.as_tensor(step, device=cuda)
        with torch.no_grad():
            sd = sdf(r_o[differ] + (idx[differ] * s)[:, None] * r_d[differ])
            psd = sdf(r_o[differ] + (pidx[differ] * s)[:, None] * r_d[differ])
        assert (sd - psd).abs().max() <= (1e-3 if bf16 else 1e-5)
    if bf16 and n_rays == 3001 and steps >= 64:                 # not silently f32
        assert (idx != fused_min_scan(module, r_o, r_d, step, steps=steps)).any()


@pytest.mark.cuda
def test_fused_min_scan_occupancy(cuda):
    """The flagship shift's K3 and K3-bf16 fit twice on an SM."""
    module = _surface(cuda)
    for dtype in (torch.float32, torch.bfloat16):
        assert min_scan_blocks_per_sm(module, dtype) == 2


def _autograd_backward(mlp, x, g):
    ws = list(mlp.flat_weights())
    xx = x.clone().requires_grad_()
    out = SkipConnMLP.forward(mlp, xx)
    return torch.autograd.grad(out, [xx] + ws, g)


def _assert_grads_close(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        scale = b.abs().max().item()
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * scale + 1e-6, (i, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [0, 4])
@pytest.mark.parametrize("name", sorted(FLAGSHIP))
def test_fused_mlp_backward_matches_plain(cuda, name, segments):
    mlp = _net(FLAGSHIP[name], 8, cuda)
    gen = torch.Generator().manual_seed(9)
    x = (torch.rand(4099, 3, generator=gen) - 0.5).to(cuda)
    g = torch.randn(4099, mlp.out_size, generator=gen).to(cuda)
    reset_launch_counts()
    dx, grads = mlp_backward(mlp, x, g, mlp.B, mlp.flat_weights(), segments)
    counts = launch_counts()
    if segments:
        n_seg = min(segments, mlp.num_layers)
        assert counts["fused_mlp_ckpt_forward"] == 1
        assert counts["fused_mlp_segment_backward"] == n_seg
    else:
        assert counts["fused_mlp_backward"] == 1
    want = _autograd_backward(mlp, x, g)
    torch.cuda.synchronize()
    assert len(grads) + 1 == len(want)
    _assert_grads_close([dx, *grads], want)


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [0, 2])
def test_kernel_bwd_through_autograd(cuda, segments):
    cfg = dict(FLAGSHIP["lobe"])
    kmlp = FusedSkipConnMLP(kernel_bwd=True, kernel_bwd_segments=segments, **cfg)
    kmlp.reset_parameters(torch.Generator().manual_seed(10))
    kmlp.to(cuda)
    x = (torch.rand(777, 3, generator=torch.Generator().manual_seed(11)) - 0.5).to(cuda)
    xx = x.clone().requires_grad_()
    reset_launch_counts()
    kmlp(xx).square().sum().backward()
    counts = launch_counts()
    assert counts["fused_mlp_forward"] == 1
    assert counts["fused_mlp_backward" if segments < 2 else "fused_mlp_ckpt_forward"] == 1
    got = [xx.grad] + [w.grad for w in kmlp.flat_weights()]
    want = _autograd_backward(kmlp, x, 2 * SkipConnMLP.forward(kmlp, x).detach())
    _assert_grads_close(got, want)


def _shadow_rays(device, n=3001, seed=12):
    """Shadow rays from points on a shell of radius 0.7 around the surface
    towards a light at (0.4, 1.6, 0.9); every 7th ray has a zero direction.
    -> (r_o, r_d, distance to the light)."""
    g = torch.Generator().manual_seed(seed)
    p = torch.nn.functional.normalize(torch.randn(n, 3, generator=g), dim=-1) * 0.7
    to_light = torch.tensor([0.4, 1.6, 0.9]) - p
    dist = to_light.norm(dim=-1)
    r_d = to_light / dist[:, None]
    r_d[::7] = 0.0
    return p.to(device), r_d.to(device), dist.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("stable_min", [False, True])
@pytest.mark.parametrize("past_light_exit", [True, False])
def test_fused_shadow_march_matches_plain(cuda, past_light_exit, stable_min):
    module = _surface(cuda, stable_min)
    r_o, r_d, dist = _shadow_rays(cuda)
    for max_t in (dist, 10.0):
        reset_launch_counts()
        nb = fused_shadow_march(module, r_o, r_d, max_t, max_steps=64, epsilon=1e-3,
                                past_light_exit=past_light_exit)
        assert launch_counts()["fused_shadow_march"] == 1
        set_kernel_mode(module, "off")
        pnb, evals = shadow_march_plain(module, r_o, r_d, max_t, max_steps=64,
                                        epsilon=1e-3, past_light_exit=past_light_exit)
        set_kernel_mode(module, "auto")
        torch.cuda.synchronize()
        assert nb.dtype == torch.bool and nb.shape == pnb.shape == (3001,)
        assert 0.0 < pnb.float().mean().item() < 1.0
        assert (nb == pnb).float().mean() >= 0.999
        assert nb[::7].all()                  # zero-direction rays are free
        assert evals.sum() > 0


@pytest.mark.cuda
def test_sdf_intersect_test_goes_through_k4(cuda):
    sdf = SDF(_surface(cuda), max_steps=64)
    r_o, r_d, dist = _shadow_rays(cuda, n=512)
    rays = torch.cat([r_o, r_d], dim=-1)
    reset_launch_counts()
    nb = sdf.intersect_test(rays, max_t=dist)
    assert launch_counts()["fused_shadow_march"] == 1
    set_kernel_mode(sdf, "off")
    pnb = sdf.intersect_test(rays, max_t=dist)
    assert (nb == pnb).float().mean() >= 0.99


def _fused_surface(device, stable_min=False):
    module = FusedSphereSDF(n=128, mlp=SkipConnMLP(**FLAGSHIP["sdf_shift"]),
                            stable_min=stable_min)
    module.load_state_dict(_surface("cpu", stable_min).state_dict())
    return module.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("stable_min", [False, True])
def test_fused_sphere_sdf_matches_plain(cuda, stable_min):
    module = _fused_surface(cuda, stable_min)
    x = (2.0 * torch.rand(4099, 3, generator=torch.Generator().manual_seed(13))
         - 1.0).to(cuda)
    reset_launch_counts()
    with torch.no_grad():
        got = module(x)
        assert launch_counts()["fused_sphere_sdf"] == 1
        want = sphere_sdf_plain(module, x, module.centers, module.radii, module.tfs,
                                module.shift.B, module.shift.flat_weights())
        torch.cuda.synchronize()
    tol = 1e-4 * want.abs() + 1e-5 + 4e-7 * (x @ module.shift.B).abs().max()
    assert ((got - want).abs() <= tol).all(), (got - want).abs().max().item()

    def grads():
        xx = x[:512].clone().requires_grad_()
        (gx,) = torch.autograd.grad(module(xx).sum(), xx, create_graph=True)
        gw = torch.autograd.grad(gx.square().sum(),
                                 [module.centers, module.shift.layers[0].w])
        return (gx, *gw)

    got = grads()
    module.mode = "off"
    want = grads()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_fused_sphere_sdf_surface_through_k2_k4_k5(cuda):
    sdf = SDF(_fused_surface(cuda), max_steps=64, march_bound=1.2)
    r_o, r_d, dist = _shadow_rays(cuda, n=512)
    cam = torch.cat([torch.tensor([0.0, 0.0, 2.0]).expand(256, 3),
                     torch.nn.functional.normalize(
                         torch.tensor([0.0, 0.0, -1.0]) + 0.2 * torch.randn(
                             256, 3, generator=torch.Generator().manual_seed(6)),
                         dim=-1)], dim=-1).to(cuda)
    reset_launch_counts()
    with torch.no_grad():
        _, hit = sdf.intersect(cam, primary=False)
        sdf.intersect_test(torch.cat([r_o, r_d], dim=-1), max_t=dist)
    counts = launch_counts()
    assert hit.any()
    assert counts["fused_march"] == 1 and counts["fused_shadow_march"] == 1
    assert counts["fused_sphere_sdf"] == 1 and counts["fused_mlp_forward"] == 0


# K5's surfaces: the flagship / NeRV shift (NP 128), a 256-wide one, a
# leaky_relu one, and a net off the tile (the general route)
K5_SHIFTS = {
    "flagship": FLAGSHIP["sdf_shift"],
    "wide": dict(in_size=3, out=1, num_layers=4, hidden_size=160, freqs=24,
                 activation="softplus", init="uniform"),
    "leaky_relu": dict(FLAGSHIP["sdf_shift"], activation="leaky_relu"),
    "off the tile": dict(in_size=3, out=1, num_layers=3, hidden_size=272, freqs=8,
                         activation="softplus", init="uniform"),
}


def _k5_surface(device, shift, stable_min=False, seed=26):
    module = FusedSphereSDF(n=128, mlp=SkipConnMLP(**shift), stable_min=stable_min)
    module.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        module.shift.out.w.mul_(0.1)
        module.radii.copy_(0.3 + 0.5 * module.radii)
    return module.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 4_099])
@pytest.mark.parametrize("stable_min", [False, True])
@pytest.mark.parametrize("name", sorted(K5_SHIFTS))
def test_k5_routes_match_plain(cuda, name, stable_min, n):
    """K5 on the route its shape picks (and on the general route for a tile
    net) against the plain version, with the launch counted by route; the
    two routes give the same bits."""
    module = _k5_surface(cuda, K5_SHIFTS[name], stable_min)
    route = k5_route(module)
    assert route == ("general" if name == "off the tile" else "tile")
    x = (2.4 * torch.rand(n, 3, generator=torch.Generator().manual_seed(27)) - 1.2).to(cuda)
    reset_launch_counts()
    with torch.no_grad():
        got = fused_sphere_sdf(module, x)
        assert route_counts()["fused_sphere_sdf"] == {"tile": int(route == "tile"),
                                                      "general": int(route == "general")}
        want = sphere_sdf_plain(module, x, module.centers, module.radii, module.tfs,
                                module.shift.B, module.shift.flat_weights())
        other = fused_sphere_sdf(module, x, route="general")
        torch.cuda.synchronize()
    tol = 1e-4 * want.abs() + 1e-5 + 4e-7 * (x @ module.shift.B).abs().max()
    assert got.shape == (n,)
    assert ((got - want).abs() <= tol).all(), (got - want).abs().max().item()
    assert torch.equal(got, other)


@pytest.mark.cuda
def test_k5_tile_derivatives_match_plain(cuda):
    """First and second derivatives through K5's autograd.Function on the
    tile (the backward recomputes through the plain version)."""
    module = _k5_surface(cuda, FLAGSHIP["sdf_shift"])
    x = (2.0 * torch.rand(512, 3, generator=torch.Generator().manual_seed(28)) - 1.0).to(cuda)

    def grads():
        xx = x.clone().requires_grad_()
        (gx,) = torch.autograd.grad(module(xx).sum(), xx, create_graph=True)
        gw = torch.autograd.grad(gx.square().sum(), [module.centers, module.shift.layers[3].w])
        return (gx, *gw)

    reset_launch_counts()
    got = grads()
    assert route_counts()["fused_sphere_sdf"] == {"tile": 1, "general": 0}
    module.mode = "off"
    for a, b in zip(got, grads()):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_k5_edges(cuda):
    """No points: nothing launched, an empty result.  A sphere set past the
    tile's h rows takes the general route, and the tile refuses it."""
    module = _k5_surface(cuda, FLAGSHIP["sdf_shift"])
    reset_launch_counts()
    out = fused_sphere_sdf(module, torch.empty(0, 3, device=cuda))
    assert out.shape == (0,) and launch_counts()["fused_sphere_sdf"] == 0
    x = torch.rand(8, 3, device=cuda)
    big = _k5_surface(cuda, FLAGSHIP["sdf_shift"])
    n_big = k5_tile_spheres(128) + 1
    big.centers = torch.nn.Parameter(torch.rand(n_big, 3, device=cuda))
    big.radii = torch.nn.Parameter(torch.rand(n_big, device=cuda))
    big.tfs = torch.nn.Parameter(torch.zeros(n_big, 3, 3, device=cuda))
    assert k5_route(big) == "general"
    with pytest.raises(ValueError, match="route"):
        fused_sphere_sdf(big, x, route="tile")
    with torch.no_grad():
        want = sphere_sdf_plain(big, x, big.centers, big.radii, big.tfs, big.shift.B,
                                big.shift.flat_weights())
        got = fused_sphere_sdf(big, x)
    assert ((got - want).abs() <= 1e-4 * want.abs() + 1e-5).all()
    assert k5_tile_info(module)["blocks_per_sm"] == 2


def _one_sphere(device):
    """An exact SDF (one sphere of radius 0.5, the exact smooth-min, a zero
    shift): every step of the cases below is exact in float32."""
    module = SphereSDF(n=1, mlp=SkipConnMLP(in_size=3, out=1, num_layers=1,
                                            hidden_size=4, freqs=2, init="zeros"),
                       stable_min=True)
    with torch.no_grad():
        module.radii.fill_(0.5)
    return module.to(device)


@pytest.mark.cuda
def test_fused_shadow_march_rules(cuda):
    """K4's rules that differ from K2's, each in a case it decides (the CPU
    twin is tests/test_torch_occlusion.py::test_shadow_march_rules): the
    strict sd < eps, the advance on the hit step, the start at 1e2 * eps."""
    eps = 2.0 ** -10
    module = _one_sphere("cpu")
    r_o = [[0.5 + eps - 1e2 * eps, 0.0, 0.0], [0.5 + 0.5 * eps, 0.0, 0.0],
           [0.0, 0.3, 1.5]]
    r_d = torch.nn.functional.normalize(torch.tensor(
        [[1.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.02, -1.0]]), dim=-1)
    r_o = torch.tensor(r_o)
    with torch.no_grad():      # the grazing ray's hit step, and a light inside it
        depth = torch.tensor([1e2 * eps])
        for _ in range(63):
            sd = module(r_o[2:] + r_d[2:] * depth[:, None])
            if sd.item() < eps:
                break
            depth = depth + sd
    assert 0.0 < sd.item() < eps
    max_t = torch.cat([torch.tensor([10.0, 10.0]), depth + 0.5 * sd])
    nb = fused_shadow_march(_one_sphere(cuda), r_o.to(cuda), r_d.to(cuda),
                            max_t.to(cuda), max_steps=64, epsilon=eps)
    assert nb.tolist() == [True, True, True]


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_fused_shadow_march_same_flags_across_launches_and_permutations(cuda, compute_dtype):
    """A ray's flag depends on its own evaluations only (its state lives in
    global memory, its sums run in one order whatever rows a step
    evaluates): the same bits in a second launch and under a permutation."""
    module = _surface(cuda)
    r_o, r_d, dist = _shadow_rays(cuda, n=20_001)
    kw = dict(max_steps=64, epsilon=1e-3, compute_dtype=compute_dtype)
    nb = fused_shadow_march(module, r_o, r_d, dist, **kw)
    nb2 = fused_shadow_march(module, r_o, r_d, dist, **kw)
    perm = torch.randperm(20_001, generator=torch.Generator().manual_seed(9)).to(cuda)
    nb3 = fused_shadow_march(module, r_o[perm].contiguous(), r_d[perm].contiguous(),
                             dist[perm].contiguous(), **kw)
    assert torch.equal(nb, nb2) and torch.equal(nb[perm], nb3)
    assert 0.0 < (~nb).float().mean().item() < 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("past_light_exit", [True, False])
@pytest.mark.parametrize("compute_dtype", [torch.float32, torch.bfloat16])
def test_fused_shadow_march_zero_direction_rays_match_plain(cuda, compute_dtype,
                                                            past_light_exit):
    """Zero-direction rays (masked light samples) never move, so their one
    evaluation decides them: blocked inside the surface, free outside, as
    the plain loop that marches them on (points 0.01 from the surface, so
    neither operand type's rounding tips a flag)."""
    module = _surface(cuda)
    set_kernel_mode(module, "off")
    sdf = (lambda p: sphere_sdf_eval_plain(module, p, compute_dtype))
    p = (1.6 * torch.rand(20_000, 3, generator=torch.Generator().manual_seed(15))
         - 0.8).to(cuda)
    sd = sdf(p)
    p = torch.cat([p[sd < -0.01][:2000], p[sd > 0.01][:2000]]).contiguous()
    zero = torch.zeros_like(p)
    kw = dict(max_steps=64, epsilon=1e-3, past_light_exit=past_light_exit)
    reset_launch_counts()
    nb = fused_shadow_march(module, p, zero, 10.0, compute_dtype=compute_dtype, **kw)
    name = "fused_shadow_march" + ("_bf16" if compute_dtype == BF16 else "")
    assert launch_counts()[name] == 1
    pnb, _ = shadow_march_plain(sdf, p, zero, 10.0, **kw)
    assert p.shape[0] == 4000 and torch.equal(nb, pnb)
    assert not nb[:2000].any() and nb[2000:].all()


@pytest.mark.cuda
def test_fused_shadow_march_stats_add_up(cuda):
    """stats= adds a launch's tile steps, rows evaluated and live rows: the
    live rows are the rays' evaluations (a moving ray's as the plain loop
    counts them, a zero-direction ray's one), as many again in a second
    launch; a step evaluates no more rows than a block's slots."""
    module = _surface(cuda)
    r_o, r_d, dist = _shadow_rays(cuda, n=5000)
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    nb = fused_shadow_march(module, r_o, r_d, dist, max_steps=64, epsilon=1e-3, stats=stats)
    set_kernel_mode(module, "off")
    _, evals = shadow_march_plain(module, r_o, r_d, dist, max_steps=64, epsilon=1e-3)
    steps, rows, live = stats.tolist()
    moving = r_d.abs().sum(-1) > 0
    want = int(evals[moving].sum()) + int((~moving).sum())
    assert abs(live - want) <= 0.01 * want
    assert live <= rows <= 128 * steps and steps >= int(evals.max())
    fused_shadow_march(module, r_o, r_d, dist, max_steps=64, epsilon=1e-3, stats=stats)
    assert stats[2].item() == 2 * live
    assert nb.dtype == torch.bool


def _composite_inputs(device, n_t=64, n_r=10_001, seed=14):
    g = torch.Generator().manual_seed(seed)
    sigma = torch.relu(torch.randn(n_t, n_r, generator=g))
    sigma[min(5, n_t - 1), :7] = 1e4         # 1 - alpha at the 1e-10 clamp
    rgb = torch.sigmoid(torch.randn(n_t, n_r, 3, generator=g))
    ts = torch.linspace(0.0, 2.0, n_t)
    return sigma.to(device), rgb.to(device), ts.to(device)


# K8's shapes: the eval tile and a training step, and ragged ones (T not a
# multiple of the segments, T = 1, R not a multiple of 32, one ray)
K8_SHAPES = [(64, 10_001), (13, 37), (64, 1_024), (65, 1_000), (1, 33), (7, 1),
             (100, 31), (17, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_t,n_r", K8_SHAPES)
def test_fused_composite_matches_plain(cuda, n_t, n_r):
    sigma, rgb, ts = _composite_inputs(cuda, n_t, n_r)
    reset_launch_counts()
    got = fused_composite(sigma, rgb, ts)
    assert launch_counts()["fused_composite"] == 1
    want = composite_plain(sigma, rgb, ts)
    again = fused_composite(sigma, rgb, ts)
    torch.cuda.synchronize()
    assert got.shape == (n_r, 3)
    assert ((got - want).abs() <= 2e-5 + 2e-5 * want.abs()).all()
    assert torch.equal(got, again)

    def grads(fn):
        s, c = sigma.clone().requires_grad_(), rgb.clone().requires_grad_()
        w = torch.linspace(-1.0, 1.0, 3 * n_r, device=cuda).reshape(n_r, 3)
        (fn(s, c, ts) * w).sum().backward()
        return s.grad, c.grad

    for a, b in zip(grads(composite_apply), grads(composite_plain)):
        assert ((a - b).abs() <= 1e-4 + 1e-3 * b.abs()).all()


@pytest.mark.cuda
def test_fused_composite_with_no_rays_or_samples(cuda):
    reset_launch_counts()
    out = fused_composite(torch.empty(64, 0, device=cuda), torch.empty(64, 0, 3, device=cuda),
                          torch.linspace(0.0, 2.0, 64, device=cuda))
    assert out.shape == (0, 3) and launch_counts()["fused_composite"] == 0
    out = fused_composite(torch.empty(0, 5, device=cuda), torch.empty(0, 5, 3, device=cuda),
                          torch.empty(0, device=cuda))
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros(5, 3, device=cuda))


@pytest.mark.cuda
def test_nerfle_render_goes_through_k8(cuda):
    from neural_raytracing_tpu_torch.lights import PointLights
    shape = NeRFLE(steps=64)
    shape.reset_parameters(torch.Generator().manual_seed(15))
    lights = PointLights(location=(0.3, 0.9, 1.1)).to(cuda)
    shape.to(cuda)
    g = torch.Generator().manual_seed(16)
    rays = torch.cat([torch.tensor([0.0, 0.0, 1.0]).expand(1, 32, 32, 1, 3),
                      torch.nn.functional.normalize(torch.tensor([0.0, 0.0, -1.0])
                                                    + 0.3 * torch.randn(1, 32, 32, 1, 3,
                                                                        generator=g), dim=-1)],
                     dim=-1).to(cuda)
    reset_launch_counts()
    with torch.no_grad():
        got = shape.volume_render(rays, None, lights)
        assert launch_counts()["fused_composite"] == 1
        shape.fused = "off"
        want = shape.volume_render(rays, None, lights)
        assert launch_counts()["fused_composite"] == 1
    assert (got - want).abs().max() <= 1e-5
    with pytest.raises(ValueError, match="CUDA"):
        volumetric_integrate(torch.rand(4, 8), torch.rand(4, 8, 3), torch.rand(4),
                             fused="force")


@pytest.mark.cuda
@pytest.mark.parametrize("bound", [None, 1.2])
def test_relaxed_fused_march_matches_plain(cuda, bound):
    module = _surface(cuda)
    g = torch.Generator().manual_seed(5)
    r_o = torch.tensor([0.0, 0.0, 2.0]).expand(3001, 3).contiguous()
    r_d = torch.tensor([0.0, 0.0, -1.0]) + 0.3 * torch.randn(3001, 3, generator=g)
    r_o, r_d = r_o.to(cuda), torch.nn.functional.normalize(r_d, dim=-1).to(cuda)
    t0, t1 = (None, 10.0) if bound is None else march_interval(r_o, r_d, bound, 10.0)
    reset_launch_counts()
    depth, hit = fused_march(module, r_o, r_d, t1, max_steps=128, epsilon=1e-3,
                             t_start=t0, omega=1.4)
    assert launch_counts()["fused_march"] == 1
    set_kernel_mode(module, "off")
    pdepth, phit, evals = march_plain(module, r_o, r_d, t1, t0, max_steps=128,
                                      epsilon=1e-3, omega=1.4)
    torch.cuda.synchronize()
    assert phit.float().mean() > 0 and evals.sum() > 0
    assert (hit == phit).float().mean() >= 0.99
    both = hit & phit
    assert (depth - pdepth)[both].abs().max() <= 1e-3


@pytest.mark.cuda
def test_relaxed_fused_march_rules(cuda):
    """The relaxed loop's rules on an exact SDF (the CPU twin, against the JAX
    loop and kernel, is tests/test_torch_relaxed_march.py): a head-on ray
    whose first relaxed step lands inside (fail, step back, omega reset, no
    hit on the failed step: a hit at 1.5 on the 4th evaluation), a ray whose
    first step jumps across the sphere (the overlap test), a ray that starts
    inside (no hit on its one failed step)."""
    eps = 2.0 ** -10
    module = _one_sphere("cpu")
    d = torch.tensor([[0.0, 0.0, -1.0]])
    for origin, steps, want_hit in (((0.0, 0.0, 2.0), 4, True),
                                    ((0.45, 0.0, 2.0), 32, True),
                                    ((0.0, 0.0, 0.2), 1, False)):
        o = torch.tensor([origin])
        want_d, want_h, _ = march_plain(module, o, d, 10.0, max_steps=steps,
                                        epsilon=eps, omega=1.5)
        assert want_h.item() == want_hit
        got_d, got_h = fused_march(_one_sphere(cuda), o.to(cuda), d.to(cuda), 10.0,
                                   max_steps=steps, epsilon=eps, omega=1.5)
        assert got_h.item() == want_hit, origin
        assert abs(got_d.item() - want_d.item()) <= 1e-3, origin


# ---- the bf16-operand variants of K1-K4 ---------------------------------------

BF16 = torch.bfloat16


def test_bf16_variants_raise_on_cpu_tensors_and_switch():
    """On CPU tensors the bf16 wrappers raise; a bf16 net in "auto" takes
    K1-bf16's plain version and an SDF with march_dtype=bf16 the bf16 plain
    loops; no kernel is counted."""
    module = SphereSDF(n=4, mlp=SkipConnMLP(in_size=3, out=1, num_layers=2, hidden_size=8,
                                            freqs=2, activation="softplus"))
    module.reset_parameters(torch.Generator().manual_seed(0))
    mlp = FusedSkipConnMLP(num_layers=2, hidden_size=8, freqs=2, compute_dtype=BF16)
    mlp.reset_parameters(torch.Generator().manual_seed(1))
    x = torch.rand(8, 3, generator=torch.Generator().manual_seed(2))
    reset_launch_counts()
    for call in (lambda: fused_mlp_forward_bf16(mlp, x, mlp.B, mlp.flat_weights()),
                 lambda: fused_march_bf16(module, x, x, 1.0, max_steps=4, epsilon=1e-3),
                 lambda: fused_min_scan_bf16(module, x, x, 0.1, steps=4),
                 lambda: fused_shadow_march_bf16(module, x, x, 1.0, max_steps=4,
                                                 epsilon=1e-3)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="compute dtype"):
        fused_march(module, x, x, 1.0, max_steps=4, epsilon=1e-3,
                    compute_dtype=torch.float16)
    with torch.no_grad():
        assert torch.equal(mlp(x), mlp_forward_bf16_operands(mlp, x, mlp.B,
                                                             mlp.flat_weights()))
        mlp.mode = "off"
        assert torch.equal(mlp(x), SkipConnMLP.forward(mlp, x))
    sdf = SDF(module, max_steps=16, march_dtype=BF16)
    assert sdf.replace(max_steps=8).march_dtype == BF16
    r_o = torch.tensor([0.0, 0.0, 2.0]).expand(8, 3)
    r_d = torch.nn.functional.normalize(torch.tensor([0.0, 0.0, -1.0]) + 0.1 * x, dim=-1)
    want = march_plain(lambda p: sphere_sdf_eval_plain(module, p, BF16), r_o, r_d, 10.0,
                       max_steps=16, epsilon=1e-3)
    got = sdf._march(r_o, r_d, 10.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    off = sdf.replace(fused_loops="off")._march(r_o, r_d, 10.0)
    assert torch.equal(off[0], march_plain(module, r_o, r_d, 10.0, max_steps=16,
                                           epsilon=1e-3)[0])
    with pytest.raises(ValueError, match="compute dtype"):
        SDF(module, march_dtype=torch.float16)
    assert all(v == 0 for v in launch_counts().values())


def _assert_k1_bf16_close(got, want, got_f32, want_f32):
    tol = 1e-4 * want.abs() + 1e-5
    rows_ok = ((got - want).abs() <= tol).all(dim=-1).float().mean().item()
    err = (got - want).abs().mean().item()
    gap = (want - want_f32).abs().mean().item()
    assert rows_ok >= 0.5, rows_ok
    assert err <= 0.25 * gap, (err, gap)
    assert (got - got_f32).abs().mean().item() >= 0.5 * gap   # not silently f32


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLAGSHIP))
def test_fused_mlp_bf16_kernel_matches_plain(cuda, name):
    mlp = _net(FLAGSHIP[name], 0, cuda)
    x = (torch.rand(4099, 3, generator=torch.Generator().manual_seed(1)) - 0.5).to(cuda)
    ws = mlp.flat_weights()
    with torch.no_grad():
        reset_launch_counts()
        got = fused_mlp_forward_bf16(mlp, x, mlp.B, ws)
        assert launch_counts()["fused_mlp_forward_bf16"] == 1
        assert launch_counts()["fused_mlp_forward"] == 0
        got_f32 = fused_mlp_forward(mlp, x, mlp.B, ws)
        want = mlp_forward_bf16_operands(mlp, x, mlp.B, ws)
        want_f32 = SkipConnMLP.forward(mlp, x)
        torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    _assert_k1_bf16_close(got, want, got_f32, want_f32)


@pytest.mark.cuda
def test_bf16_net_goes_through_k1_bf16(cuda):
    cfg = dict(FLAGSHIP["lobe"], compute_dtype=BF16)
    mlp = _net(cfg, 2, cuda)
    x = (torch.rand(512, 3, generator=torch.Generator().manual_seed(3)) - 0.5).to(cuda)
    xx = x.clone().requires_grad_()
    reset_launch_counts()
    out = mlp(xx)
    counts = launch_counts()
    assert counts["fused_mlp_forward_bf16"] == 1 and counts["fused_mlp_forward"] == 0
    # the backward recomputes through the module's own (bf16-encoding) forward
    (gx,) = torch.autograd.grad(out.sum(), xx)
    yy = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(SkipConnMLP.forward(mlp, yy).sum(), yy)
    torch.testing.assert_close(gx, want, rtol=1e-4, atol=1e-4)


def _bf16_sdf(module):
    return lambda p: sphere_sdf_eval_plain(module, p, BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["unbounded", "bounded", "relaxed"])
def test_fused_march_bf16_matches_plain(cuda, mode):
    module = _surface(cuda)
    g = torch.Generator().manual_seed(5)
    r_o = torch.tensor([0.0, 0.0, 2.0]).expand(3001, 3).contiguous()
    r_d = torch.tensor([0.0, 0.0, -1.0]) + 0.3 * torch.randn(3001, 3, generator=g)
    r_o, r_d = r_o.to(cuda), torch.nn.functional.normalize(r_d, dim=-1).to(cuda)
    t0, t1 = (march_interval(r_o, r_d, 1.2, 10.0) if mode == "bounded" else (None, 10.0))
    kw = dict(max_steps=64 if mode == "unbounded" else 256, epsilon=1e-3,
              omega=1.4 if mode == "relaxed" else 1.0)
    reset_launch_counts()
    depth, hit = fused_march_bf16(module, r_o, r_d, t1, t_start=t0, **kw)
    assert launch_counts()["fused_march_bf16"] == 1 and launch_counts()["fused_march"] == 0
    depth32, _ = fused_march(module, r_o, r_d, t1, t_start=t0, **kw)
    pdepth, phit, _ = march_plain(_bf16_sdf(module), r_o, r_d, t1, t0, **kw)
    torch.cuda.synchronize()
    assert phit.float().mean() > 0
    assert (hit == phit).float().mean() >= 0.99
    derr = (depth - pdepth)[hit & phit].abs()
    assert (derr <= 1e-3).float().mean() >= 0.99 and (derr <= 1e-2).float().mean() >= 0.999
    assert (depth - depth32).abs().max() > 1e-5           # not silently f32


def _march_rays(device, n, seed=5):
    g = torch.Generator().manual_seed(seed)
    r_o = torch.tensor([0.0, 0.0, 2.0]).expand(n, 3).contiguous()
    r_d = torch.tensor([0.0, 0.0, -1.0]) + 0.3 * torch.randn(n, 3, generator=g)
    return r_o.to(device), torch.nn.functional.normalize(r_d, dim=-1).to(device)


def _assert_march_close(depth, hit, pdepth, phit, bf16):
    """K2's tolerances (chip_smoke.py): hit agreement >= 99%, |depth
    difference| <= 1e-3 where both hit; K2-bf16's: the depths within 1e-3 on
    99% and within 1e-2 on 99.9% of the common hits."""
    assert (hit == phit).float().mean() >= 0.99
    derr = (depth - pdepth)[hit & phit].abs()
    if bf16:
        assert (derr <= 1e-3).float().mean() >= 0.99 and (derr <= 1e-2).float().mean() >= 0.999
    else:
        assert derr.numel() == 0 or derr.max() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [0, 1, 127, 129, 16_384])
def test_fused_march_ray_counts(cuda, n, dtype):
    """K2 and K2-bf16 around one block's 128 slots and at an eval tile's
    16,384 rays (fewer rays than the card's slots), bounded, 256 steps."""
    bf16 = dtype == BF16
    module = _surface(cuda)
    r_o, r_d = _march_rays(cuda, n)
    t0, t1 = march_interval(r_o, r_d, 1.2, 10.0)
    name = "fused_march_bf16" if bf16 else "fused_march"
    reset_launch_counts()
    depth, hit = fused_march(module, r_o, r_d, t1, max_steps=256, epsilon=1e-3, t_start=t0,
                             compute_dtype=dtype)
    counts = launch_counts()
    # and one pack of the new module's shift net, which the next launches reuse
    assert counts[name] == (1 if n else 0) and counts["pack_tile_weights"] == 1
    assert sum(counts.values()) == counts[name] + 1
    set_kernel_mode(module, "off")
    sdf = _bf16_sdf(module) if bf16 else module
    pdepth, phit, _ = march_plain(sdf, r_o, r_d, t1, t0, max_steps=256, epsilon=1e-3)
    torch.cuda.synchronize()
    assert depth.shape == hit.shape == (n,) and hit.dtype == torch.bool
    if n:
        assert phit.any() or n == 1
        _assert_march_close(depth, hit, pdepth, phit, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_fused_march_rays_that_never_step(cuda, dtype):
    """max_steps = 0 leaves every ray at its start, not hit; a ray whose
    t_start >= max_t resolves at once at t_start, between rays that march."""
    module = _surface(cuda)
    r_o, r_d = _march_rays(cuda, 3001)
    t0, t1 = march_interval(r_o, r_d, 1.2, 10.0)
    kw = dict(epsilon=1e-3, compute_dtype=dtype)
    depth, hit = fused_march(module, r_o, r_d, t1, max_steps=0, t_start=t0, **kw)
    assert torch.equal(depth, t0) and not hit.any()
    depth, hit = fused_march(module, r_o, r_d, 10.0, max_steps=0, **kw)
    assert not depth.any() and not hit.any()
    t0 = t0.clone()
    t0[::3] = t1[::3] + 0.25
    depth, hit = fused_march(module, r_o, r_d, t1, max_steps=256, t_start=t0, **kw)
    assert torch.equal(depth[::3], t0[::3]) and not hit[::3].any()
    set_kernel_mode(module, "off")
    sdf = _bf16_sdf(module) if dtype == BF16 else module
    pdepth, phit, _ = march_plain(sdf, r_o, r_d, t1, t0, max_steps=256, epsilon=1e-3)
    torch.cuda.synchronize()
    assert phit.any()
    _assert_march_close(depth, hit, pdepth, phit, dtype == BF16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("omega", [1.0, 1.4])
@pytest.mark.parametrize("bound", [None, 1.2])
def test_fused_march_results_depend_on_the_ray_alone(cuda, bound, omega, dtype):
    """A ray's depth and hit come from its own evaluations only: the same
    bit for bit in a second launch and under a random permutation of the
    rays (another slot, block and start step), with one block or the
    planned grid; the launch statistics count every evaluation once."""
    module = _surface(cuda)
    n = 20_001
    r_o, r_d = _march_rays(cuda, n)
    t0, t1 = (None, 10.0) if bound is None else march_interval(r_o, r_d, bound, 10.0)
    kw = dict(max_steps=128, epsilon=1e-3, omega=omega, compute_dtype=dtype)

    def run(p, stats=None):
        return fused_march(module, r_o[p].contiguous(), r_d[p].contiguous(),
                           t1 if t0 is None else t1[p].contiguous(),
                           t_start=None if t0 is None else t0[p].contiguous(), stats=stats, **kw)

    every = torch.arange(n, device=cuda)
    stats = torch.zeros(3, dtype=torch.int64, device=cuda)
    depth, hit = run(every, stats)
    again = run(every)
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(8)).to(cuda)
    shuffled = run(perm)
    fm = sys.modules["neural_raytracing_tpu_torch.kernels.fused_march"]
    plan, fm.march_plan = fm.march_plan, lambda *a: 1
    try:
        one_block = run(perm)
    finally:
        fm.march_plan = plan
    torch.cuda.synchronize()
    assert hit.any()
    for d, h in (again, (shuffled[0][perm.argsort()], shuffled[1][perm.argsort()]),
                 (one_block[0][perm.argsort()], one_block[1][perm.argsort()])):
        assert torch.equal(d, depth) and torch.equal(h, hit)
    steps, rows, live = stats.tolist()
    set_kernel_mode(module, "off")
    sdf = _bf16_sdf(module) if dtype == BF16 else module
    evals = march_plain(sdf, r_o, r_d, t1, t0, max_steps=128, epsilon=1e-3, omega=omega)[2]
    assert 0 < live <= rows <= 128 * steps
    assert abs(live - int(evals.sum())) <= 0.01 * int(evals.sum())


@pytest.mark.cuda
def test_fused_march_occupancy(cuda):
    """K2 and K2-bf16 for the flagship shift: 128 slots, and the block fits
    twice on an SM (the launch takes one a SM)."""
    module = _surface(cuda)
    for dtype in (torch.float32, BF16):
        info = march_info(module, dtype)
        assert info["slots"] == 128 and info["blocks_per_sm"] == 2, info


@pytest.mark.cuda
@pytest.mark.parametrize("past_light_exit", [True, False])
def test_fused_shadow_march_bf16_matches_plain(cuda, past_light_exit):
    module = _surface(cuda)
    r_o, r_d, dist = _shadow_rays(cuda, n=20_001)
    reset_launch_counts()
    nb = fused_shadow_march_bf16(module, r_o, r_d, dist, max_steps=64, epsilon=1e-3,
                                 past_light_exit=past_light_exit)
    assert launch_counts()["fused_shadow_march_bf16"] == 1
    pnb, _ = shadow_march_plain(_bf16_sdf(module), r_o, r_d, dist, max_steps=64,
                                epsilon=1e-3, past_light_exit=past_light_exit)
    torch.cuda.synchronize()
    assert 0.0 < pnb.float().mean().item() < 1.0
    assert (nb == pnb).float().mean() >= 0.999


@pytest.mark.cuda
def test_fused_shadow_march_bf16_is_not_f32(cuda):
    """A ray that starts inside the surface hits on its one step and
    advances to 1e2 eps + sd(p): with max_t 1e-5 short of the float32 value
    the f32 kernel says not-blocked, and K4-bf16, whose SDF carries the bf16
    noise of the shift, says blocked on some rays (chip_smoke.py's probe)."""
    module = _surface(cuda)
    g = torch.Generator().manual_seed(17)
    p = (0.6 * torch.rand(20_000, 3, generator=g) - 0.3).to(cuda)
    d = torch.nn.functional.normalize(torch.randn(20_000, 3, generator=g), dim=-1).to(cuda)
    sd = sphere_sdf_eval_plain(module, p)
    inside = sd < 1e-3 - 1e-4
    p, d, sd = p[inside], d[inside], sd[inside]
    r_o, max_t = (p - d * 0.1).contiguous(), 0.1 + sd - 1e-5
    kw = dict(max_steps=1, epsilon=1e-3, past_light_exit=False)
    nb32 = fused_shadow_march(module, r_o, d, max_t, **kw)
    nb = fused_shadow_march_bf16(module, r_o, d, max_t, **kw)
    assert p.shape[0] > 1000 and nb32.all()
    assert (~nb).any()


@pytest.mark.cuda
def test_bf16_sdf_goes_through_the_bf16_kernels(cuda):
    sdf = SDF(_surface(cuda), max_steps=64, march_bound=1.2, march_dtype=BF16)
    r_o, r_d, dist = _shadow_rays(cuda, n=512)
    cam = torch.cat([torch.tensor([0.0, 0.0, 2.0]).expand(256, 3),
                     torch.nn.functional.normalize(
                         torch.tensor([0.0, 0.0, -1.0]) + 0.2 * torch.randn(
                             256, 3, generator=torch.Generator().manual_seed(6)),
                         dim=-1)], dim=-1).to(cuda)
    reset_launch_counts()
    with torch.no_grad():
        it, hit = sdf.intersect(cam, primary=True)
        sdf.intersect_test(torch.cat([r_o, r_d], dim=-1), max_t=dist)
    counts = launch_counts()
    assert hit.any() and torch.isfinite(it.throughput).all()
    for name in ("fused_march", "fused_min_scan", "fused_shadow_march"):
        assert counts[name + "_bf16"] == 1 and counts[name] == 0, name


# ---- K1 on the tiles (csrc/fused_mlp_tile.cu) ---------------------------------------

# the rows the main paths launch K1 at (a flagship eval tile, a training
# step, a NeRV eval chunk and training step), one row, none and a ragged count
K1_ROWS = (16_384, 38_400, 10_000, 12_288, 0, 1, 4_099)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(FLAGSHIP))
def test_k1_tile_matches_plain_at_the_path_rows(cuda, name, dtype):
    """The tile against the plain version at each row count, on the tile
    route, 64 rows a block; the float32 outputs the first kernel's bits; a
    row's outputs the same whatever the launch it is in."""
    mlp = _net(FLAGSHIP[name], 0, cuda)
    x = (torch.rand(38_400, 3, generator=torch.Generator().manual_seed(1)) - 0.5).to(cuda)
    ws = mlp.flat_weights()
    assert tile_info(mlp, dtype)["rows"] == 64
    with torch.no_grad():
        big = fused_mlp_forward(mlp, x, mlp.B, ws, dtype)
        if dtype == torch.float32:
            want = SkipConnMLP.forward(mlp, x)
            tol = 1e-4 * want.abs() + 1e-5 + 4e-7 * (x @ mlp.B).abs().max()
            assert ((big - want).abs() <= tol).all(), (big - want).abs().max().item()
            assert torch.equal(big, fused_mlp_forward(mlp, x, mlp.B, ws, route="general"))
        else:
            _assert_k1_bf16_close(big, mlp_forward_bf16_operands(mlp, x, mlp.B, ws),
                                  fused_mlp_forward(mlp, x, mlp.B, ws),
                                  SkipConnMLP.forward(mlp, x))
        for n in K1_ROWS:
            xs = x[:n].contiguous()
            reset_launch_counts()
            got = fused_mlp_forward(mlp, xs, mlp.B, ws, dtype)
            assert got.shape == (n, mlp.out_size)
            assert torch.equal(got, big[:n]), n
            name_ = "fused_mlp_forward_bf16" if dtype == BF16 else "fused_mlp_forward"
            assert launch_counts()[name_] == (1 if n > 0 else 0)
            assert route_counts()[name_] == {"tile": 1 if n > 0 else 0, "general": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_k1_tile_same_bits_under_a_permutation(cuda, dtype):
    mlp = _net(FLAGSHIP["weight_net"], 3, cuda)
    g = torch.Generator().manual_seed(4)
    x = (torch.rand(10_000, 3, generator=g) - 0.5).to(cuda)
    perm = torch.randperm(10_000, generator=g).to(cuda)
    with torch.no_grad():
        out = fused_mlp_forward(mlp, x, mlp.B, mlp.flat_weights(), dtype)
        out_p = fused_mlp_forward(mlp, x[perm].contiguous(), mlp.B, mlp.flat_weights(), dtype)
    assert torch.equal(out[perm], out_p)


@pytest.mark.cuda
def test_k1_bf16_tile_follows_k1s_rounding(cuda):
    """The tile's bf16 rows are K1's function (the skip layers read act() of
    the float32 encoding, rounded), not the march kernels' (act() of the
    rounded encoding)."""
    mlp = _net(FLAGSHIP["lobe"], 5, cuda)
    x = (torch.rand(8_192, 3, generator=torch.Generator().manual_seed(6)) - 0.5).to(cuda)
    ws = mlp.flat_weights()
    with torch.no_grad():
        got = fused_mlp_forward_bf16(mlp, x, mlp.B, ws)
        k1 = mlp_forward_bf16_operands(mlp, x, mlp.B, ws)
        march = mlp_forward_bf16_operands(mlp, x, mlp.B, ws, act_of_rounded_enc=True)
    tol = lambda want: 1e-4 * want.abs() + 1e-5
    near_k1 = ((got - k1).abs() <= tol(k1)).all(dim=-1).float().mean().item()
    near_march = ((got - march).abs() <= tol(march)).all(dim=-1).float().mean().item()
    # (on an H100: 0.992 of the rows within tolerance of K1's rounding, 0.60
    # of the march's)
    assert near_k1 >= 0.9 and near_march <= near_k1 - 0.2, (near_k1, near_march)
    assert (got - k1).abs().mean() < 0.5 * (got - march).abs().mean()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(FLAGSHIP))
def test_pack_kernel_matches_the_plain_pack(cuda, name, dtype):
    mlp = _net(FLAGSHIP[name], 7, cuda)
    reset_launch_counts()
    got = pack_tile_weights(mlp, mlp.B, mlp.flat_weights(), dtype)
    want = tile_pack_plain(mlp, mlp.B, mlp.flat_weights(), dtype)
    torch.cuda.synchronize()
    assert launch_counts()["pack_tile_weights"] == 1
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
def test_pack_is_refreshed_after_an_adamw_step(cuda):
    """The optimizer training/optim.py builds updates the weights in place,
    which moves their versions: the next forward packs again and computes
    with the new weights."""
    from neural_raytracing_tpu_torch.training import make_optimizer
    mlp = _net(FLAGSHIP["lobe"], 8, cuda)
    x = (torch.rand(4_096, 3, generator=torch.Generator().manual_seed(9)) - 0.5).to(cuda)
    opt = make_optimizer({}, default_lr=1e-2).init(torch.nn.ModuleDict({"net": mlp}))
    reset_launch_counts()
    with torch.no_grad():
        before = fused_mlp_forward(mlp, x, mlp.B, mlp.flat_weights())
        fused_mlp_forward(mlp, x, mlp.B, mlp.flat_weights())
    assert launch_counts()["pack_tile_weights"] == 1
    packed = [t.clone() for t in tile_pack(mlp, mlp.B, mlp.flat_weights())]
    versions = [w._version for w in mlp.flat_weights()]
    fused_mlp_apply(mlp, x).square().mean().backward()
    opt.step()
    assert all(w._version > v for w, v in zip(mlp.flat_weights(), versions))
    with torch.no_grad():
        after = fused_mlp_forward(mlp, x, mlp.B, mlp.flat_weights())
        want = SkipConnMLP.forward(mlp, x)
    assert launch_counts()["pack_tile_weights"] == 2
    repacked = tile_pack(mlp, mlp.B, mlp.flat_weights())
    assert not all(torch.equal(a, b) for a, b in zip(repacked, packed))
    assert all(torch.equal(a, b) for a, b in zip(
        repacked, tile_pack_plain(mlp, mlp.B, mlp.flat_weights())))
    assert not torch.equal(after, before)
    tol = 1e-4 * want.abs() + 1e-5 + 4e-7 * (x @ mlp.B).abs().max()
    assert ((after - want).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_net_off_the_tile_runs_the_first_kernel(cuda, dtype):
    mlp = _net(dict(in_size=5, out=2, num_layers=3, hidden_size=512, freqs=16), 10, cuda)
    x = (torch.rand(3_001, 5, generator=torch.Generator().manual_seed(11)) - 0.5).to(cuda)
    ws = mlp.flat_weights()
    reset_launch_counts()
    with torch.no_grad():
        got = fused_mlp_forward(mlp, x, mlp.B, ws, dtype)
        name = "fused_mlp_forward_bf16" if dtype == BF16 else "fused_mlp_forward"
        assert route_counts()[name] == {"tile": 0, "general": 1}
        assert launch_counts()["pack_tile_weights"] == 0
        if dtype == torch.float32:
            want = SkipConnMLP.forward(mlp, x)
            tol = 1e-4 * want.abs() + 1e-5 + 4e-7 * (x @ mlp.B).abs().max()
            assert ((got - want).abs() <= tol).all()
        else:
            _assert_k1_bf16_close(got, mlp_forward_bf16_operands(mlp, x, mlp.B, ws),
                                  fused_mlp_forward(mlp, x, mlp.B, ws),
                                  SkipConnMLP.forward(mlp, x))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_k1_tile_checks_the_weights_against_the_inputs_device(cuda, dtype):
    """A net on the CPU with inputs on the card is refused with a
    ValueError before anything is packed or launched, also after the net
    was packed on the card and moved back (a cache entry for it exists)."""
    mlp = _net(FLAGSHIP["lobe"], 12, "cpu")
    x = (torch.rand(256, 3, generator=torch.Generator().manual_seed(13)) - 0.5).to(cuda)
    reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_forward(mlp, x, mlp.B, mlp.flat_weights(), dtype)
    assert all(v == 0 for v in launch_counts().values())
    mlp.to(cuda)
    with torch.no_grad():
        fused_mlp_forward(mlp, x, mlp.B, mlp.flat_weights(), dtype)
    mlp.cpu()
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_forward(mlp, x, mlp.B, mlp.flat_weights(), dtype)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_first_kernel_refuses_a_net_past_its_shared_memory(cuda):
    """The first kernel's C entry refuses a net whose rows do not fit a
    block's shared memory; the wrapper raises from its code, counts
    nothing, and the next launch is not affected."""
    mlp = _net(dict(in_size=5, out=1, num_layers=2, hidden_size=1024, freqs=16), 14, cuda)
    x = torch.zeros(64, 5, device=cuda)
    reset_launch_counts()
    with torch.no_grad(), pytest.raises(RuntimeError, match="CUDA error"):
        fused_mlp_forward(mlp, x, mlp.B, mlp.flat_weights())
    assert all(v == 0 for v in launch_counts().values())
    small = _net(FLAGSHIP["lobe"], 15, cuda)
    with torch.no_grad():
        out = fused_mlp_forward(small, x[:, :3].contiguous(), small.B, small.flat_weights())
    assert torch.isfinite(out).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
def test_march_kernels_share_k1s_cached_pack(cuda, dtype):
    """K2, K3 and K4 read the shift net through K1's pack cache: the net is
    packed once per operand type and weight version, whichever kernel reads
    it first, and again after an in-place update."""
    module = _surface(cuda)
    mlp = module.shift
    r_o, r_d, dist = _shadow_rays(cuda, n=512)
    x = (torch.rand(512, 3, generator=torch.Generator().manual_seed(16)) - 0.5).to(cuda)
    reset_launch_counts()
    with torch.no_grad():
        fused_march(module, r_o, r_d, 4.0, max_steps=16, epsilon=1e-3, compute_dtype=dtype)
        fused_min_scan(module, r_o, r_d, 0.05, steps=8, compute_dtype=dtype)
        fused_shadow_march(module, r_o, r_d, dist, max_steps=16, epsilon=1e-3,
                           compute_dtype=dtype)
        fused_mlp_forward(mlp, x, mlp.B, mlp.flat_weights(), dtype)
        assert launch_counts()["pack_tile_weights"] == 1
        mlp.out.b.add_(0.01)
        fused_march(module, r_o, r_d, 4.0, max_steps=16, epsilon=1e-3, compute_dtype=dtype)
        fused_mlp_forward(mlp, x, mlp.B, mlp.flat_weights(), dtype)
    assert launch_counts()["pack_tile_weights"] == 2
    assert all(torch.equal(a, b) for a, b in zip(
        tile_pack(mlp, mlp.B, mlp.flat_weights(), dtype),
        tile_pack_plain(mlp, mlp.B, mlp.flat_weights(), dtype)))


@pytest.mark.cuda
def test_tie_forms_on_the_card(cuda):
    """The port's tie forms (leaky_relu's slope 1 at 0, jnp.maximum's,
    jnp.clip's and jnp.abs's gradients; tests/test_torch_ties.py holds them
    against JAX on the CPU) on CUDA tensors: their values torch's own forms'
    there, bit for bit, and their first and second derivatives the CPU's
    (torch's clamp gives clamp(-0.0, 0.0) = +0.0 on the card and -0.0 on
    the CPU, so the signs of zeros are not compared across devices)."""
    import torch.nn.functional as F
    from neural_raytracing_tpu_torch.nn import ACTIVATIONS
    from neural_raytracing_tpu_torch.ops.math import absolute, clip, maximum
    xs = torch.tensor([-2.5, -1.0, -1e-30, -0.0, 0.0, 1e-30, 1e-12, 0.5, 1.0, 2.0])
    forms = [(ACTIVATIONS["leaky_relu"], lambda x: F.leaky_relu(x, 0.01)),
             (absolute, torch.abs),
             (lambda x: maximum(x, 0.0), lambda x: torch.clamp_min(x, 0.0)),
             (lambda x: maximum(x, 1e-12), lambda x: torch.clamp_min(x, 1e-12)),
             (lambda x: clip(x, 1e-12, 1.0), lambda x: torch.clamp(x, 1e-12, 1.0))]

    def run(form, device):
        x = xs.clone().to(device).requires_grad_()
        y = form(x)
        (g1,) = torch.autograd.grad((y * y).sum(), x, create_graph=True)
        (g2,) = torch.autograd.grad(g1.sum(), x)
        return [t.detach().cpu() for t in (y, g1, g2)]

    for form, own in forms:
        got = run(form, cuda)
        want = own(xs.to(cuda)).cpu()
        assert torch.equal(got[0].view(torch.int32), want.view(torch.int32)), (got[0], want)
        for a, b in zip(got, run(form, "cpu")):
            assert torch.equal(a, b), (a, b)


# ---- K6 and K7 on the tile (csrc/fused_mlp_bwd_tile.cu) -----------------------------

BWD_NETS = ("weight_net", "lobe", "light_field")   # the shading nets: the three widths


def _assert_backward_close(dx, grads, want):
    """chip_smoke phase 6's criterion against ``want`` = (dx, *grads) of a
    plain version: a pre-activation within rounding of a leaky_relu kink
    takes the other slope in one of the two sum orders, which moves that
    row's dx by O(1); so dx is held row by row (within 1e-4 of max|plain|
    on all but 0.1% of the rows) and each dW/db over the rows (relative L2
    <= 1e-3)."""
    row_err = (dx - want[0]).abs().max(dim=-1).values
    off = int((row_err > 1e-4 * want[0].abs().max()).sum().item())
    assert off <= 1e-3 * dx.shape[0], (off, row_err.max().item())
    assert len(grads) + 1 == len(want)
    for i, (a, b) in enumerate(zip(grads, want[1:])):
        rel = ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
        assert rel <= 1e-3, (i, rel)


def _bwd_inputs(mlp, n, device, seed=21):
    gen = torch.Generator().manual_seed(seed)
    x = (torch.rand(n, 3, generator=gen) - 0.5).to(device)
    return x, torch.randn(n, mlp.out_size, generator=gen).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [0, 4])
@pytest.mark.parametrize("n", [1, 63, 65, 4_099])
@pytest.mark.parametrize("name", BWD_NETS)
def test_tile_backward_matches_plain(cuda, name, n, segments):
    """K6 (segments 0) and K7 (segments 4) on the tile at edge row counts and
    the three widths against their plain versions (``act'`` of the JAX
    package's ACTIVATION_GRADS) and against torch's autograd through the
    plain net (whose leaky_relu takes JAX's slope 1 at 0 too); every launch
    on the tile route."""
    mlp = _net(FLAGSHIP[name], 22, cuda)
    x, g = _bwd_inputs(mlp, n, cuda)
    reset_launch_counts()
    dx, grads = mlp_backward(mlp, x, g, mlp.B, mlp.flat_weights(), segments)
    routes = route_counts()
    n_seg = min(segments, mlp.num_layers)
    want_launches = ({"fused_mlp_ckpt_forward": 1, "fused_mlp_segment_backward": n_seg}
                     if segments else {"fused_mlp_backward": 1})
    for kernel, count in want_launches.items():
        assert routes[kernel] == {"tile": count, "general": 0}, routes
    want = mlp_backward(mlp, x, g, mlp.B, mlp.flat_weights(), segments, kernel=False)
    auto = _autograd_backward(mlp, x, g)
    torch.cuda.synchronize()
    _assert_backward_close(dx, grads, [want[0], *want[1]])
    _assert_backward_close(dx, grads, auto)


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [0, 4])
def test_tile_backward_gives_the_same_bits_twice(cuda, segments):
    """The dW rows split into the fixed slices of dw_plan, added in slice
    order: two launches on the same inputs give the same bits (dx too)."""
    mlp = _net(FLAGSHIP["weight_net"], 23, cuda)
    x, g = _bwd_inputs(mlp, 4_099, cuda)
    first = mlp_backward(mlp, x, g, mlp.B, mlp.flat_weights(), segments)
    second = mlp_backward(mlp, x, g, mlp.B, mlp.flat_weights(), segments)
    torch.cuda.synchronize()
    for a, b in zip([first[0], *first[1]], [second[0], *second[1]]):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [0, 2])
def test_backward_off_the_tile_takes_the_general_kernels(cuda, segments):
    mlp = _net(dict(in_size=5, out=2, num_layers=4, hidden_size=64, freqs=8), 24, cuda)
    gen = torch.Generator().manual_seed(25)
    x = (torch.rand(777, 5, generator=gen) - 0.5).to(cuda)
    g = torch.randn(777, 2, generator=gen).to(cuda)
    reset_launch_counts()
    dx, grads = mlp_backward(mlp, x, g, mlp.B, mlp.flat_weights(), segments)
    routes = route_counts()
    kernel = "fused_mlp_segment_backward" if segments else "fused_mlp_backward"
    assert routes[kernel]["tile"] == 0 and routes[kernel]["general"] > 0, routes
    assert launch_counts()["pack_tile_transposes"] == 0
    want = mlp_backward(mlp, x, g, mlp.B, mlp.flat_weights(), segments, kernel=False)
    auto = _autograd_backward(mlp, x, g)
    torch.cuda.synchronize()
    _assert_backward_close(dx, grads, [want[0], *want[1]])
    _assert_backward_close(dx, grads, auto)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLAGSHIP))
def test_transpose_pack_kernel_matches_the_plain_pack(cuda, name):
    mlp = _net(FLAGSHIP[name], 26, cuda)
    got = pack_tile_transposes(mlp, mlp.flat_weights())
    want = tile_transposes_plain(mlp, mlp.flat_weights())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [0, 2])
def test_kernel_bwd_repacks_after_an_optimizer_step(cuda, segments):
    """kernel_bwd through autograd: the transposed pack once per weight
    version, again after AdamW's in-place update, and the gradients of the
    new weights."""
    from neural_raytracing_tpu_torch.training import make_optimizer
    kmlp = FusedSkipConnMLP(kernel_bwd=True, kernel_bwd_segments=segments,
                            **FLAGSHIP["light_field"])
    kmlp.reset_parameters(torch.Generator().manual_seed(27))
    kmlp.to(cuda)
    opt = make_optimizer({}, default_lr=1e-2).init(torch.nn.ModuleDict({"net": kmlp}))
    x = (torch.rand(2_049, 3, generator=torch.Generator().manual_seed(28)) - 0.5).to(cuda)
    reset_launch_counts()
    for step in range(2):
        xx = x.clone().requires_grad_()
        kmlp(xx).square().sum().backward()
        assert launch_counts()["pack_tile_transposes"] == step + 1
        got = [xx.grad] + [w.grad.clone() for w in kmlp.flat_weights()]
        with torch.no_grad():
            g = 2 * SkipConnMLP.forward(kmlp, x)
        want = mlp_backward(kmlp, x, g, kmlp.B, kmlp.flat_weights(), segments, kernel=False)
        _assert_backward_close(got[0], got[1:], [want[0], *want[1]])
        opt.step()
        opt.zero_grad()
    routes = route_counts()
    kernel = "fused_mlp_backward" if segments < 2 else "fused_mlp_segment_backward"
    assert routes[kernel]["general"] == 0 and routes[kernel]["tile"] > 0


@pytest.mark.cuda
def test_tile_backward_checks_the_weights_against_the_inputs_device(cuda):
    mlp = _net(FLAGSHIP["lobe"], 29, "cpu")
    x, g = _bwd_inputs(mlp, 256, cuda)
    reset_launch_counts()
    for segments in (0, 4):
        with pytest.raises(ValueError, match="CUDA"):
            mlp_backward(mlp, x, g, mlp.B, mlp.flat_weights(), segments)
    assert all(v == 0 for v in launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("name", BWD_NETS)
def test_tile_backward_kernels_fit(cuda, name):
    """The library's report: the chain kernel and the store forward take a
    block a SM at least, the dW kernel two."""
    info = tile_bwd_info(_net(FLAGSHIP[name], 30, cuda))
    assert info["chain"]["blocks_per_sm"] >= 1 and info["store_forward"]["blocks_per_sm"] >= 1
    assert info["dw"]["blocks_per_sm"] >= 2


@pytest.mark.cuda
@pytest.mark.parametrize("segments", [0, 4])
@pytest.mark.parametrize("route", ["tile", "general"])
def test_backward_with_no_rows(cuda, route, segments):
    """No rows, on either route: dx is empty, every dW/db zero in its
    shape, and no launch of K6 or K7 is counted."""
    cfg = (FLAGSHIP["weight_net"] if route == "tile"
           else dict(in_size=5, out=2, num_layers=4, hidden_size=64, freqs=8))
    mlp = _net(cfg, 31, cuda)
    x = torch.zeros(0, mlp.in_size, device=cuda)
    g = torch.zeros(0, mlp.out_size, device=cuda)
    reset_launch_counts()
    dx, grads = mlp_backward(mlp, x, g, mlp.B, mlp.flat_weights(), segments)
    torch.cuda.synchronize()
    assert dx.shape == (0, mlp.in_size)
    assert [tuple(t.shape) for t in grads] == [tuple(w.shape) for w in mlp.flat_weights()]
    assert all(not t.any() for t in grads)
    counts = launch_counts()
    assert all(counts[k] == 0 for k in ("fused_mlp_backward", "fused_mlp_ckpt_forward",
                                         "fused_mlp_segment_backward"))
