"""K3's packed shift-net layout (``tile_pack_plain``, the layout K1's tile
reads too) on the CPU.

The kernels of ``csrc/fused_minscan.cu`` read the shift net only through
the packed arrays.  A plain forward that reads nothing else, through the
layout ``tile_layout`` documents, must give the SphereSDF of
``sphere_sdf_eval_plain(module, p, dtype)`` in both operand modes, for the
flagship 8 x 128 net, a net whose widths need padding and a net wider than
128 (the 256-wide layout); the padded entries must be zero; and widths past
K3's limits must raise before anything about devices.  The split of each
ray's samples into segments (``min_scan_segments``, ``min_scan_plan``) is
held at the flagship's shapes.

Tolerances: float32 rtol 1e-5 / atol 1e-6 (the padded products add exact
zeros, but the matmuls sum in another order); bf16 the same on 99% of the
points (a float32 difference can tip the bf16 rounding of one activation,
which moves that point's output by one bf16 step).
"""

import sys
import types

import pytest
import torch

from neural_raytracing_tpu_torch.kernels import (
    MIN_SCAN_LIMITS, f32_column_order, fused_min_scan, fused_min_scan_bf16,
    min_scan_plan, min_scan_segments, sphere_sdf_eval_plain, tile_pack_plain, tile_widths,
)
from neural_raytracing_tpu_torch.kernels.fused_march import MIN_SCAN_MAX_SEGMENTS
from neural_raytracing_tpu_torch.kernels.fused_sdf import sphere_min_plain
from neural_raytracing_tpu_torch.nn import SkipConnMLP
from neural_raytracing_tpu_torch.nn.mlp import ACTIVATIONS
from neural_raytracing_tpu_torch.ops.encoding import fourier_encode
from neural_raytracing_tpu_torch.shapes import SphereSDF

torch.set_num_threads(1)
BF16 = torch.bfloat16
SHIFTS = {
    "flagship": dict(in_size=3, out=1, num_layers=8, hidden_size=128, freqs=32,
                     activation="softplus", init="uniform"),
    "padded": dict(in_size=3, out=1, num_layers=5, hidden_size=72, freqs=20, skip=2,
                   activation="leaky_relu", init="uniform"),
    "wide": dict(in_size=3, out=1, num_layers=3, hidden_size=160, freqs=8,
                 activation="softplus", init="uniform"),
}


def _surface(cfg, n=16, seed=0):
    module = SphereSDF(n=n, mlp=SkipConnMLP(**cfg))
    module.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        module.shift.out.w.mul_(0.3)
        module.radii.copy_(0.3 + 0.5 * module.radii)
    return module


def _points(n=512, seed=1):
    return 2.0 * torch.rand(n, 3, generator=torch.Generator().manual_seed(seed)) - 1.0


def _bf16(t):
    return t.to(BF16).float()


def packed_shift(packed, cfg, p, dtype):
    """The shift net from the packed arrays alone, through the documented
    layout: an activation buffer with h at [0, NP) and the encoding at
    [NP, NP + EP); every matrix read back to logical [K, NP] columns."""
    bf16 = dtype == BF16
    act = ACTIVATIONS[cfg["activation"]]
    rnd = _bf16 if bf16 else (lambda t: t)
    mats, biases = packed[1:-2:2], packed[2:-2:2]
    NP = biases[0].shape[0]

    def weights(l):
        w = mats[l]
        if bf16:
            return w.float().t()
        logical = torch.empty_like(w)
        logical[:, f32_column_order(NP)] = w
        return logical

    enc = fourier_encode(p, packed[0])
    E, EP = enc.shape[-1], weights(0).shape[0]
    buf = torch.zeros(p.shape[0], NP + EP)
    buf[:, NP:NP + E] = rnd(enc)
    h = rnd(act(buf[:, NP:] @ weights(0) + biases[0]))
    buf[:, NP:NP + E] = rnd(act(buf[:, NP:NP + E]))
    buf[:, :NP] = h
    L, skip = cfg["num_layers"], cfg.get("skip", 3)
    for i in range(L):
        k = NP + EP if (i % skip == 0 and i != L - 1) else NP
        buf[:, :NP] = rnd(act(buf[:, :k] @ weights(1 + i) + biases[1 + i]))
    return buf[:, :NP] @ packed[-2][0] + packed[-1]


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("net", sorted(SHIFTS))
def test_packed_layout_gives_the_plain_sdf(net, dtype):
    cfg = SHIFTS[net]
    module = _surface(cfg)
    p = _points()
    mlp = module.shift
    packed = tile_pack_plain(mlp, mlp.B, mlp.flat_weights(), dtype)
    with torch.no_grad():
        got = sphere_min_plain(module, p, module.centers, module.radii, module.tfs) \
            + packed_shift(packed, cfg, p, dtype)
        want = sphere_sdf_eval_plain(module, p, dtype)
    close = (got - want).abs() <= 1e-5 * want.abs() + 1e-6
    assert close.float().mean() >= (0.99 if dtype == BF16 else 1.0), \
        (got - want).abs().max().item()
    # the shift is not zero: the layout is exercised
    assert (want - sphere_min_plain(module, p, module.centers, module.radii,
                                    module.tfs)).abs().max() > 1e-3


@pytest.mark.parametrize("dtype", [torch.float32, BF16], ids=["f32", "bf16"])
@pytest.mark.parametrize("net", sorted(SHIFTS))
def test_packed_weights_in_place_and_padding_zero(net, dtype):
    mlp = _surface(SHIFTS[net]).shift
    packed = tile_pack_plain(mlp, mlp.B, mlp.flat_weights(), dtype)
    NP, EP = tile_widths(mlp, dtype)
    H, E = mlp.hidden_size, mlp.enc_size
    assert NP == (128 if H <= 128 else 256) and EP >= E
    assert EP % (16 if dtype == BF16 else 8) == 0
    assert len(packed) == 2 * mlp.num_layers + 5
    ws = mlp.flat_weights()
    rnd = _bf16 if dtype == BF16 else (lambda t: t)
    for l in range(mlp.num_layers + 1):
        w = packed[1 + 2 * l]
        if dtype == BF16:
            assert w.dtype == BF16
            w = w.float().t()
        else:
            assert w.dtype == torch.float32
            logical = torch.empty_like(w)
            logical[:, f32_column_order(NP)] = w
            w = logical
        want = torch.zeros_like(w)
        src = ws[2 * l].detach()
        if l == 0:
            want[:E, :H] = src
        else:
            want[:H, :H] = src[:H]
            if mlp.is_skip_layer(l - 1):
                want[NP:NP + E, :H] = src[H:]
        assert torch.equal(w, rnd(want)), l
        b = packed[2 + 2 * l]
        assert torch.equal(b[:H], ws[2 * l + 1].detach()) and not b[H:].any()
    assert packed[-2].shape == (1, NP)
    assert torch.equal(packed[-2][0, :H], rnd(ws[-2].detach()[:, 0]))
    assert not packed[-2][0, H:].any() and torch.equal(packed[-1], ws[-1].detach())
    # the column order is a permutation
    assert torch.equal(torch.sort(f32_column_order(NP)).values, torch.arange(NP))


@pytest.mark.parametrize("name,limit", sorted(MIN_SCAN_LIMITS.items()))
def test_min_scan_width_check_raises_before_the_device(name, limit):
    cfg = dict(in_size=3, out=1, num_layers=2, hidden_size=8, freqs=2)
    n = 4
    if name == "spheres":
        n = limit + 1
    else:
        cfg[name] = limit + 1
    module = SphereSDF(n=n, mlp=SkipConnMLP(**cfg))
    x = torch.rand(8, 3)
    for fn in (fused_min_scan, fused_min_scan_bf16):
        with pytest.raises(ValueError, match=f"{name} = {limit}"):
            fn(module, x, x, 0.1, steps=4)
    # at the limit the CPU tensors are what it refuses
    if name != "spheres":
        cfg[name] = limit
        with pytest.raises(ValueError, match="CUDA"):
            fused_min_scan(SphereSDF(n=4, mlp=SkipConnMLP(**cfg)), x, x, 0.1, steps=4)


# (ray blocks, sample groups, block slots) -> segments: the flagship step's
# 38,400 rays (1,200 blocks, 5 waves on an H100's 264 slots) take 3, its
# half-res grid (300 blocks, 2 waves) 7; one ray block takes the fewest
# segments that make its longest segment shortest, with two groups or more a
# segment; a single group is never split; a long ray stops at the most
# segments.
@pytest.mark.parametrize("blocks,groups,slots,want", [
    (1200, 33, 264, 3), (300, 33, 264, 7), (1, 33, 264, 7), (1, 17, 264, 6),
    (1, 5, 264, 2), (94, 1, 264, 1), (264, 33, 264, 1),
    (1, 1000, 264, MIN_SCAN_MAX_SEGMENTS)])
def test_min_scan_segments_fill_the_last_wave(blocks, groups, slots, want):
    seg = min_scan_segments(blocks, groups, slots)
    assert seg == want
    assert seg == 1 or groups >= 2 * seg
    assert seg <= MIN_SCAN_MAX_SEGMENTS


# (rays, steps) -> segments, with the library's answer for the flagship
# shift on an H100 (32 rays a block, 2 blocks an SM, 132 SMs) put in its
# place: the training shape, the half-res grid, an empty call.
@pytest.mark.parametrize("n,steps,want", [(38400, 128, 3), (9600, 128, 7), (0, 128, 1)])
def test_min_scan_plan_asks_the_library(monkeypatch, n, steps, want):
    fm = sys.modules["neural_raytracing_tpu_torch.kernels.fused_march"]
    asked = []
    monkeypatch.setattr(fm, "_launch_shape", lambda *a: asked.append(a) or (32, 2))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))
    module = _surface(SHIFTS["flagship"])
    assert min_scan_plan(module, n, steps, BF16, torch.device("cuda", 0)) == want
    assert asked == ([] if n == 0 else [(True, 32, 128, 16, 0)])
