"""K1's tile on the CPU: its packed weights, a plain forward through them,
the pack's cache and the choice of route.

The tile kernels of ``csrc/fused_mlp_tile.cu`` read a net only through the
buffer ``tile_pack_plain`` (and, on the card, the pack kernel) lays out.  A
plain forward that reads nothing else (``tile_forward_plain``) must give
``SkipConnMLP.forward`` with float32 operands and K1-bf16's plain version
``mlp_forward_bf16_operands`` with bf16 ones, on narrow twins of the four
nets the main paths run through K1 (hidden 96 padded to 128, out 8, 128
frequencies; a 200-wide twin for the 256-wide layout) and against the JAX
package's ``_pallas_forward`` in interpret mode; the march kernels' rounding
(``act`` of the ROUNDED encoding on the skip layers) must fall outside
K1-bf16's tolerance.  The pack's cache key moves with the weights, the
weights are checked before anything is packed, and a net past the tile's
widths takes the first kernel, or raises before anything touches a device
where neither kernel takes it.

Tolerances: float32 rtol 1e-5 / atol 1e-6 (the padded products add exact
zeros, but the matmuls sum in another order); bf16 1e-4 |want| + 1e-5 on 99%
of the rows (a float32 difference can tip the bf16 rounding of one
operand, which moves that row by one bf16 step from there on).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu.kernels.fused_mlp import _pallas_forward
from neural_raytracing_tpu.nn import SkipConnMLP as JMLP
from neural_raytracing_tpu_torch.kernels import (
    TILE_LIMITS, FusedSkipConnMLP, fused_mlp_forward, fused_mlp_forward_bf16, k1_route,
    launch_counts, mlp_forward_bf16_operands, pack_tile_weights, reset_launch_counts,
    tile_forward_plain, tile_info, tile_layout, tile_pack, tile_pack_key, tile_pack_plain,
    tile_pointers, tile_widths,
)
from neural_raytracing_tpu_torch.kernels.fused_mlp import _TILE_PACKS, f32_column_order
from neural_raytracing_tpu_torch.nn import SkipConnMLP
from neural_raytracing_tpu_torch.params import load_jax_params

torch.set_num_threads(1)
BF16 = torch.bfloat16
# narrow twins of the path's fused nets: the shift net, the weight net, a
# lobe and the light field
TWINS = {
    "shift": dict(in_size=3, out=1, num_layers=4, hidden_size=96, freqs=32,
                  activation="softplus", init="uniform"),
    "weight_net": dict(in_size=3, out=8, num_layers=5, hidden_size=96, freqs=128,
                       sigma=128.0, init="xavier"),
    "lobe": dict(in_size=3, out=3, num_layers=4, hidden_size=96, freqs=64),
    "light_field": dict(in_size=3, out=3, num_layers=4, hidden_size=200, freqs=16),
}
DTYPES = [torch.float32, BF16]


def _net(cfg, seed=0, **kw):
    mlp = SkipConnMLP(**cfg, **kw)
    mlp.reset_parameters(torch.Generator().manual_seed(seed))
    return mlp


def _x(n=384, seed=1):
    return torch.rand(n, 3, generator=torch.Generator().manual_seed(seed)) - 0.5


def _rows_within(got, want):
    """The share of rows whose every output is within the bf16 check's
    float32 tolerance."""
    return ((got - want).abs() <= 1e-4 * want.abs() + 1e-5).all(dim=-1).float().mean().item()


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(TWINS))
def test_plain_tile_forward_reads_only_the_pack(name, dtype):
    mlp = _net(TWINS[name])
    x = _x()
    packed = tile_pack_plain(mlp, mlp.B, mlp.flat_weights(), dtype)
    with torch.no_grad():
        got = tile_forward_plain(mlp, x, packed, dtype)
        if dtype == torch.float32:
            torch.testing.assert_close(got, SkipConnMLP.forward(mlp, x), rtol=1e-5, atol=1e-6)
        else:
            want = mlp_forward_bf16_operands(mlp, x, mlp.B, mlp.flat_weights())
            assert _rows_within(got, want) >= 0.99


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(TWINS))
def test_pack_layout_and_padding(name, dtype):
    """Every slot has its documented shape and type; the weights sit in the
    rows of their inputs and the first hidden_size (logical) columns, the
    out weights in the first hidden_size entries of their column; the rest
    is zero."""
    mlp = _net(TWINS[name])
    NP, EP = tile_widths(mlp, dtype)
    H, E = mlp.hidden_size, mlp.enc_size
    layout, total = tile_layout(mlp, dtype)
    assert all(off % 16 == 0 for off, _, _ in layout) and total % 16 == 0
    packed = tile_pack_plain(mlp, mlp.B, mlp.flat_weights(), dtype)
    assert [tuple(t.shape) for t in packed] == [shape for _, shape, _ in layout]
    assert [t.dtype for t in packed] == [d for _, _, d in layout]
    ws = [w.detach() for w in mlp.flat_weights()]
    order = f32_column_order(NP)
    for l in range(mlp.num_layers + 1):
        m = packed[1 + 2 * l].float()
        logical = m.t() if dtype == BF16 else torch.empty_like(m).index_copy_(1, order, m)
        w = ws[2 * l].to(dtype).float()
        h_rows = NP if l > 0 else 0
        want = torch.zeros_like(logical)
        if l > 0:
            want[:H, :H] = w[:H]
        if l == 0 or mlp.is_skip_layer(l - 1):
            want[h_rows:h_rows + E, :H] = w[(H if l > 0 else 0):]
        assert logical.shape[0] == (EP if l == 0 else
                                    NP + EP if mlp.is_skip_layer(l - 1) else NP)
        assert torch.equal(logical, want)
        assert torch.equal(packed[2 + 2 * l][:H], ws[1 + 2 * l])
        assert not packed[2 + 2 * l][H:].any()
    out_w = ws[-2].t().to(dtype).float() if dtype == BF16 else ws[-2].t()
    assert torch.equal(packed[-2][:, :H], out_w) and not packed[-2][:, H:].any()
    assert torch.equal(packed[-1], ws[-1]) and torch.equal(packed[0], mlp.B)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_plain_tile_forward_matches_the_pallas_interpret_kernel(dtype):
    cfg = dict(in_size=3, out=3, num_layers=4, hidden_size=40, freqs=12)
    jdtype = jnp.bfloat16 if dtype == BF16 else jnp.float32
    jmlp = JMLP(**cfg, compute_dtype=jdtype)
    tree = jax.tree.map(np.asarray, jmlp.init(jax.random.PRNGKey(3)))
    mlp = load_jax_params(SkipConnMLP(**cfg, compute_dtype=dtype), tree, device="cpu")
    x = np.random.default_rng(4).uniform(-0.5, 0.5, (96, 3)).astype(np.float32)
    want = torch.from_numpy(np.array(
        _pallas_forward(jmlp, tree, jnp.asarray(x), block_rows=32, interpret=True)))
    with torch.no_grad():
        got = tile_forward_plain(mlp, torch.from_numpy(x),
                                 tile_pack_plain(mlp, mlp.B, mlp.flat_weights(), dtype), dtype)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert _rows_within(got, want) >= 0.99


def test_march_rounding_falls_outside_k1_bf16s_tolerance():
    """K1-bf16 reads act() of the float32 encoding on its skip layers; the
    march kernels' act() of the rounded one is another function, which the
    bf16 check must tell apart."""
    mlp = _net(TWINS["lobe"])
    x = _x()
    with torch.no_grad():
        got = tile_forward_plain(mlp, x, tile_pack_plain(mlp, mlp.B, mlp.flat_weights(), BF16),
                                 BF16)
        march = mlp_forward_bf16_operands(mlp, x, mlp.B, mlp.flat_weights(),
                                          act_of_rounded_enc=True)
    assert _rows_within(got, march) < 0.99


def test_pack_cache_key_follows_the_weights():
    mlp = FusedSkipConnMLP(**TWINS["lobe"])
    mlp.reset_parameters(torch.Generator().manual_seed(0))

    def key():
        return tile_pack_key(mlp.B, mlp.flat_weights(), torch.float32)

    first = tile_pack(mlp, mlp.B, mlp.flat_weights())
    assert tile_pack(mlp, mlp.B, mlp.flat_weights()) is first
    assert tile_pack(mlp, mlp.B, mlp.flat_weights(), BF16) is not first
    keys = [key()]
    with torch.no_grad():
        mlp.layers[1].w.add_(1.0)                      # an in-place update
    keys.append(key())
    mlp.load_state_dict(_net(TWINS["lobe"], seed=5).state_dict())
    keys.append(key())
    mlp.to(torch.float64).to(torch.float32)           # new tensors
    keys.append(key())
    assert len(set(keys)) == len(keys)
    again = tile_pack(mlp, mlp.B, mlp.flat_weights())
    assert again is not first
    # the cache is not module state: a copy of the module (the training
    # step's parity check deep-copies a scene) carries no pack and packs its
    # own weights
    twin = copy.deepcopy(mlp)
    assert tile_pack(twin, twin.B, twin.flat_weights()) is not again
    with torch.no_grad():
        torch.testing.assert_close(
            tile_forward_plain(mlp, _x(), again), SkipConnMLP.forward(mlp, _x()),
            rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(TWINS))
def test_pack_on_cpu_tensors_is_the_plain_pack(name, dtype):
    """The pack's wrapper takes its plain version on CPU tensors, and counts
    no launch."""
    mlp = _net(TWINS[name])
    reset_launch_counts()
    got = pack_tile_weights(mlp, mlp.B, mlp.flat_weights(), dtype)
    want = tile_pack_plain(mlp, mlp.B, mlp.flat_weights(), dtype)
    assert len(got) == len(want)
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(got, want))
    assert launch_counts()["pack_tile_weights"] == 0


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [0, 1, 67])
def test_plain_tile_forward_at_edge_row_counts(n, dtype):
    mlp = _net(TWINS["weight_net"])
    x = _x(n)
    with torch.no_grad():
        got = tile_forward_plain(mlp, x, tile_pack_plain(mlp, mlp.B, mlp.flat_weights(), dtype),
                                 dtype)
        assert got.shape == (n, mlp.out_size)
        if dtype == torch.float32:
            torch.testing.assert_close(got, SkipConnMLP.forward(mlp, x), rtol=1e-5, atol=1e-6)
        elif n:
            want = mlp_forward_bf16_operands(mlp, x, mlp.B, mlp.flat_weights())
            assert _rows_within(got, want) >= 0.99


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
def test_tile_pointers_check_the_weights_before_packing(dtype):
    """The tile kernels' weights are checked on the launch's device before
    the cache is read or filled: a net on the CPU is refused, nothing is
    packed or cached."""
    mlp = FusedSkipConnMLP(**TWINS["lobe"])
    reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        tile_pointers(mlp, mlp.B, mlp.flat_weights(), torch.device("cpu"), dtype)
    assert mlp not in _TILE_PACKS
    assert launch_counts()["pack_tile_weights"] == 0


@pytest.mark.parametrize("cfg,route", [
    (TWINS["lobe"], "tile"),
    (dict(in_size=3, out=8, num_layers=16, hidden_size=256, freqs=128), "tile"),
    (dict(in_size=3, out=1, num_layers=32, hidden_size=8, freqs=0), "tile"),
    (dict(in_size=5, out=1, num_layers=3, hidden_size=512, freqs=16), "general"),
    (dict(in_size=2, out=3, num_layers=2, hidden_size=64, freqs=8), "general"),
    (dict(in_size=3, out=3, num_layers=2, hidden_size=257, freqs=8), "general"),
    (dict(in_size=3, out=3, num_layers=2, hidden_size=64, freqs=129), "general"),
])
def test_k1_route_by_shape(cfg, route):
    mlp = SkipConnMLP(**cfg)
    assert k1_route(mlp) == route


@pytest.mark.parametrize("cfg,match", [
    (dict(in_size=3, out=1, num_layers=33, hidden_size=8, freqs=2), "layers"),
    (dict(in_size=3, out=1, num_layers=2, hidden_size=8, freqs=2, latent_size=4), "latent"),
])
def test_widths_past_the_limits_raise_before_the_device(cfg, match):
    """The wrappers raise ValueError naming the limit, on CPU tensors too,
    before any device check; nothing is counted."""
    mlp = SkipConnMLP(**cfg)
    x = torch.zeros(4, mlp.in_size)
    reset_launch_counts()
    for call in (lambda: k1_route(mlp),
                 lambda: fused_mlp_forward(mlp, x, mlp.B, mlp.flat_weights()),
                 lambda: fused_mlp_forward_bf16(mlp, x, mlp.B, mlp.flat_weights())):
        with pytest.raises(ValueError, match=match):
            call()
    assert all(v == 0 for v in launch_counts().values())


def test_tile_route_is_refused_to_a_net_off_the_tile():
    mlp = SkipConnMLP(in_size=5, out=1, num_layers=2, hidden_size=300, freqs=4)
    x = torch.zeros(4, 5)
    with pytest.raises(ValueError, match="route 'tile'"):
        fused_mlp_forward(mlp, x, mlp.B, mlp.flat_weights(), route="tile")
    with pytest.raises(ValueError, match="off the tile"):
        tile_info(mlp)
    # the tile's widths are TILE_LIMITS
    assert TILE_LIMITS == {"in_size": 3, "hidden_size": 256, "freqs": 128, "num_layers": 32}
