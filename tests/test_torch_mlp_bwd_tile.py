"""K6's and K7's tile route on the CPU: the transposed pack, a plain backward
that reads only the two packs, the fixed-order dW reduction and its row
plan, the pack's cache and the route by shape.

The tile kernels of ``csrc/fused_mlp_bwd_tile.cu`` read a net only through
K1's float32 pack (``tile_pack_plain``) and the transposed pack
(``tile_transposes_plain``; on the card ``pack_tile_transposes``).  A plain
backward that reads nothing else (``tile_backward_plain``, with the kernels'
data flow: K6 for segments 0, K7 with its boundary checkpoints for 2 and 4)
must give ``mlp_backward_plain`` / the plain K7 and the JAX package's
``_pallas_backward`` / ``_pallas_backward_segmented`` in interpret mode, on
narrow twins of the shading nets (hidden 96 padded to 128, a 200-wide net
padded to 256, leaky_relu and softplus, skip layers in each).

Tolerances as ``tests/test_torch_mlp_bwd.py``: rtol 1e-4, atol 1e-5 x
max(1, max|B|) for dx (a sum of terms scaled by entries of B) and 1e-5 for
the weights' gradients (float32 sums in another order; the packs' padding
adds exact zeros).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu.kernels import FusedSkipConnMLP as JFused
from neural_raytracing_tpu_torch import load_jax_params
from neural_raytracing_tpu_torch.kernels import (
    FusedSkipConnMLP, dw_plan, fused_mlp_backward, fused_mlp_ckpt_forward,
    fused_mlp_segment_backward, k1_route, launch_counts, mlp_backward, mlp_backward_plain,
    reset_launch_counts, tile_backward_plain, tile_bwd_widths, tile_dw_plain, tile_pack_key,
    tile_pack_plain, tile_transpose_layout, tile_transposes, tile_transposes_plain,
)
from neural_raytracing_tpu_torch.kernels.fused_mlp import DW_BLOCKS, _TILE_PACKS, weight_shapes
from neural_raytracing_tpu_torch.nn import SkipConnMLP

torch.set_num_threads(1)
# narrow twins of the shading nets: a lobe (hidden 96 -> NP 128) and the
# 256-wide nets (200 -> NP 256), each with skip layers
TWINS = {
    "lobe96": dict(in_size=3, out=3, num_layers=5, hidden_size=96, freqs=32),
    "wide200": dict(in_size=3, out=8, num_layers=4, hidden_size=200, freqs=16),
}
ACTIVATIONS = ("leaky_relu", "softplus")
# the flagship's shading nets at full width, for the widths and the plan
WEIGHT_NET = dict(in_size=3, out=8, num_layers=16, hidden_size=256, freqs=128)


def _net(cfg, activation="leaky_relu", seed=0):
    mlp = SkipConnMLP(**cfg, activation=activation)
    mlp.reset_parameters(torch.Generator().manual_seed(seed))
    return mlp


def _inputs(mlp, n=130, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    g = rng.normal(size=(n, mlp.out_size)).astype(np.float32)
    return x, g


def _packs(mlp):
    ws = mlp.flat_weights()
    return tile_pack_plain(mlp, mlp.B, ws), tile_transposes_plain(mlp, ws)


def _close(got, want, basis):
    dx, grads = got
    atol = 1e-5 * max(1.0, float(basis.abs().max()))
    np.testing.assert_allclose(np.asarray(dx), np.asarray(want[0]), rtol=1e-4, atol=atol)
    assert len(grads) == len(want[1])
    for i, (a, b) in enumerate(zip(grads, want[1])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-5,
                                   err_msg=str(i))


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("name", sorted(TWINS))
def test_transposed_pack_layout_and_zero_padding(name, activation):
    mlp = _net(TWINS[name], activation)
    H, E = mlp.hidden_size, mlp.enc_size
    NP, EPT = tile_bwd_widths(mlp)
    assert NP == (128 if H <= 128 else 256) and EPT % 64 == 0 and E <= EPT < E + 64
    layout, total = tile_transpose_layout(mlp)
    views = tile_transposes_plain(mlp, mlp.flat_weights())
    assert len(views) == len(layout) == 1 + 2 * mlp.num_layers
    assert total == sum(v.numel() for v in views if v is not None)
    ws = [w.detach() for w in mlp.flat_weights()[0::2]]

    def holds(view, block):
        """view's top-left block equals ``block``; every other entry is 0."""
        rest = view.clone()
        assert torch.equal(rest[:block.shape[0], :block.shape[1]], block)
        rest[:block.shape[0], :block.shape[1]] = 0
        assert not rest.any()

    assert views[0].shape == (NP, EPT)
    holds(views[0], ws[0].t())
    for i in range(mlp.num_layers):
        assert views[1 + 2 * i].shape == (NP, NP)
        holds(views[1 + 2 * i], ws[1 + i][:H].t())
        if mlp.is_skip_layer(i):
            assert views[2 + 2 * i].shape == (NP, EPT)
            holds(views[2 + 2 * i], ws[1 + i][H:].t())
        else:
            assert views[2 + 2 * i] is None and layout[2 + 2 * i] is None
    assert any(mlp.is_skip_layer(i) for i in range(mlp.num_layers))


@pytest.mark.parametrize("segments", [0, 2, 4])
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("name", sorted(TWINS))
def test_plain_tile_backward_matches_the_plain_versions(name, activation, segments):
    mlp = _net(TWINS[name], activation)
    x, g = (torch.from_numpy(a) for a in _inputs(mlp))
    got = tile_backward_plain(mlp, x, g, *_packs(mlp), segments)
    want = mlp_backward(mlp, x, g, mlp.B, mlp.flat_weights(), segments, kernel=False)
    _close(got, want, mlp.B)


def _jax_pair(mlp_cfg, activation, segments):
    jmlp = JFused(mode="force", block_rows=64, pallas_bwd=True,
                  pallas_bwd_segments=segments, activation=activation, **mlp_cfg)
    tree = jax.tree.map(np.asarray, jmlp.init(jax.random.PRNGKey(0)))
    mlp = load_jax_params(FusedSkipConnMLP(activation=activation, **mlp_cfg), tree,
                          device="cpu")
    return jmlp, tree, mlp


def _flat_jax(mlp, jgrads):
    out = [jgrads["init"]["w"], jgrads["init"]["b"]]
    for i in range(mlp.num_layers):
        out += [jgrads["layers"][i]["w"], jgrads["layers"][i]["b"]]
    return [np.asarray(a) for a in out + [jgrads["out"]["w"], jgrads["out"]["b"]]]


@pytest.mark.parametrize("segments", [0, 2, 4])
@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("name", sorted(TWINS))
def test_plain_tile_backward_matches_jax_pallas(name, activation, segments):
    """Against jax.grad through the JAX package's _pallas_backward (segments
    0) or _pallas_backward_segmented (2, 4) in interpret mode."""
    jmlp, tree, mlp = _jax_pair(TWINS[name], activation, segments)
    x, g = _inputs(mlp)

    def f(params, xx):
        return jnp.sum(jmlp(params, xx) * g)

    jparams, jdx = jax.grad(f, argnums=(0, 1))(tree, jnp.asarray(x))
    got = tile_backward_plain(mlp, torch.from_numpy(x), torch.from_numpy(g), *_packs(mlp),
                              segments)
    _close(got, (np.asarray(jdx), _flat_jax(mlp, jparams)), mlp.B)
    assert not np.asarray(jparams["B"]).any()      # dB = 0 on both sides


@pytest.mark.parametrize("n", [1, 63, 64, 65])
def test_plain_tile_backward_at_edge_row_counts(n):
    mlp = _net(TWINS["wide200"], "softplus", seed=2)
    x, g = (torch.from_numpy(a) for a in _inputs(mlp, n, seed=3))
    _close(tile_backward_plain(mlp, x, g, *_packs(mlp)),
           mlp_backward_plain(mlp, x, g, mlp.B, mlp.flat_weights()), mlp.B)


@pytest.mark.parametrize("rows", [32, 64, 4000])
def test_fixed_order_dw_reduction_gives_the_same_bits_twice(rows):
    """The dW kernel's sums: slices of ``rows`` rows, each [a | 1]^T g, added
    in slice order: the same inputs give the same bits, and the sums are
    the product's (db the column sums)."""
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.normal(size=(3001, 131)).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=(3001, 96)).astype(np.float32))
    first, second = tile_dw_plain(a, g, rows), tile_dw_plain(a.clone(), g.clone(), rows)
    assert first.shape == (132, 96) and torch.equal(first, second)
    torch.testing.assert_close(first[:-1], a.t() @ g, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(first[-1], g.sum(0), rtol=1e-4, atol=1e-3)
    assert not tile_dw_plain(a[:0], g[:0], rows).any()


def _layer_shapes(mlp):
    return [tuple(s) for s in weight_shapes(mlp)[1::2]]


@pytest.mark.parametrize("n", [1, 63, 64, 65, 38_400])
def test_dw_plan_at_edge_row_counts(n):
    """dw_plan over the weight net's layers: row slices of a multiple of 32
    rows that cover the n rows, each slice at least one row, and at most
    DW_BLOCKS blocks where there is more than one slice."""
    shapes = _layer_shapes(_net(WEIGHT_NET))
    plan = dw_plan(n, shapes)
    assert plan["tiles"] == 102   # init 3 x 2, 11 plain layers 2 x 2, 5 skip 5 x 2, out 2 x 1
    assert plan["rows"] % 32 == 0 and plan["slices"] >= 1
    assert plan["slices"] * plan["rows"] >= n > (plan["slices"] - 1) * plan["rows"]
    assert plan["slices"] == 1 or plan["slices"] * plan["tiles"] <= DW_BLOCKS
    if n <= 256:
        assert plan["slices"] == 1
    if n == 38_400:
        assert (plan["slices"], plan["rows"]) == (10, 3840)
    assert dw_plan(n, shapes) == plan   # a function of n and the widths alone


def test_transposed_pack_key_moves_after_an_adamw_step():
    """The transposed pack is cached beside the module by the weights'
    addresses and versions: AdamW's in-place update moves the key and the
    next lookup packs the new weights."""
    from neural_raytracing_tpu_torch.training import make_optimizer
    mlp = FusedSkipConnMLP(**TWINS["lobe96"])
    mlp.reset_parameters(torch.Generator().manual_seed(5))
    opt = make_optimizer({}, default_lr=1e-2).init(torch.nn.ModuleDict({"net": mlp}))
    key = tile_pack_key(mlp.B, mlp.flat_weights(), "transposes")
    first = tile_transposes(mlp, mlp.B, mlp.flat_weights())
    assert _TILE_PACKS[mlp]["transposes"][0] == key
    assert tile_transposes(mlp, mlp.B, mlp.flat_weights()) is first   # a hit
    before = [None if v is None else v.clone() for v in first]
    x = torch.rand(64, 3, generator=torch.Generator().manual_seed(6))
    mlp(x).square().sum().backward()
    opt.step()
    assert tile_pack_key(mlp.B, mlp.flat_weights(), "transposes") != key
    again = tile_transposes(mlp, mlp.B, mlp.flat_weights())
    assert _TILE_PACKS[mlp]["transposes"][0] != key
    want = tile_transposes_plain(mlp, mlp.flat_weights())
    for a, b, old in zip(again, want, before):
        assert (a is None and b is None and old is None) or torch.equal(a, b)
    assert not all(torch.equal(a, b) for a, b in zip(again[1::2], before[1::2]))


def test_backward_route_by_shape():
    """K6 and K7 take K1's route: a net on the tile runs the tile kernels, a
    net off it (in_size 5, hidden 300) the general ones, which route="tile"
    refuses; a latent raises before anything touches a device; CPU tensors
    raise (no launch is counted) on either route."""
    tile = FusedSkipConnMLP(**TWINS["wide200"])
    off = FusedSkipConnMLP(in_size=5, out=2, num_layers=3, hidden_size=300, freqs=8)
    latent = FusedSkipConnMLP(**TWINS["lobe96"], latent_size=4)
    assert k1_route(tile) == "tile" and k1_route(off) == "general"
    with pytest.raises(ValueError, match="latent"):
        k1_route(latent)
    x5, g2 = torch.rand(8, 5), torch.rand(8, 2)
    with pytest.raises(ValueError, match="route 'tile'"):
        fused_mlp_backward(off, x5, g2, off.B, off.flat_weights(), route="tile")
    with pytest.raises(ValueError, match="route 'tile'"):
        fused_mlp_ckpt_forward(off, x5, off.B, off.flat_weights(), [0], route="tile")
    with pytest.raises(ValueError, match="latent"):
        fused_mlp_backward(latent, torch.rand(8, 3), torch.rand(8, 3), latent.B,
                           latent.flat_weights())
    reset_launch_counts()
    x, g = torch.rand(8, 3), torch.rand(8, 8)
    for route in ("tile", "general"):
        with pytest.raises(ValueError, match="CUDA"):
            fused_mlp_backward(tile, x, g, tile.B, tile.flat_weights(), route=route)
        with pytest.raises(ValueError, match="CUDA"):
            fused_mlp_segment_backward(tile, x, tile.B, tile.flat_weights(),
                                       torch.rand(8, tile.enc_size), torch.rand(8, 200),
                                       torch.rand(8, 200), 0, 2, route=route)
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp_backward(off, x5, g2, off.B, off.flat_weights())
    assert all(v == 0 for v in launch_counts().values())
