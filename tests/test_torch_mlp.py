"""Port parity: SkipConnMLP / FusedSkipConnMLP against the JAX package.

The JAX params pytree (numpy) is loaded into the port; inputs come from a
seeded numpy generator.  On the CPU the port's FusedSkipConnMLP takes its
plain version; the JAX side runs its jnp path and, for the flagship shapes,
its Pallas kernel in interpret mode (mode="force").
Tolerance: rtol 1e-4, atol 1e-5 (float32 matmul chains summed in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu.kernels import FusedSkipConnMLP as JFused
from neural_raytracing_tpu.nn import SkipConnMLP as JMLP
from neural_raytracing_tpu_torch import load_jax_params
from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP, fused_mlp
from neural_raytracing_tpu_torch.nn import ACTIVATIONS, SkipConnMLP

torch.set_num_threads(1)
RTOL, ATOL = 1e-4, 1e-5

# the four flagship nets at reduced width (4 x 16, 4 frequencies)
FLAGSHIP = {
    "sdf_shift": dict(in_size=3, out=1, num_layers=4, hidden_size=16, freqs=4,
                      activation="softplus", init="uniform"),
    "weight_net": dict(in_size=3, out=8, num_layers=4, hidden_size=16, freqs=4,
                       sigma=128.0, init="xavier"),
    "lobe": dict(in_size=3, out=3, num_layers=4, hidden_size=16, freqs=4),
    "light_field": dict(in_size=3, out=3, num_layers=4, hidden_size=16, freqs=4),
}


def _pair(cls=SkipConnMLP, jcls=JMLP, seed=0, jkw=None, **cfg):
    jmlp = jcls(**cfg, **(jkw or {}))
    tree = jax.tree.map(np.asarray, jmlp.init(jax.random.PRNGKey(seed)))
    mlp = load_jax_params(cls(**cfg), tree, device="cpu")
    return jmlp, tree, mlp


def _x(n=64, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, (n, 3)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("init", ["uniform", "zeros", "xavier"])
@pytest.mark.parametrize("activation", sorted(ACTIVATIONS))
def test_forward_every_activation_and_init(activation, init):
    jmlp, tree, mlp = _pair(num_layers=3, hidden_size=16, freqs=4,
                            activation=activation, init=init)
    x = _x()
    _close(mlp(torch.from_numpy(x)), jmlp(tree, jnp.asarray(x)))


@pytest.mark.parametrize("num_layers", [1, 3, 4])
def test_skip_layer_placement(num_layers):
    jmlp, tree, mlp = _pair(num_layers=num_layers, hidden_size=16, freqs=4,
                            activation="softplus")
    skip_layers = [i for i in range(num_layers) if mlp.is_skip_layer(i)]
    assert skip_layers == [i for i in range(num_layers) if jmlp._is_skip_layer(i)]
    for i, layer in enumerate(mlp.layers):
        assert layer.w.shape[0] == (mlp.skip_size if i in skip_layers else 16)
    x = _x(seed=num_layers)
    _close(mlp(torch.from_numpy(x)), jmlp(tree, jnp.asarray(x)))


def test_zero_out_and_batched_shape():
    jmlp, tree, mlp = _pair(num_layers=3, hidden_size=16, freqs=4, zero_out=True)
    assert not tree["out"]["w"].any()
    x = _x().reshape(4, 4, 4, 3)
    got = mlp(torch.from_numpy(x))
    assert got.shape == (4, 4, 4, 3)
    _close(got, jmlp(tree, jnp.asarray(x)))
    fresh = SkipConnMLP(num_layers=3, hidden_size=16, freqs=4, zero_out=True)
    fresh.reset_parameters(torch.Generator().manual_seed(0))
    assert not fresh.out.w.any() and fresh.init.w.any()


def test_latent_input_takes_the_plain_path():
    cfg = dict(num_layers=3, hidden_size=16, freqs=4, latent_size=2)
    jmlp, tree, mlp = _pair(cls=FusedSkipConnMLP, **cfg)
    x = _x()
    lat = np.random.default_rng(9).normal(size=(64, 2)).astype(np.float32)
    _close(mlp(torch.from_numpy(x), torch.from_numpy(lat)),
           jmlp(tree, jnp.asarray(x), jnp.asarray(lat)))


def _jax_grads(jmlp, tree, x, g, v):
    f = lambda xx: jnp.sum(jmlp(tree, xx) * g)
    gx = jax.grad(f)(x)
    hv = jax.grad(lambda xx: jnp.sum(jax.grad(f)(xx) * v))(x)
    return gx, hv


def _torch_grads(mlp, x, g, v):
    xt = torch.from_numpy(x).requires_grad_()
    (gx,) = torch.autograd.grad((mlp(xt) * torch.from_numpy(g)).sum(), xt,
                                create_graph=True)
    (hv,) = torch.autograd.grad((gx * torch.from_numpy(v)).sum(), xt)
    return gx, hv


@pytest.mark.parametrize("name", sorted(FLAGSHIP))
def test_flagship_shapes_forward_input_grad_and_second_derivative(name):
    cfg = FLAGSHIP[name]
    jmlp, tree, mlp = _pair(cls=FusedSkipConnMLP, jcls=JFused, **cfg)
    rng = np.random.default_rng(3)
    x = _x(seed=4)
    g = rng.normal(size=(64, cfg["out"])).astype(np.float32)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    _close(mlp(torch.from_numpy(x)), jmlp(tree, jnp.asarray(x)))
    jgx, jhv = _jax_grads(jmlp, tree, jnp.asarray(x), jnp.asarray(g), jnp.asarray(v))
    gx, hv = _torch_grads(mlp, x, g, v)
    # each derivative through sin(xB), cos(xB) multiplies by an entry of B
    # (~sigma), and the float32 sums cancel terms of that size: the atol
    # scales with max|B| per order of derivative
    scale = max(1.0, float(np.abs(tree["B"]).max()))
    np.testing.assert_allclose(gx.detach().numpy(), np.asarray(jgx), rtol=RTOL,
                               atol=ATOL * scale)
    np.testing.assert_allclose(hv.numpy(), np.asarray(jhv), rtol=RTOL,
                               atol=ATOL * scale ** 2)


@pytest.mark.parametrize("name", sorted(FLAGSHIP))
def test_flagship_shapes_against_pallas_interpret(name):
    cfg = FLAGSHIP[name]
    jmlp, tree, mlp = _pair(cls=FusedSkipConnMLP, jcls=JFused,
                            jkw=dict(mode="force", block_rows=64), **cfg)
    x = _x(n=100, seed=5)
    _close(mlp(torch.from_numpy(x)), jmlp(tree, jnp.asarray(x)))


def test_kernel_autograd_function_gradients(monkeypatch):
    """The kernel's autograd.Function, with the launch replaced by the plain
    forward (no card here): first and second derivatives match autograd
    through the plain version, for the input and for the weights."""
    from neural_raytracing_tpu_torch.nn.mlp import mlp_forward
    monkeypatch.setattr(fused_mlp, "fused_mlp_forward",
                        lambda mlp, x, basis, weights: mlp_forward(mlp, x, basis, weights))
    _, _, mlp = _pair(cls=FusedSkipConnMLP, **FLAGSHIP["sdf_shift"])
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_x(seed=7)).requires_grad_()
    v = torch.from_numpy(rng.normal(size=(64, 3)).astype(np.float32))

    def grads(fn):
        (gx,) = torch.autograd.grad(fn(x).sum(), x, create_graph=True)
        second = torch.autograd.grad((gx * v).sum(), [x, mlp.layers[1].w])
        first_w = torch.autograd.grad(fn(x).pow(2).sum(), mlp.out.w)[0]
        return gx, first_w, *second

    got = grads(lambda xx: fused_mlp.fused_mlp_apply(mlp, xx))
    want = grads(lambda xx: SkipConnMLP.forward(mlp, xx))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
