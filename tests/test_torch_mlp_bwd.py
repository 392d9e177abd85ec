"""Port parity: the plain versions of the MLP backward kernels K6 and K7.

The port's ``mlp_backward(kernel=False)`` (the plain K6 for segments 0, the
plain checkpointed K7 for segments 2) against ``jax.grad`` through the JAX
package's Pallas backward kernels in interpret mode
(``FusedSkipConnMLP(mode="force", pallas_bwd=True, pallas_bwd_segments=...)``),
for the activations the flagship nets use and 3 or 4 hidden layers.  Then
the port's ``autograd.Function`` with ``kernel_bwd=True``, its launches
replaced by the plain versions (there is no card here).
Tolerance: rtol 1e-4, atol 1e-5 x max(1, max|B|) (float32 sums in another
order; dx is a sum of terms scaled by entries of B).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu.kernels import FusedSkipConnMLP as JFused
from neural_raytracing_tpu.kernels.fused_mlp import _segment_bounds
from neural_raytracing_tpu_torch import load_jax_params
from neural_raytracing_tpu_torch.kernels import (
    FusedSkipConnMLP, ckpt_forward_plain, fused_mlp, mlp_backward,
    mlp_backward_plain, segment_backward_plain, segment_bounds,
)
from neural_raytracing_tpu_torch.nn import SkipConnMLP

torch.set_num_threads(1)


def _pair(segments, **cfg):
    jmlp = JFused(mode="force", block_rows=64, pallas_bwd=True,
                  pallas_bwd_segments=segments, **cfg)
    tree = jax.tree.map(np.asarray, jmlp.init(jax.random.PRNGKey(0)))
    mlp = load_jax_params(FusedSkipConnMLP(**cfg), tree, device="cpu")
    return jmlp, tree, mlp


def _inputs(out, n=100, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    g = rng.normal(size=(n, out)).astype(np.float32)
    return x, g


def _jax_grads(jmlp, tree, x, g):
    def f(params, xx):
        return jnp.sum(jmlp(params, xx) * g)
    return jax.grad(f, argnums=(0, 1))(tree, jnp.asarray(x))


def _flat_jax(mlp, jgrads):
    """JAX param grads in the port's flat_weights order."""
    out = [jgrads["init"]["w"], jgrads["init"]["b"]]
    for i in range(mlp.num_layers):
        out += [jgrads["layers"][i]["w"], jgrads["layers"][i]["b"]]
    return [np.asarray(a) for a in out + [jgrads["out"]["w"], jgrads["out"]["b"]]]


@pytest.mark.parametrize("segments", [0, 2])
@pytest.mark.parametrize("num_layers", [3, 4])
@pytest.mark.parametrize("activation", ["leaky_relu", "softplus"])
def test_plain_backward_matches_jax_pallas(activation, num_layers, segments):
    cfg = dict(in_size=3, out=3, num_layers=num_layers, hidden_size=16, freqs=4,
               activation=activation)
    jmlp, tree, mlp = _pair(segments, **cfg)
    x, g = _inputs(3)
    jparams, jdx = _jax_grads(jmlp, tree, x, g)
    dx, grads = mlp_backward(mlp, torch.from_numpy(x), torch.from_numpy(g), mlp.B,
                             mlp.flat_weights(), segments, kernel=False)
    atol = 1e-5 * max(1.0, float(np.abs(tree["B"]).max()))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=1e-4, atol=atol)
    want = _flat_jax(mlp, jparams)
    assert len(grads) == len(want)
    for i, (a, b) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5, err_msg=str(i))
    assert not np.asarray(jparams["B"]).any()      # dB = 0 on both sides


@pytest.mark.parametrize("num_layers,n_segments", [(4, 2), (16, 4), (10, 4), (3, 4)])
def test_segment_bounds_and_pieces(num_layers, n_segments):
    assert segment_bounds(num_layers, n_segments) == _segment_bounds(num_layers, n_segments)
    mlp = SkipConnMLP(out=2, num_layers=num_layers, hidden_size=8, freqs=2)
    mlp.reset_parameters(torch.Generator().manual_seed(2))
    x = torch.rand(20, 3)
    ws = mlp.flat_weights()
    hs, enc = ckpt_forward_plain(mlp, x, mlp.B, ws, [0, num_layers])
    # the last boundary is the pre-activation of the out layer's input
    out = mlp.activation(hs[num_layers]) @ ws[-2] + ws[-1]
    torch.testing.assert_close(out, mlp(x).detach())
    g_in, genc, grads = segment_backward_plain(mlp, x, mlp.B, ws, enc, hs[0],
                                               torch.ones(20, 8), 0, num_layers)
    assert g_in.shape == (20, 8) and genc.shape == enc.shape
    assert len(grads) == num_layers


@pytest.mark.parametrize("segments", [0, 1, 2])
def test_kernel_bwd_autograd_function(monkeypatch, segments):
    """FusedSkipConnMLP(kernel_bwd=True) through its autograd.Function, with
    the launches swapped for their plain versions: the gradients match
    autograd through the plain forward, and the backward is first-order."""
    from neural_raytracing_tpu_torch.nn.mlp import mlp_forward
    monkeypatch.setattr(fused_mlp, "fused_mlp_forward",
                        lambda mlp, x, basis, weights: mlp_forward(mlp, x, basis, weights))
    monkeypatch.setattr(fused_mlp, "fused_mlp_backward", mlp_backward_plain)
    monkeypatch.setattr(fused_mlp, "fused_mlp_ckpt_forward", ckpt_forward_plain)
    monkeypatch.setattr(fused_mlp, "fused_mlp_segment_backward", segment_backward_plain)
    cfg = dict(in_size=3, out=3, num_layers=4, hidden_size=16, freqs=4)
    mlp = FusedSkipConnMLP(kernel_bwd=True, kernel_bwd_segments=segments, **cfg)
    mlp.reset_parameters(torch.Generator().manual_seed(3))
    x = torch.rand(50, 3, generator=torch.Generator().manual_seed(4))

    def grads(fn):
        xx = x.clone().requires_grad_()
        loss = fn(xx).square().sum()
        return torch.autograd.grad(loss, [xx] + mlp.flat_weights())

    got = grads(lambda xx: fused_mlp.fused_mlp_apply(mlp, xx))
    want = grads(lambda xx: SkipConnMLP.forward(mlp, xx))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    xx = x.clone().requires_grad_()
    (gx,) = torch.autograd.grad(fused_mlp.fused_mlp_apply(mlp, xx).sum(), xx,
                                create_graph=True)
    with pytest.raises(RuntimeError):
        torch.autograd.grad(gx.sum(), mlp.layers[0].w)
