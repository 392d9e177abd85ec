"""Port parity at exact ties: leaky_relu at a pre-activation of exactly 0,
and the loss's maximum, clip and abs at their ties, against ``jax.grad`` of
the JAX package.

torch's own forms take other gradients there: ``F.leaky_relu`` takes slope
0.01 at 0 where ``jax.nn.leaky_relu`` takes 1; ``clamp_min`` and ``clamp``
pass the whole gradient at a tie where ``jnp.maximum`` and ``jnp.clip``
pass half; ``torch.abs`` takes slope 0 at 0 where ``jnp.abs`` takes 1.  The
port's forms keep torch's values bit for bit and take JAX's gradients.

Inputs are seeded numpy arrays with the ties written in.  Tolerances: the
elementwise forms' first and second derivatives exactly (one product at a
tie); the net's and the loss's gradients rtol 1e-5 / atol 1e-6 of the
largest entry (float32 sums in another order), far below what a slope taken
wrongly at a tie moves them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from neural_raytracing_tpu.nn import SkipConnMLP as JMLP
from neural_raytracing_tpu.ops.losses import masked_loss as jmasked_loss
from neural_raytracing_tpu_torch import load_jax_params
from neural_raytracing_tpu_torch.nn import ACTIVATIONS, SkipConnMLP
from neural_raytracing_tpu_torch.ops import masked_loss
from neural_raytracing_tpu_torch.ops.math import absolute, clip, maximum

torch.set_num_threads(1)

# every float32 class a form meets: signed zeros, the ties, infinities, NaN
SPECIAL = np.array([-np.inf, -2.5, -1.0, -1e-30, -0.0, 0.0, 1e-30, 1e-12,
                    np.float32(1e-12), 0.5, 1.0, 1.0 - 1e-7, 2.0, np.inf, np.nan],
                   np.float32)

# (port form, torch's own form, the JAX form) on one float32 argument
FORMS = {
    "leaky_relu": (ACTIVATIONS["leaky_relu"], lambda x: F.leaky_relu(x, 0.01),
                   lambda x: jax.nn.leaky_relu(x, negative_slope=0.01)),
    "maximum 0": (lambda x: maximum(x, 0.0), lambda x: torch.clamp_min(x, 0.0),
                  lambda x: jnp.maximum(x, 0.0)),
    "maximum 1e-12": (lambda x: maximum(x, 1e-12), lambda x: torch.clamp_min(x, 1e-12),
                      lambda x: jnp.maximum(x, 1e-12)),
    "clip": (lambda x: clip(x, 1e-12, 1.0 - 1e-12), lambda x: torch.clamp(x, 1e-12, 1.0 - 1e-12),
             lambda x: jnp.clip(x, 1e-12, 1.0 - 1e-12)),
    "clip -1 1": (lambda x: clip(x, -1.0, 1.0), lambda x: torch.clamp(x, -1.0, 1.0),
                  lambda x: jnp.clip(x, -1.0, 1.0)),
    "abs": (absolute, torch.abs, jnp.abs),
}


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().numpy().view(np.int32)


@pytest.mark.parametrize("name", sorted(FORMS))
def test_forms_keep_torchs_values_bit_for_bit(name):
    port, own, jform = FORMS[name]
    x = torch.from_numpy(SPECIAL.copy())
    np.testing.assert_array_equal(_bits(port(x)), _bits(own(x)))
    # JAX's values too, NaN and the sign of zero aside
    want = np.asarray(jform(jnp.asarray(SPECIAL)))
    got = port(x).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])


@pytest.mark.parametrize("name", sorted(FORMS))
def test_forms_take_jaxs_first_and_second_derivatives(name):
    port, _, jform = FORMS[name]
    xs = SPECIAL[np.isfinite(SPECIAL)]
    d1 = jax.vmap(jax.grad(jform))(jnp.asarray(xs))
    d2 = jax.vmap(jax.grad(jax.grad(jform)))(jnp.asarray(xs))
    x = torch.from_numpy(xs.copy()).requires_grad_()
    (g1,) = torch.autograd.grad(port(x).sum(), x, create_graph=True)
    # a first derivative built of where() alone has no graph back to x
    g2 = (torch.autograd.grad(g1.sum(), x, allow_unused=True)[0]
          if g1.requires_grad else None)
    g2 = torch.zeros_like(x) if g2 is None else g2
    np.testing.assert_array_equal(g1.detach().numpy(), np.asarray(d1))
    np.testing.assert_array_equal(g2.numpy(), np.asarray(d2))


def test_torchs_own_forms_differ_from_jax_at_the_ties():
    """What the port's forms repair: torch's own gradients at the ties."""
    zero = torch.zeros(1, requires_grad=True)
    for own, want in ((lambda x: F.leaky_relu(x, 0.01), np.float32(0.01)), (torch.abs, 0.0),
                      (lambda x: torch.clamp_min(x, 0.0), 1.0)):
        (g,) = torch.autograd.grad(own(zero).sum(), zero)
        assert g.item() == want
    assert jax.grad(jax.nn.leaky_relu)(0.0) == 1.0
    assert jax.grad(jnp.abs)(0.0) == 1.0
    assert jax.grad(lambda x: jnp.maximum(x, 0.0))(0.0) == 0.5


def _tied_net(seed=0):
    """A reduced leaky_relu SkipConnMLP pair whose init-layer unit 0 has a
    pre-activation of exactly 0 at x = 0, and whose hidden layer 1 unit 2 has
    one of exactly 0 at every row."""
    cfg = dict(in_size=3, out=2, num_layers=3, hidden_size=8, freqs=2)
    jmlp = JMLP(**cfg)
    tree = jax.tree.map(lambda a: np.array(a, np.float32), jmlp.init(jax.random.PRNGKey(seed)))
    tree["init"]["b"][0] = 0.0
    tree["init"]["w"][3 + cfg["freqs"]:, 0] = 0.0     # the cos rows: cos(0) = 1
    tree["layers"][1]["w"][:, 2] = 0.0
    tree["layers"][1]["b"][2] = 0.0
    return jmlp, tree, load_jax_params(SkipConnMLP(**cfg), tree, device="cpu")


def _net_inputs(n=32, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    x[0] = 0.0
    return x, rng.normal(size=(n, 2)).astype(np.float32)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_net_has_the_exact_zero_pre_activations():
    _, _, mlp = _tied_net()
    x, _ = _net_inputs()
    enc = torch.cat([torch.from_numpy(x), torch.sin(torch.from_numpy(x) @ mlp.B),
                     torch.cos(torch.from_numpy(x) @ mlp.B)], dim=-1)
    pre0 = enc @ mlp.init.w + mlp.init.b
    assert pre0[0, 0].item() == 0.0
    h = mlp.activation(pre0)
    h = mlp.layers[0](torch.cat([mlp.activation(h), mlp.activation(enc)], dim=-1))
    pre1 = mlp.layers[1](mlp.activation(h))
    assert (pre1[:, 2] == 0.0).all()


def test_net_first_derivatives_match_jax_at_exact_zeros():
    jmlp, tree, mlp = _tied_net()
    x, w = _net_inputs()

    def jloss(params, xx):
        return jnp.sum(jmlp(params, xx) * w)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(tree, jnp.asarray(x))
    xx = torch.from_numpy(x).requires_grad_()
    torch.sum(mlp(xx) * torch.from_numpy(w)).backward()
    _close(xx.grad.numpy(), jgx)
    _close(mlp.layers[1].w.grad.numpy(), jgp["layers"][1]["w"])
    _close(mlp.init.w.grad.numpy(), jgp["init"]["w"])
    _close(mlp.init.b.grad.numpy(), jgp["init"]["b"])
    # torch's own leaky_relu takes 0.01 of the tied unit's gradient
    mlp.zero_grad()
    mlp.activation = lambda h: F.leaky_relu(h, 0.01)
    torch.sum(mlp(torch.from_numpy(x)) * torch.from_numpy(w)).backward()
    with pytest.raises(AssertionError):
        _close(mlp.layers[1].w.grad.numpy(), jgp["layers"][1]["w"])


def test_net_second_derivatives_match_jax_at_exact_zeros():
    """The eikonal term's double backward: |d out / dx|^2 differentiated
    with respect to the weights."""
    jmlp, tree, mlp = _tied_net()
    x, _ = _net_inputs()

    def jeik(params):
        gx = jax.grad(lambda xx: jnp.sum(jmlp(params, xx)[:, 0]))(jnp.asarray(x))
        return jnp.sum(gx * gx)

    jgp = jax.grad(jeik)(tree)
    xx = torch.from_numpy(x).requires_grad_()
    (gx,) = torch.autograd.grad(mlp(xx)[:, 0].sum(), xx, create_graph=True)
    gx.square().sum().backward()
    _close(mlp.init.w.grad.numpy(), jgp["init"]["w"])
    _close(mlp.layers[1].w.grad.numpy(), jgp["layers"][1]["w"])
    _close(mlp.out.w.grad.numpy(), jgp["out"]["w"])


def _tied_crop(seed=3, n=2, s=16):
    """A crop with every loss term at a tie somewhere: logits of exactly 0
    (BCE's maximum and abs), active pixels with got == exp (L1's abs), and
    probabilities at exactly 1 and float32(1e-12) (BCE's clip)."""
    rng = np.random.default_rng(seed)
    got = rng.uniform(0, 1.2, (n, s, s, 3)).astype(np.float32)
    exp = rng.uniform(0, 1, (n, s, s, 3)).astype(np.float32)
    thr = rng.normal(scale=3.0, size=(n, s, s)).astype(np.float32)
    mask = (rng.uniform(size=(n, s, s)) > 0.4).astype(np.float32)
    thr[:, ::3, ::2] = 0.0
    got[:, 1::4] = exp[:, 1::4]
    return got, exp, thr, mask


@pytest.mark.parametrize("with_logits", [True, False])
@pytest.mark.parametrize("with_ssim", [True, False])
def test_masked_loss_gradients_match_jax_at_ties(with_logits, with_ssim):
    got, exp, thr, mask = _tied_crop()
    if not with_logits:
        thr = 1.0 / (1.0 + np.exp(-thr))
        thr[0, 0, :4] = np.float32(1e-12)
        thr[1, 2, :4] = 1.0
        thr[0, 3, :3] = 0.0
    kw = dict(mask_weight=15.0, with_logits=with_logits, with_ssim=with_ssim)

    def jloss(g, t):
        return jmasked_loss(g, jnp.asarray(exp), t, jnp.asarray(mask), **kw)

    want = jloss(jnp.asarray(got), jnp.asarray(thr))
    jgg, jgt = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(got), jnp.asarray(thr))
    g = torch.from_numpy(got).requires_grad_()
    t = torch.from_numpy(thr).requires_grad_()
    loss = masked_loss(g, torch.from_numpy(exp), t, torch.from_numpy(mask), **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    _close(g.grad.numpy(), jgg)
    _close(t.grad.numpy(), jgt)
