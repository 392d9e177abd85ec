"""Port parity: NeRF alpha compositing (K8's plain version and its
autograd.Function) against the JAX package.

Inputs: odd sizes (T = 13 samples, a [5, 7] batch), sigma = relu(normal)
with one sample at sigma = 0 and one large enough (1e4) that 1 - alpha
underflows to the 1e-10 clamp, sigmoid(normal) colours, jittered sample
positions from 0 to 2.  The references are the JAX jnp ``volumetric_integrate``
and the JAX Pallas kernel ``volumetric_integrate_fused`` in interpret mode.
Tolerances: against the jnp form, values rtol 1e-5 / atol 1e-6 and sigma /
rgb gradients rtol 1e-4 / atol 1e-5 of the largest gradient (the same float32
operations, sums in another order); against the Pallas kernel, values 2e-5
absolute + 2e-5 relative (it takes the transmittance as exp of a log-prefix
sum), as ``tests/test_kernels.py`` holds it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu.kernels.composite import volumetric_integrate_fused
from neural_raytracing_tpu.shapes.nerf import volumetric_integrate as j_integrate
from neural_raytracing_tpu_torch.kernels import composite as K
from neural_raytracing_tpu_torch.kernels import (
    composite_apply, composite_plain, launch_counts, reset_launch_counts,
)
from neural_raytracing_tpu_torch.shapes import volumetric_integrate

torch.set_num_threads(1)
T_SAMPLES, BATCH = 13, (5, 7)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    sigma = np.maximum(rng.normal(size=(T_SAMPLES,) + BATCH), 0.0).astype(np.float32)
    sigma[3, 0, 0] = 0.0
    sigma[5, 1, 2] = 1e4                 # 1 - alpha underflows to the clamp
    rgb = (1.0 / (1.0 + np.exp(-rng.normal(size=sigma.shape + (3,))))).astype(np.float32)
    ts = np.linspace(0.0, 2.0 + 0.1 * rng.uniform(), T_SAMPLES).astype(np.float32)
    w = rng.normal(size=BATCH + (3,)).astype(np.float32)
    return sigma, rgb, ts, w


def _jax(sigma, rgb, ts, w):
    def f(s, c):
        return jnp.sum(j_integrate(s, c, jnp.asarray(ts), fused="off") * w)
    out = j_integrate(jnp.asarray(sigma), jnp.asarray(rgb), jnp.asarray(ts), fused="off")
    grads = jax.grad(f, argnums=(0, 1))(jnp.asarray(sigma), jnp.asarray(rgb))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _torch_grads(fn, sigma, rgb, ts, w):
    s = torch.from_numpy(sigma).requires_grad_()
    c = torch.from_numpy(rgb).requires_grad_()
    out = fn(s, c, torch.from_numpy(ts))
    torch.sum(out * torch.from_numpy(w)).backward()
    return out.detach().numpy(), [s.grad.numpy(), c.grad.numpy()]


def _assert_grads(got, want):
    for g, wg in zip(got, want):
        np.testing.assert_allclose(g, wg, rtol=1e-4, atol=1e-5 * np.abs(wg).max())


@pytest.mark.parametrize("fn", ["composite_plain", "volumetric_integrate_off"])
def test_composite_matches_jax(fn):
    sigma, rgb, ts, w = _inputs()
    fns = {"composite_plain": composite_plain,
           "volumetric_integrate_off": lambda s, c, t: volumetric_integrate(s, c, t, fused="off")}
    want, want_g = _jax(sigma, rgb, ts, w)
    got, got_g = _torch_grads(fns[fn], sigma, rgb, ts, w)
    assert got.shape == BATCH + (3,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    _assert_grads(got_g, want_g)
    # the clamp and the zero density both reach the result
    assert got_g[0][5, 1, 2] == 0.0 and np.abs(want_g[0][:, 0, 0]).max() > 0


def test_composite_matches_the_pallas_kernel():
    sigma, rgb, ts, _ = _inputs(1)
    want = np.asarray(volumetric_integrate_fused(jnp.asarray(sigma), jnp.asarray(rgb),
                                                 jnp.asarray(ts), interpret=True))
    got = volumetric_integrate(torch.from_numpy(sigma), torch.from_numpy(rgb),
                               torch.from_numpy(ts)).numpy()
    assert np.all(np.abs(got - want) <= 2e-5 + 2e-5 * np.abs(want))


def test_autograd_function_recomputes_through_the_plain_version(monkeypatch):
    """The wiring of K8's autograd.Function on the CPU: the launch is swapped
    for the plain version, the backward is the Function's own recompute."""
    launches = []

    def fake_launch(s, c, t):
        launches.append(tuple(s.shape))
        return composite_plain(s, c, t)

    monkeypatch.setattr(K, "fused_composite", fake_launch)
    sigma, rgb, ts, w = _inputs(2)
    want, want_g = _jax(sigma, rgb, ts, w)
    got, got_g = _torch_grads(composite_apply, sigma, rgb, ts, w)
    assert launches == [(T_SAMPLES, BATCH[0] * BATCH[1])]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    _assert_grads(got_g, want_g)


def test_modes_on_cpu_tensors():
    sigma, rgb, ts, _ = (torch.from_numpy(a) for a in _inputs())
    reset_launch_counts()
    assert torch.equal(volumetric_integrate(sigma, rgb, ts),
                       volumetric_integrate(sigma, rgb, ts, fused="off"))
    with pytest.raises(ValueError, match="CUDA"):
        volumetric_integrate(sigma, rgb, ts, fused="force")
    with pytest.raises(ValueError, match="fused"):
        volumetric_integrate(sigma, rgb, ts, fused="on")
    # a colour with other than 3 channels takes the plain version in any mode
    four = torch.cat([rgb, rgb[..., :1]], dim=-1)
    assert volumetric_integrate(sigma, four, ts, fused="force").shape == BATCH + (4,)
    assert launch_counts()["fused_composite"] == 0


# ragged shapes (samples, batch): T = 1, T not a multiple of K8's segments,
# one ray, a ray count off a multiple of 32, no rays
RAGGED = [(1, (33,)), (7, (1,)), (65, (3, 11)), (100, (31,)), (17, (2, 32)), (64, (0,))]


@pytest.mark.parametrize("n_t,batch", RAGGED)
def test_composite_ragged_shapes_match_jax(n_t, batch):
    rng = np.random.default_rng(n_t)
    sigma = np.maximum(rng.normal(size=(n_t,) + batch), 0.0).astype(np.float32)
    if sigma.size:
        sigma.reshape(n_t, -1)[n_t // 2, 0] = 1e4     # the clamp
    rgb = (1.0 / (1.0 + np.exp(-rng.normal(size=sigma.shape + (3,))))).astype(np.float32)
    ts = np.linspace(0.0, 2.0, n_t).astype(np.float32)
    w = rng.normal(size=batch + (3,)).astype(np.float32)
    want, want_g = _jax(sigma, rgb, ts, w)
    got, got_g = _torch_grads(composite_plain, sigma, rgb, ts, w)
    assert got.shape == batch + (3,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if sigma.size:
        _assert_grads(got_g, want_g)
