"""Port parity: ops (encoding, math, frames, rusin) against the JAX package.

Inputs come from a seeded numpy generator and go through both functions.
Tolerance: atol 1e-6 (float32 elementwise math, same formulas).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu.ops import encoding as jenc
from neural_raytracing_tpu.ops import frames as jframes
from neural_raytracing_tpu.ops import math as jmath
from neural_raytracing_tpu.ops import rusin as jrusin
from neural_raytracing_tpu_torch.ops import encoding, frames, math as tmath, rusin

torch.set_num_threads(1)
ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=atol, rtol=0)


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_fourier_encode_matches_and_stops_basis_gradient():
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (64, 3)).astype(np.float32)
    basis = (4.0 * rng.normal(size=(3, 8))).astype(np.float32)
    got = encoding.fourier_encode(_t(x), _t(basis))
    _close(got, jenc.fourier_encode(jnp.asarray(x), jnp.asarray(basis)), atol=1e-5)
    assert encoding.fourier_size(8, 3) == got.shape[-1] == 19
    b = _t(basis).requires_grad_()
    xt = _t(x).requires_grad_()
    encoding.fourier_encode(xt, b).sum().backward()
    assert b.grad is None and xt.grad is not None


def test_normalize_including_zero_vector():
    rng = np.random.default_rng(1)
    v = rng.normal(size=(32, 3)).astype(np.float32)
    v[0] = 0.0
    v[1] = 1e-9
    _close(tmath.normalize(_t(v)), jmath.normalize(jnp.asarray(v)))
    _close(tmath.normalize(_t(v), eps=1e-6), jmath.normalize(jnp.asarray(v), eps=1e-6))
    z = torch.zeros(1, 3, requires_grad=True)
    tmath.normalize(z).sum().backward()
    assert torch.isfinite(z.grad).all()


@pytest.mark.parametrize("fn", ["smooth_min", "stable_smooth_min"])
def test_smooth_mins_near_and_on_the_plateau(fn):
    rng = np.random.default_rng(2)
    # rows near the surface and far away, where the clamped form plateaus
    v = np.concatenate([rng.uniform(-0.2, 0.2, (16, 40)),
                        rng.uniform(1.0, 3.0, (16, 40))], axis=1).astype(np.float32)
    got = getattr(tmath, fn)(_t(v), k=32.0, dim=0)
    _close(got, getattr(jmath, fn)(jnp.asarray(v), k=32.0, axis=0))
    if fn == "smooth_min":
        np.testing.assert_allclose(got[40:].numpy(), -np.log(1e-4) / 32.0, atol=ATOL)


def test_nonzero_eps_and_rotate_vector():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(32, 3)).astype(np.float32)
    v[:4] = 1e-9
    _close(tmath.nonzero_eps(_t(v)), jmath.nonzero_eps(jnp.asarray(v)))
    axis = _unit(rng, 32)
    ang = rng.uniform(-np.pi, np.pi, (32, 1)).astype(np.float32)
    c, s = np.cos(ang), np.sin(ang)
    _close(tmath.rotate_vector(_t(v), _t(axis), _t(c), _t(s)),
           jmath.rotate_vector(*map(jnp.asarray, (v, axis, c, s))))


def test_frames_coordinate_system_to_and_from_local():
    rng = np.random.default_rng(4)
    n = _unit(rng, 64)
    n[0] = [0.0, 0.0, 1.0]
    n[1] = [0.0, 0.0, -1.0]          # the pole of the branchless basis
    n[2] = 0.0                        # misses carry zero normals
    w = _unit(rng, 64)
    frame = frames.coordinate_system(_t(n))
    jframe = jframes.coordinate_system(jnp.asarray(n))
    _close(frame, jframe)
    _close(frames.to_local(frame, _t(w)), jframes.to_local(jframe, jnp.asarray(w)))
    _close(frames.from_local(frame, _t(w)), jframes.from_local(jframe, jnp.asarray(w)))


def test_param_rusin2_including_grazing_directions():
    rng = np.random.default_rng(5)
    wo, wi = _unit(rng, 64), _unit(rng, 64)
    wo[:8, 2] = 1e-4                 # grazing light directions
    wi[8:16, 2] = -1e-4
    wi[16] = wo[16]                  # h along wo: h_z -> the 1e-6 clamp
    wo[17] = wi[17] = [0.0, 0.0, 1.0]
    wo, wi = wo / np.linalg.norm(wo, axis=-1, keepdims=True), wi / np.linalg.norm(wi, axis=-1, keepdims=True)
    _close(rusin.param_rusin2(_t(wo), _t(wi)),
           jrusin.param_rusin2(jnp.asarray(wo), jnp.asarray(wi)))
