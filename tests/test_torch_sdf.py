"""Port parity: SphereSDF, the sphere-trace march, normals and intersect.

n = 8 spheres, a non-zero 2 x 16 softplus shift (uniform init), 256 rays
from z = 2 towards the origin.  The march runs unbounded (64 steps) and
bounded (march_bound 1.2, 256 steps), each with both smooth-mins, against
the JAX jnp march and, once each, the JAX Pallas kernel in interpret mode.
Tolerances: hit agreement >= 99%, |depth difference| <= 1e-4 where both
hit, and a hit fraction > 0; the SDF value rtol 1e-5 / atol 1e-6; normals
and interaction fields atol 1e-4 on common hits (they sit after the march).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu.nn import SkipConnMLP as JMLP
from neural_raytracing_tpu.shapes import SDF as JSDF
from neural_raytracing_tpu.shapes import SphereSDF as JSphereSDF
from neural_raytracing_tpu_torch import load_jax_params
from neural_raytracing_tpu_torch.kernels import march_plain, supports
from neural_raytracing_tpu_torch.nn import SkipConnMLP
from neural_raytracing_tpu_torch.shapes import SDF, SphereSDF

torch.set_num_threads(1)
SHIFT = dict(in_size=3, out=1, num_layers=2, hidden_size=16, freqs=4,
             activation="softplus", init="uniform")
CONFIGS = [(64, None), (256, 1.2)]    # (max_steps, march_bound)


def _surface(stable_min=False, seed=0):
    jmod = JSphereSDF(n=8, mlp=JMLP(**SHIFT), stable_min=stable_min)
    tree = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(seed)))
    tree["shift"]["out"] = {k: 0.1 * v for k, v in tree["shift"]["out"].items()}
    tree["radii"] = 0.3 + 0.5 * tree["radii"]
    assert np.abs(tree["shift"]["out"]["w"]).max() > 0
    mod = load_jax_params(SphereSDF(n=8, mlp=SkipConnMLP(**SHIFT),
                                    stable_min=stable_min), tree, device="cpu")
    return jmod, tree, mod


def _rays(n=256, seed=1):
    rng = np.random.default_rng(seed)
    r_o = np.zeros((n, 3), np.float32)
    r_o[:, 2] = 2.0
    r_o[:, :2] = rng.uniform(-0.1, 0.1, (n, 2))
    r_d = np.asarray([0.0, 0.0, -1.0]) + rng.normal(scale=0.3, size=(n, 3))
    r_d = (r_d / np.linalg.norm(r_d, axis=-1, keepdims=True)).astype(np.float32)
    return np.concatenate([r_o, r_d], axis=-1)


def _check_march(hit, depth, jhit, jdepth):
    hit, jhit = np.asarray(hit), np.asarray(jhit)
    assert jhit.mean() > 0 and hit.mean() > 0
    assert (hit == jhit).mean() >= 0.99
    both = hit & jhit
    np.testing.assert_allclose(np.asarray(depth)[both], np.asarray(jdepth)[both],
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("stable_min", [False, True])
def test_sphere_sdf_value(stable_min):
    jmod, tree, mod = _surface(stable_min)
    p = np.random.default_rng(2).uniform(-1.5, 1.5, (4, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(mod(torch.from_numpy(p)).detach().numpy(),
                               np.asarray(jmod(tree, jnp.asarray(p))),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("stable_min", [False, True])
@pytest.mark.parametrize("max_steps,bound", CONFIGS)
def test_intersect_matches_jax(max_steps, bound, stable_min):
    jmod, tree, mod = _surface(stable_min)
    jsdf = JSDF(jmod, max_steps=max_steps, march_bound=bound, fused_loops="off")
    sdf = SDF(mod, max_steps=max_steps, march_bound=bound)
    rays = _rays()
    jit_, jhit = jsdf.intersect(tree, jnp.asarray(rays), primary=False)
    it, hit = sdf.intersect(torch.from_numpy(rays), primary=False)
    _check_march(hit, it.t, jhit, jit_.t)
    both = np.asarray(hit) & np.asarray(jhit)
    for field in ("p", "n", "frame", "wi", "raw_normals"):
        np.testing.assert_allclose(getattr(it, field).detach().numpy()[both],
                                   np.asarray(getattr(jit_, field))[both],
                                   atol=1e-4, rtol=0, err_msg=field)
    assert not it.n.detach().numpy()[~np.asarray(hit)].any()


@pytest.mark.parametrize("max_steps,bound", CONFIGS)
def test_march_against_pallas_interpret(max_steps, bound):
    jmod, tree, mod = _surface()
    kw = dict(max_steps=max_steps, march_bound=bound)
    rays = _rays(n=128, seed=3)
    jit_, jhit = JSDF(jmod, fused_loops="force", **kw).intersect(
        tree, jnp.asarray(rays), primary=False)
    it, hit = SDF(mod, **kw).intersect(torch.from_numpy(rays), primary=False)
    _check_march(hit, it.t, jhit, jit_.t)


def test_march_plain_counts_the_evaluations_each_ray_needs():
    _, _, mod = _surface()
    rays = torch.from_numpy(_rays(n=64))
    depth, hit, evals = march_plain(mod, rays[:, :3], rays[:, 3:], 10.0,
                                    max_steps=64, epsilon=1e-3)
    assert (evals >= 1).all() and (evals <= 64).all()
    # a ray that hit stops being evaluated the step after its hit
    assert hit.any() and (evals[hit] < 64).all()


def test_normals_are_the_sdf_gradient():
    jmod, tree, mod = _surface()
    jsdf, sdf = JSDF(jmod), SDF(mod)
    p = np.random.default_rng(4).uniform(-0.5, 0.5, (64, 3)).astype(np.float32)
    want = jsdf.normals(tree, jnp.asarray(p))
    with torch.no_grad():
        got = sdf.normals(torch.from_numpy(p))
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    # under grad mode the normals stay differentiable (eikonal loss)
    got = sdf.normals(torch.from_numpy(p))
    (gw,) = torch.autograd.grad(got.square().sum(), mod.shift.layers[0].w)
    assert torch.isfinite(gw).all() and gw.abs().sum() > 0


def test_kernel_switch_on_cpu_tensors():
    _, _, mod = _surface()
    rays = torch.from_numpy(_rays(n=32))
    assert supports(mod)
    auto, off = SDF(mod, fused_loops="auto"), SDF(mod, fused_loops="off")
    a, ha = auto._march(rays[:, :3], rays[:, 3:], 10.0)
    b, hb = off._march(rays[:, :3], rays[:, 3:], 10.0)
    assert torch.equal(a, b) and torch.equal(ha, hb)
    with pytest.raises(ValueError, match="CUDA"):
        SDF(mod, fused_loops="force")._march(rays[:, :3], rays[:, 3:], 10.0)
    # primary intersections carry the silhouette throughput (plain min-scan)
    it, _ = auto.intersect(rays, primary=True)
    assert it.throughput.shape == rays.shape[:-1]
    assert torch.isfinite(it.throughput).all()
