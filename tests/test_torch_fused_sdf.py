"""Port parity: K5, the fused SphereSDF evaluation, and ``FusedSphereSDF``.

On the CPU ``FusedSphereSDF`` takes its plain version (``sphere_sdf_plain``);
the JAX side runs ``_jnp_forward`` and its Pallas kernel in interpret mode
(``fused_sphere_sdf_apply``, ``block_rows=64``), whose backward recomputes
through ``_jnp_forward``.  The port's ``autograd.Function`` around K5 is
exercised on the CPU with the kernel swapped for its plain version, so its
recompute backward (first and second order) is held against plain autograd.
The surface is 8 spheres with the narrow shift of ``test_torch_params``
(non-zero), 200 seeded points in [-1, 1]^3.

Tolerances: values rtol 1e-5 / atol 1e-6; first derivatives rtol 1e-4 /
atol 1e-5 of the largest; second derivatives (the gradient of the eikonal
term |grad_p f|^2) rtol 1e-4 / atol 1e-4 of the largest (float32 sums in
another order through two backward passes and the Fourier features).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu.kernels.fused_sdf import FusedSphereSDF as JFusedSphereSDF
from neural_raytracing_tpu.kernels.fused_sdf import _jnp_forward
from neural_raytracing_tpu.nn import SkipConnMLP as JMLP
import neural_raytracing_tpu_torch.kernels.fused_sdf as fsdf
from neural_raytracing_tpu_torch.kernels import (
    FusedSphereSDF, launch_counts, reset_launch_counts,
)
from neural_raytracing_tpu_torch.nn import SkipConnMLP
from neural_raytracing_tpu_torch.params import load_jax_params, state_dict_from_jax
from neural_raytracing_tpu_torch.shapes import SDF, SphereSDF
from neural_raytracing_tpu_torch.training.checkpoint import load_pytree
from test_torch_params import NETS

torch.set_num_threads(1)
ARTIFACTS = "scripts/models_seed_dir/nerv_mesh_gear_mirror200b"


def _pair(stable_min):
    jmod = JFusedSphereSDF(n=8, mlp=JMLP(**NETS["shift"]), mode="force", block_rows=64,
                           stable_min=stable_min)
    tree = jax.tree.map(np.asarray, jmod.init(jax.random.PRNGKey(3)))
    tree["radii"] = 0.3 + 0.5 * tree["radii"]
    tree["shift"]["out"] = {k: 0.1 * v for k, v in tree["shift"]["out"].items()}
    port = load_jax_params(FusedSphereSDF(n=8, mlp=SkipConnMLP(**NETS["shift"]),
                                          stable_min=stable_min), tree, device="cpu")
    return jmod, tree, port


def _points(n=200, seed=4):
    return (2.0 * np.random.default_rng(seed).uniform(size=(n, 3)) - 1.0).astype(np.float32)


def _jax_derivatives(fn, tree, x):
    """(values, d sum(f w)/d(params, x), d sum(|grad_x f|^2)/d params)."""
    w = np.random.default_rng(5).normal(size=x.shape[0]).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    vals = fn(params, jnp.asarray(x))
    g1 = jax.grad(lambda pr, xx: jnp.sum(fn(pr, xx) * w), argnums=(0, 1))(params, jnp.asarray(x))

    def eik(pr):
        gx = jax.grad(lambda xx: jnp.sum(fn(pr, xx)))(jnp.asarray(x))
        return jnp.sum(gx * gx)

    return np.asarray(vals), g1, jax.grad(eik)(params), w


def _port_derivatives(module, x, w):
    xx = torch.from_numpy(x).requires_grad_()
    vals = module(xx)
    names = [k for k, _ in module.named_parameters()]
    params = [p for _, p in module.named_parameters()]
    g1 = torch.autograd.grad(torch.sum(vals * torch.from_numpy(w)), params + [xx])
    xx2 = torch.from_numpy(x).requires_grad_()
    (gx,) = torch.autograd.grad(module(xx2).sum(), xx2, create_graph=True)
    # the output bias does not reach the gradient: None there
    g2 = torch.autograd.grad(torch.sum(gx * gx), params, allow_unused=True)
    g2 = [torch.zeros_like(p) if g is None else g for p, g in zip(params, g2)]
    return (vals.detach().numpy(), dict(zip(names, [g.numpy() for g in g1[:-1]])),
            g1[-1].numpy(), dict(zip(names, [g.numpy() for g in g2])))


def _flat(tree):
    return {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, tree)).items()}


def _close(got, want, rel):
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * max(np.abs(want).max(), 1e-12))


@pytest.mark.parametrize("stable_min", [False, True])
@pytest.mark.parametrize("jax_path", ["jnp", "pallas_interpret"])
def test_fused_sphere_sdf_matches_jax(stable_min, jax_path):
    jmod, tree, port = _pair(stable_min)
    fn = ((lambda pr, xx: _jnp_forward(jmod, pr, xx)) if jax_path == "jnp"
          else (lambda pr, xx: jmod(pr, xx)))
    x = _points()
    want, (jg, jgx), jg2, w = _jax_derivatives(fn, tree, x)
    got, g1, gx, g2 = _port_derivatives(port, x, w)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    _close(gx, np.asarray(jgx), 1e-4)
    fj, f2 = _flat(jg), _flat(jg2)
    for k in g1:
        _close(g1[k], fj[k], 1e-4)
        _close(g2[k], f2[k], 1e-4)


def test_autograd_function_recomputes_through_the_plain_version(monkeypatch):
    """K5's autograd.Function, with the kernel swapped for its plain version:
    the values, first and second derivatives equal plain autograd's."""
    def plain_kernel(module, p):
        fsdf.fused_sphere_sdf.launches += 1
        with torch.no_grad():
            return fsdf.sphere_sdf_plain(module, p, module.centers, module.radii,
                                         module.tfs, module.shift.B,
                                         module.shift.flat_weights())

    plain_kernel.launches = 0
    _, tree, port = _pair(False)
    x = _points(64)
    w = np.random.default_rng(6).normal(size=64).astype(np.float32)
    want = _port_derivatives(port, x, w)
    monkeypatch.setattr(fsdf, "fused_sphere_sdf", plain_kernel)
    monkeypatch.setattr(FusedSphereSDF, "forward",
                        lambda self, p: fsdf.fused_sphere_sdf_apply(self, p))
    got = _port_derivatives(port, x, w)
    assert plain_kernel.launches == 2      # the two forwards; backwards recompute
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[2], want[2], rtol=1e-6, atol=1e-7)
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(got[3][k], want[3][k], rtol=1e-5, atol=1e-6)


def test_plain_version_is_sphere_sdf_forward_and_checkpoints_load_into_either():
    tree = load_pytree(f"{ARTIFACTS}/shape.msgpack")
    plain = load_jax_params(SphereSDF(n=128), tree, device="cpu")
    fused = load_jax_params(FusedSphereSDF(n=128), tree, device="cpu")
    assert isinstance(fused.shift, SkipConnMLP) and fused.shift.hidden_size == 128
    assert fused.shift.num_layers == 8 and fused.shift.freqs == 32
    assert fused.shift.activation_name == "softplus"
    x = torch.from_numpy(_points(300, seed=7))
    with torch.no_grad():
        np.testing.assert_array_equal(fused(x).numpy(), plain(x).numpy())
    reset_launch_counts()
    # SDF over either surface gives the same march and shadow test
    a, b = SDF(plain, max_steps=32), SDF(fused, max_steps=32)
    rays = torch.cat([torch.tensor([0.0, 0.0, 2.0]).expand(64, 3),
                      torch.nn.functional.normalize(torch.tensor([0.0, 0.0, -1.0])
                                                    + 0.3 * x[:64], dim=-1)], -1)
    with torch.no_grad():
        (ia, ha), (ib, hb) = a.intersect(rays, primary=False), b.intersect(rays, primary=False)
        assert torch.equal(ha, hb) and ha.any()
        torch.testing.assert_close(ia.p, ib.p, rtol=0, atol=1e-6)
        up = torch.nn.functional.normalize(torch.tensor([0.3, 1.0, 0.2]), dim=0)
        shadow = torch.cat([ia.p, up.expand(64, 3)], -1)
        assert torch.equal(a.intersect_test(shadow, 3.0), b.intersect_test(shadow, 3.0))
    assert all(v == 0 for v in launch_counts().values())


# K5's route by the shift net's shape and the sphere count (k5_route), with
# nothing launched: the flagship / NeRV shift and the tile's widest net take
# the tile; a net past its widths or a sphere set past its h rows the
# general kernel; a surface neither kernel takes raises
_SHIFT = dict(in_size=3, out=1, num_layers=8, hidden_size=128, freqs=32,
              activation="softplus")
K5_ROUTE_CASES = {
    "flagship shift": (_SHIFT, 128, "tile"),
    "widest tile net": (dict(_SHIFT, hidden_size=256, freqs=128, num_layers=32), 128, "tile"),
    "hidden 257": (dict(_SHIFT, hidden_size=257), 128, "general"),
    "freqs 129": (dict(_SHIFT, freqs=129), 128, "general"),
    "most spheres at NP 128": (_SHIFT, 654, "tile"),
    "one sphere more": (_SHIFT, 655, "general"),
    "most spheres at NP 256": (dict(_SHIFT, hidden_size=200), 1324, "tile"),
    "one more at NP 256": (dict(_SHIFT, hidden_size=200), 1325, "general"),
}


@pytest.mark.parametrize("case", sorted(K5_ROUTE_CASES))
def test_k5_route_by_shape(case):
    shift, n, route = K5_ROUTE_CASES[case]
    module = FusedSphereSDF(n=n, mlp=SkipConnMLP(**shift))
    reset_launch_counts()
    assert fsdf.k5_route(module) == route
    assert fsdf.k5_route(SphereSDF(n=n, mlp=SkipConnMLP(**shift))) == route
    assert all(v == 0 for v in launch_counts().values())


def test_k5_route_default_surface_and_refusals():
    assert fsdf.k5_route(FusedSphereSDF()) == "tile"     # NeRV's --fused-sdf surface
    assert (fsdf.k5_tile_spheres(128), fsdf.k5_tile_spheres(256)) == (654, 1324)
    for shift in (dict(_SHIFT, out=2), dict(_SHIFT, latent_size=4), dict(_SHIFT, in_size=2)):
        with pytest.raises(ValueError, match="3 -> 1 shift net"):
            fsdf.k5_route(FusedSphereSDF(n=8, mlp=SkipConnMLP(**shift)))
    with pytest.raises(ValueError, match="at most 32"):
        fsdf.k5_route(FusedSphereSDF(n=8, mlp=SkipConnMLP(**dict(_SHIFT, num_layers=33))))
    # the route is refused before anything touches a device
    module = FusedSphereSDF(n=655, mlp=SkipConnMLP(**_SHIFT))
    with pytest.raises(ValueError, match="route"):
        fsdf.fused_sphere_sdf(module, torch.rand(4, 3), route="tile")
    with pytest.raises(ValueError, match="CUDA"):
        fsdf.fused_sphere_sdf(FusedSphereSDF(n=8, mlp=SkipConnMLP(**_SHIFT)), torch.rand(4, 3))
