"""Port parity: the colocate workload's new modules — the warps,
``local_reflect``, the Fresnel terms, ``Diffuse`` and ``Conductor``, the
procedural SDFs (``sphere_sdf``, ``box_sdf``, ``capsule_sdf``,
``FunctionalSDF``), ``Mask``, ``load_colocate_relight_grid``, the colocate
extra loss, and the dataset generator's render.

Seeded numpy inputs (and, for the generator, the JAX package's params) go
through the JAX function and its port.  The JAX generator's shapes come from
``scripts/make_dataset.py`` itself.

Tolerances: the warps, ``local_reflect``, the Fresnel terms and the SDFs
rtol 1e-5 and atol 1e-6 (values) and 1e-5 of the largest |derivative|
(derivatives; float32 in another order), NaN where JAX gives NaN (the
concentric map's centre, 0/0 under ``where`` in both); ``fresnel_diff_refl``
exactly (the same float arithmetic).  ``Conductor``'s threshold
``local_reflect(wi) . wo > 0.94`` is a hard step: a sum in another order may
tip a ray whose product lies within 1e-6 of 0.94, so the flags are compared
ray by ray, may differ only there and on at most 1% of the rays, and the
values and gradients are compared on the rays whose flags agree, rtol 1e-5
and 1e-5 of the largest value or gradient.  torch's softplus is linear
above 20 and jax's is not; at the ``eta`` used here (1.1) they agree to
float32 rounding.  The generator's render (16x16, hard shadows,
``Mask(Direct(horizon_mask=True))``): the mask channel equal on >= 99% of
the pixels and the colour within 1e-4 where both masks are 1 on all but 1%
(a tipped threshold or shadow flag), the loader bit for bit.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import make_dataset as jmake  # noqa: E402  (scripts/make_dataset.py)

import neural_raytracing_tpu as J  # noqa: E402
from neural_raytracing_tpu.bsdf import ComposeSpatialVarying as JCompose  # noqa: E402
from neural_raytracing_tpu.bsdf import Conductor as JConductor  # noqa: E402
from neural_raytracing_tpu.bsdf import Diffuse as JDiffuse  # noqa: E402
from neural_raytracing_tpu.cameras import FoVPerspectiveCamera as JFoV  # noqa: E402
from neural_raytracing_tpu.cameras import look_at_view_transform as j_look_at  # noqa: E402
from neural_raytracing_tpu.integrators import Direct as JDirect  # noqa: E402
from neural_raytracing_tpu.integrators import Mask as JMask  # noqa: E402
from neural_raytracing_tpu.interaction import Interaction as JInteraction  # noqa: E402
from neural_raytracing_tpu.lights import PointLights as JPointLights  # noqa: E402
from neural_raytracing_tpu.nn import SkipConnMLP as JMLP  # noqa: E402
import neural_raytracing_tpu.ops.fresnel  # noqa: E402,F401
import neural_raytracing_tpu.ops.math  # noqa: E402,F401
import neural_raytracing_tpu.ops.warps  # noqa: E402,F401
import neural_raytracing_tpu.shapes.sdf  # noqa: E402,F401
from neural_raytracing_tpu.training.datasets import (  # noqa: E402
    load_colocate_relight_grid as j_load_relight,
)
from neural_raytracing_tpu_torch.bsdf import Conductor, Diffuse  # noqa: E402
from neural_raytracing_tpu_torch.integrators import Direct, Mask  # noqa: E402
from neural_raytracing_tpu_torch.interaction import Interaction  # noqa: E402
from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP, supports  # noqa: E402
from neural_raytracing_tpu_torch.ops import warps  # noqa: E402
from neural_raytracing_tpu_torch.ops import math as tmath  # noqa: E402
from neural_raytracing_tpu_torch.params import load_jax_params  # noqa: E402
from neural_raytracing_tpu_torch.shapes import (  # noqa: E402
    SDF, UNIT_SPHERE, FunctionalSDF, box_sdf, capsule_sdf, sphere_sdf,
)
from neural_raytracing_tpu_torch.training import load_colocate_relight_grid  # noqa: E402
from neural_raytracing_tpu_torch.workloads import colocate  # noqa: E402
from neural_raytracing_tpu_torch.workloads import make_dataset  # noqa: E402

torch.set_num_threads(1)
# the JAX modules by name: the package exports functions under some of them
jfresnel, jmath, jwarps, jsdf = (sys.modules[f"neural_raytracing_tpu.{m}"] for m in (
    "ops.fresnel", "ops.math", "ops.warps", "shapes.sdf"))
fresnel = sys.modules["neural_raytracing_tpu_torch.ops.fresnel"]


def _grad_np(fn_t, x):
    """-> (value, d sum(value * w) / dx) of a port function at numpy ``x``."""
    xt = torch.from_numpy(x).requires_grad_()
    y = fn_t(xt)
    w = torch.from_numpy(np.random.default_rng(99).normal(size=tuple(y.shape))
                         .astype(np.float32))
    (g,) = torch.autograd.grad(torch.sum(y * w), xt)
    return y.detach().numpy(), g.numpy(), w.numpy()


def _jax_grad(fn_j, x, w):
    return jax.grad(lambda a: jnp.sum(fn_j(a) * w))(jnp.asarray(x))


def _close_gradient(got, want, what):
    """Gradients ``[n, 3]``: torch's norm takes the subgradient 0 at a zero
    vector where jnp.linalg.norm's gradient is NaN (a point inside the box,
    on a capsule's axis); compare where JAX's is finite."""
    want = np.asarray(want)
    finite = np.isfinite(want).all(-1)
    assert np.isfinite(got).all() and finite.mean() > 0.5, what
    _close(got[finite], want[finite], what, scale=1e-5)
    return ~finite


def _close(got, want, what, rtol=1e-5, scale=1e-6):
    want = np.asarray(want)
    finite = np.isfinite(want)
    atol = scale * (np.abs(want[finite]).max() if finite.any() else 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


# ---- warps, local_reflect -------------------------------------------------------------

def _warp_input(name):
    rng = np.random.default_rng(11)
    if name == "circ":
        x = rng.uniform(-1.2, 1.2, size=64)
        x[:4] = [1.0, -1.0, 0.0, 1.0 - 2.0 ** -24]     # at and past the 1e-10 clamp
        return x.astype(np.float32)
    if name in ("square_to_cos_hemisphere_pdf", "local_reflect"):
        d = rng.normal(size=(64, 3))
        d[:2, 2] = [0.0, -0.5]
        return d.astype(np.float32)
    s = rng.uniform(size=(64, 2))
    # centre (0/0 under where: NaN derivatives in both), corners (the cosine
    # hemisphere's 1e-7 clamp, the sphere's poles), the diagonal, an edge
    s[:6] = [[0.5, 0.5], [0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [0.25, 0.75], [0.5, 0.0]]
    return s.astype(np.float32)


@pytest.mark.parametrize("name", ["circ", "square_to_uniform_disk_concentric",
                                  "square_to_uniform_sphere", "square_to_cos_hemisphere",
                                  "square_to_cos_hemisphere_pdf", "local_reflect"])
def test_warps_match_jax(name):
    x = _warp_input(name)
    mod_t, mod_j = (tmath, jmath) if name == "local_reflect" else (warps, jwarps)
    got, g, w = _grad_np(getattr(mod_t, name), x)
    want = getattr(mod_j, name)(jnp.asarray(x))
    _close(got, want, name)
    jg = _jax_grad(getattr(mod_j, name), x, w)
    _close(g, jg, name + " derivative", scale=1e-5)
    assert warps.square_to_uniform_sphere_pdf(x) == jwarps.square_to_uniform_sphere_pdf(x)


# ---- Fresnel ---------------------------------------------------------------------------

COS = np.concatenate([np.linspace(-1.0, 1.0, 41),
                      [0.0, 1e-6, -1e-6, 0.2, -0.2, 0.999]]).astype(np.float32)


@pytest.mark.parametrize("eta", [1.5, 0.7, 1.0])
def test_fresnel_matches_jax(eta):
    # eta 0.7: total internal reflection on the outside, cos_tt^2 under the
    # 1e-10 clamp; cos_t 0: the special case; cos_t < 0: the inside
    ct = torch.from_numpy(COS).requires_grad_()
    got = fresnel.fresnel(ct, eta)
    want = jfresnel.fresnel(jnp.asarray(COS), eta)
    for a, b, what in zip(got, want, ("r", "cos_tt", "eta_it", "eta_ti")):
        _close(a.detach().numpy(), b, what)
    w1, w2 = np.random.default_rng(3).normal(size=(2, COS.size)).astype(np.float32)
    (g,) = torch.autograd.grad(torch.sum(got[0] * torch.from_numpy(w1))
                               + torch.sum(got[1] * torch.from_numpy(w2)), ct)

    def jfn(c):
        r, cos_tt, _, _ = jfresnel.fresnel(c, eta)
        return jnp.sum(r * w1) + jnp.sum(cos_tt * w2)

    jg = jax.grad(jfn)(jnp.asarray(COS))
    assert np.isfinite(g.numpy()).all()
    _close(g.numpy(), jg, "d/dcos", scale=1e-5)


def test_fresnel_diff_refl_matches_jax():
    for eta in (0.5, 0.9, 1.0, 1.33, 2.0):
        assert fresnel.fresnel_diff_refl(eta) == jfresnel.fresnel_diff_refl(eta)


@pytest.mark.parametrize("eta_i", [0.0, 1.0])
def test_fresnel_conductor_matches_jax(eta_i):
    # cos_t = +-1 puts 1 - cos^2 under the 1e-10 clamp
    eta_r = np.float32(1.54)
    ct = torch.from_numpy(COS).requires_grad_()
    er = torch.tensor(eta_r, requires_grad=True)
    ei = eta_i if eta_i == 0.0 else torch.tensor(np.float32(eta_i), requires_grad=True)
    got = fresnel.fresnel_conductor(ct, er, ei)
    w = np.random.default_rng(4).normal(size=COS.size).astype(np.float32)
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(w)),
                                [ct, er] + ([ei] if eta_i else []))

    def jfn(c, r, i):
        return jnp.sum(jfresnel.fresnel_conductor(c, r, i) * w)

    argnums = (0, 1, 2) if eta_i else (0, 1)
    ji = jnp.float32(eta_i) if eta_i else 0.0
    jgrads = jax.grad(jfn, argnums=argnums)(jnp.asarray(COS), jnp.float32(eta_r), ji)
    _close(got.detach().numpy(), jfresnel.fresnel_conductor(jnp.asarray(COS), eta_r, ji),
           "value")
    for a, b, what in zip(grads, jgrads, ("d/dcos", "d/deta_r", "d/deta_i")):
        assert np.isfinite(a.numpy()).all(), what
        _close(a.numpy(), b, what, scale=1e-5)


# ---- Diffuse and Conductor -------------------------------------------------------------

def _bsdf_case(n=512, seed=5):
    """wi with some rays below the horizon; wo at a cosine in [0.90, 0.98]
    of local_reflect(wi) on most rays (both sides of 0.94, some within 1e-7
    of it), random on the rest.  -> (p, wi, wo, active, dot in float64)."""
    rng = np.random.default_rng(seed)
    wi = rng.normal(size=(n, 3))
    wi[:, 2] = np.abs(wi[:, 2]) * np.where(rng.uniform(size=n) < 0.8, 1.0, -0.3)
    wi /= np.linalg.norm(wi, axis=-1, keepdims=True)
    refl = wi * [-1.0, -1.0, 1.0]
    perp = np.cross(refl, rng.normal(size=(n, 3)))
    perp /= np.linalg.norm(perp, axis=-1, keepdims=True)
    c = rng.uniform(0.90, 0.98, size=n)
    c[:16] = 0.94 + rng.uniform(-1e-7, 1e-7, size=16)
    wo = c[:, None] * refl + np.sqrt(1.0 - c * c)[:, None] * perp
    wo[-64:] = rng.normal(size=(64, 3))
    wo[-64:] /= np.linalg.norm(wo[-64:], axis=-1, keepdims=True)
    wi, wo = wi.astype(np.float32), wo.astype(np.float32)
    dot = np.sum(wi.astype(np.float64) * [-1.0, -1.0, 1.0] * wo, -1)
    p = rng.normal(size=(n, 3)).astype(np.float32)
    return p, wi, wo, rng.uniform(size=n) > 0.2, dot


BSDF_PARAMS = {
    "diffuse": {"reflectance": np.asarray([0.6, 0.3, 0.2], np.float32)},
    "conductor": {"specular": np.asarray([0.3, -0.5, 1.2], np.float32),
                  "eta": np.float32(1.1), "k": np.float32(0.8)},
}


@pytest.mark.parametrize("kind", ["diffuse", "conductor"])
def test_bsdf_eval_and_pdf_matches_jax(kind):
    p, wi, wo, active, dot = _bsdf_case()
    tree = BSDF_PARAMS[kind]
    jb = JDiffuse() if kind == "diffuse" else JConductor()
    tb = load_jax_params(Diffuse() if kind == "diffuse" else Conductor(), tree, device="cpu")
    jit = JInteraction(p=jnp.asarray(p), t=jnp.zeros(len(p)), wi=jnp.asarray(wi))
    jspec, jpdf, _ = jb.eval_and_pdf(jax.tree.map(jnp.asarray, tree), jit, jnp.asarray(wo),
                                     jnp.asarray(active))
    jspec, jpdf = np.asarray(jspec), np.asarray(jpdf)
    wot = torch.from_numpy(wo)
    it = Interaction(p=torch.from_numpy(p), t=torch.zeros(len(p)), wi=torch.from_numpy(wi))
    spec, pdf, aux = tb.eval_and_pdf(it, wot, torch.from_numpy(active))
    assert aux == {}
    if kind == "conductor":
        flags, jflags = pdf.numpy() > 0, jpdf > 0
        assert set(np.unique(jpdf)) == {0.0, 1.0}
        assert 0.1 < jflags.mean() < 0.9                 # both sides of the threshold
        assert (flags != jflags).mean() <= 0.01
        assert (np.abs(dot[flags != jflags] - 0.94) < 1e-6).all()
        assert not spec[~torch.from_numpy(active)].any()  # masked by active
        keep = flags == jflags
    else:
        keep = np.ones(len(p), bool)
        assert (spec[~torch.from_numpy(active)] != 0).any()   # not masked by active
    _close(spec.detach().numpy()[keep], jspec[keep], "spectrum")
    _close(pdf.numpy()[keep], jpdf[keep], "pdf")
    # gradients of a loss over the rays whose flags agree
    w = np.random.default_rng(6).normal(size=(len(p), 3)).astype(np.float32) * keep[:, None]
    torch.sum(spec * torch.from_numpy(w)).backward()

    def jfn(params):
        s, _, _ = jb.eval_and_pdf(params, jit, jnp.asarray(wo), jnp.asarray(active))
        return jnp.sum(s * w)

    jg = jax.grad(jfn)(jax.tree.map(jnp.asarray, tree))
    for name, g in jg.items():
        param = getattr(tb, name)
        # no gradient reaches k: torch leaves None where JAX has a zero
        tg = torch.zeros_like(param) if param.grad is None else param.grad
        assert torch.isfinite(tg).all(), name
        _close(tg.numpy(), g, name, scale=1e-5)
    if kind == "conductor":
        assert np.abs(jg["eta"]) > 0 and np.abs(jg["specular"]).max() > 0
        assert tb.k.grad is None and float(jg["k"]) == 0.0   # read only by sample()


def test_bsdf_parameters_and_reset():
    d, c = Diffuse((0.7, 0.3, 0.2)), Conductor()
    assert d.reflectance.shape == (3,) and c.eta.shape == () and c.k.shape == ()
    with torch.no_grad():
        d.reflectance.zero_()
        c.eta.fill_(5.0)
    d.reset_parameters()
    c.reset_parameters(torch.Generator())
    assert d.reflectance.tolist() == pytest.approx([0.7, 0.3, 0.2])
    assert c.eta.item() == pytest.approx(1.3) and c.k.item() == 1.0
    assert set(dict(c.named_parameters())) == set(JConductor().init())
    assert set(dict(d.named_parameters())) == set(JDiffuse().init())


# ---- the procedural SDFs ---------------------------------------------------------------

def _points(n=256, seed=7):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, size=(n, 3)).astype(np.float32)


@pytest.mark.parametrize("kind", make_dataset.KINDS)
def test_procedural_shapes_match_jax(kind):
    p = _points()
    jshape = jmake.procedural_shape(kind)
    shape = make_dataset.procedural_shape(kind)
    assert isinstance(shape.module, FunctionalSDF) and not supports(shape.module)
    assert (shape.max_steps, shape.dist) == (jshape.max_steps, jshape.dist) == (64, 4.0)
    got, g, w = _grad_np(shape.sdf, p)
    _close(got, jshape.sdf({}, jnp.asarray(p)), kind)
    assert (got < 0).any() and (got > 0).any()
    _close_gradient(g, _jax_grad(lambda a: jshape.sdf({}, a), p, w), kind + " gradient")


def _tie_points():
    """Points on the box's faces, edges and corner (the maximum/minimum/amax
    ties) and on the capsule's end planes (the clip's ties), plus random ones."""
    ties = [[0.3, 0.0, 0.0], [0.3, 0.2, 0.0], [0.3, 0.2, 0.1], [0.5, 0.4, 0.0],
            [0.0, 0.0, 0.0], [0.1, 0.2, 0.3], [0.2, 0.6, 0.3], [-0.1, 0.5, 0.05]]
    return np.concatenate([np.asarray(ties, np.float32), _points(64, 8)])


FUNCS = {
    "sphere": (lambda p: sphere_sdf(p + 0.25, 0.5),
               lambda p: jsdf.sphere_sdf(p + 0.25, 0.5)),
    "box": (lambda p: box_sdf(p, torch.tensor([0.3, 0.2, 0.1])),
            lambda p: jsdf.box_sdf(p, jnp.asarray([0.3, 0.2, 0.1]))),
    "capsule": (lambda p: capsule_sdf(p, torch.tensor([0.1, 0.2, 0.3]),
                                      torch.tensor([0.2, 0.6, 0.3]), 0.1),
                lambda p: jsdf.capsule_sdf(p, jnp.asarray([0.1, 0.2, 0.3]),
                                           jnp.asarray([0.2, 0.6, 0.3]), 0.1)),
}


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_sdf_functions_match_jax_at_their_ties(name):
    p = _tie_points()
    fn_t, fn_j = FUNCS[name]
    got, g, w = _grad_np(fn_t, p)
    _close(got, fn_j(jnp.asarray(p)), name)
    nan = _close_gradient(g, _jax_grad(fn_j, p, w), name + " gradient")
    # JAX's NaN only where the norm's argument is the zero vector
    f32 = lambda *v: np.asarray(v, np.float32)          # noqa: E731
    ends = [np.all(p == f32(0.1, 0.2, 0.3), -1), np.all(p == f32(0.2, 0.6, 0.3), -1)]
    zero = {"sphere": np.all(p + np.float32(0.25) == 0, -1),
            "box": np.all(np.abs(p) - f32(0.3, 0.2, 0.1) <= 0, -1),
            "capsule": ends[0] | ends[1]}[name]
    np.testing.assert_array_equal(nan, zero)


def test_functional_sdf_takes_the_plain_loops():
    assert list(UNIT_SPHERE.parameters()) == [] and list(UNIT_SPHERE.buffers()) == []
    sdf = SDF(FunctionalSDF(sphere_sdf), fused_loops="force", max_steps=32)
    rays = torch.tensor([[0.0, 0.0, 3.0, 0.0, 0.0, -1.0], [0.0, 2.0, 3.0, 0.0, 0.0, -1.0]])
    # "force" would raise on CPU tensors if a kernel were asked for
    assert not sdf._use_kernel(rays[:, :3])
    it, hit = sdf.intersect(rays, primary=False)
    assert hit.tolist() == [True, False]
    assert torch.allclose(it.n[0], torch.tensor([0.0, 0.0, 1.0]), atol=1e-5)
    assert sdf.intersect_test(rays, max_t=10.0).tolist() == [False, True]
    sdf.reset_parameters(torch.Generator())              # nothing to draw


# ---- the colocate extra loss -----------------------------------------------------------

def _jax_extra_loss(it, got, exp, mask):
    """scripts/colocate.py:118-127."""
    loss = jmath.eikonal_loss(it.raw_normals)
    var = jnp.var(it.normalized_weights, axis=-1)
    return loss + 1e-2 * jnp.mean(jnp.sqrt(jnp.maximum(var, 1e-12)))


@pytest.mark.parametrize("weights", ["random", "constant"])
def test_extra_loss_matches_jax(weights):
    # "constant": a zero-out weight net gives sigmoid(0) = 0.5 everywhere, a
    # variance of exactly 0, where a plain sqrt's gradient is NaN
    rng = np.random.default_rng(9)
    normals = rng.normal(size=(2, 8, 8, 1, 3)).astype(np.float32)
    raw = (rng.normal(size=(2, 8, 8, 1, 4)) if weights == "random"
           else np.zeros((2, 8, 8, 1, 4))).astype(np.float32)
    n_t, raw_t = torch.from_numpy(normals).requires_grad_(), torch.from_numpy(raw).requires_grad_()
    it = Interaction(p=n_t, t=n_t[..., 0], raw_normals=n_t,
                     normalized_weights=torch.sigmoid(raw_t))
    loss = colocate.extra_loss(it, None, None, None)
    loss.backward()

    def jfn(nn_, rr):
        return _jax_extra_loss(JInteraction(p=nn_, t=nn_[..., 0], raw_normals=nn_,
                                            normalized_weights=jax.nn.sigmoid(rr)),
                               None, None, None)

    jloss, (jgn, jgr) = jax.value_and_grad(jfn, argnums=(0, 1))(jnp.asarray(normals),
                                                                 jnp.asarray(raw))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert torch.isfinite(n_t.grad).all() and torch.isfinite(raw_t.grad).all()
    _close(n_t.grad.numpy(), jgn, "d/dnormals", scale=1e-5)
    _close(raw_t.grad.numpy(), jgr, "d/draw", scale=1e-5)
    if weights == "constant":
        assert not raw_t.grad.any() and not np.asarray(jgr).any()
    # no mixture weights: the eikonal term alone
    plain = colocate.extra_loss(Interaction(p=n_t, t=n_t[..., 0], raw_normals=n_t),
                                None, None, None)
    np.testing.assert_allclose(plain.item(), float(jmath.eikonal_loss(jnp.asarray(normals))),
                               rtol=1e-5)


# ---- the relight-grid loader -----------------------------------------------------------

def test_load_colocate_relight_grid_matches_jax(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(10)
    keys = [(0, 0, 0, 0), (1, 2, 0, 1), (3, 3, 2, 2), (2, 1, 1, 0)]
    for i, j, k, l in keys:
        arr = rng.integers(0, 256, size=(20, 20, 4), dtype=np.uint8)
        Image.fromarray(arr, "RGBA").save(tmp_path / f"gt_bunny_{i}_{j}_{k}_{l}.png")
    got = load_colocate_relight_grid(str(tmp_path), "bunny", 16)
    want = j_load_relight(str(tmp_path), "bunny", 16)
    assert sorted(got) == sorted(want) == sorted(keys)       # missing files left out
    for key in keys:
        assert got[key].dtype == want[key].dtype and got[key].shape == (16, 16, 4)
        np.testing.assert_array_equal(got[key], want[key])
    assert load_colocate_relight_grid(str(tmp_path), "teapot", 16) == {}


# ---- the generator's render ------------------------------------------------------------

def _jax_generator_scene(kind):
    """The scene of scripts/make_dataset.py:104-116."""
    return J.Scene(
        shape=jmake.procedural_shape(kind),
        bsdf=JCompose([JDiffuse((0.7, 0.3, 0.2)), JDiffuse((0.2, 0.4, 0.7)), JConductor()],
                      sp_var_fn=JMLP(in_size=3, out=3, num_layers=2, hidden_size=32,
                                     freqs=8, sigma=8.0)),
        lights=JPointLights(scale=1.5), occlusion="hard")


# the relight grid's lights (scripts/make_dataset.py:147-148)
J_LIGHT_ELEVS, J_LIGHT_AZIMS = np.linspace(10.0, 60.0, 3), np.linspace(-90.0, 90.0, 3)
# (camera elevation, azimuth, light): colocated, and a relight-grid light
GEN_VIEWS = [(20.0, -45.0, None), (30.0, 60.0, (1, 2))]


@functools.lru_cache(maxsize=None)
def _generator_case(kind):
    jscene = _jax_generator_scene(kind)
    tree = jax.tree.map(np.asarray, jscene.init(jax.random.PRNGKey(7)))
    scene = load_jax_params(make_dataset.build_scene(kind, 1.5), tree, device="cpu")
    wants = []
    for elev, azim, light in GEN_VIEWS:
        r, t = j_look_at(dist=1.0, elev=elev, azim=azim)
        cam = JFoV(R=r, T=t)
        if light is None:
            loc = np.asarray(cam.camera_center()) * 1.05
        else:
            lr, lt = j_look_at(dist=1.05, elev=J_LIGHT_ELEVS[light[0]],
                               azim=J_LIGHT_AZIMS[light[1]])
            loc = np.asarray(JFoV(R=lr, T=lt).camera_center())
        p = dict(tree)
        p["lights"] = dict(p["lights"], location=jnp.asarray(loc))
        img, _ = J.pathtrace(jscene, p, cam, JMask(JDirect(training=False, horizon_mask=True)),
                             size=16, chunk_size=16, bundle_size=1, background=0.0, key=None)
        wants.append((np.clip(np.asarray(img), 0, 1), loc))
    return scene, wants


def test_generator_grid_matches_the_jax_script():
    np.testing.assert_array_equal(make_dataset.LIGHT_ELEVS, J_LIGHT_ELEVS)
    np.testing.assert_array_equal(make_dataset.LIGHT_AZIMS, J_LIGHT_AZIMS)
    np.testing.assert_array_equal(make_dataset.CAM_ELEVS, np.linspace(0.0, 45.0, 4))
    np.testing.assert_array_equal(make_dataset.CAM_AZIMS, np.linspace(-135.0, 135.0, 4))
    loc = make_dataset.relight_light(2, 0).numpy()
    lr, lt = j_look_at(dist=1.05, elev=60.0, azim=-90.0)
    np.testing.assert_allclose(loc, np.asarray(JFoV(R=lr, T=lt).camera_center()), atol=1e-6)


@pytest.mark.parametrize("view", range(len(GEN_VIEWS)))
def test_generator_render_matches_jax(view):
    scene, wants = _generator_case("bunny")
    want, loc = wants[view]
    elev, azim, _ = GEN_VIEWS[view]
    # no fused net and no SphereSDF: the generator launches none of K1-K5
    assert not any(isinstance(m, FusedSkipConnMLP) for m in scene.modules())
    assert not supports(scene.shape.module)
    got = make_dataset.render_view(scene, elev, azim, loc, size=16, key=None, device="cpu")
    assert got.shape == want.shape == (16, 16, 4)
    mask, jmask = got[..., 3], want[..., 3]
    assert set(np.unique(jmask)) <= {0.0, 1.0} and 0.1 < jmask.mean() < 0.9
    assert (mask == jmask).mean() >= 0.99
    both = (mask == 1) & (jmask == 1)
    diff = np.abs(got[..., :3] - want[..., :3])[both]
    assert (diff.max(-1) <= 1e-4).mean() >= 0.99
    assert want[..., :3][both].max() > 0.05                 # lit
    assert not got[..., :3][mask == 0].any()                # background 0


def test_mask_integrator_dims_and_alpha():
    assert Mask(Direct()).dims() == 4 == JMask(JDirect()).dims()
