"""Port parity: the other SDF surfaces (``RoundBoxSDF``, ``CapsuleSDF``,
``ParametricSDFSet``), ``shapes.prime`` and ``nn.prime_identity``, and the
NeRF-- and NeRV cameras.

Each surface takes the JAX package's params from ``init(PRNGKey(s))``;
seeded numpy points go through both packages, and the plain loops march
two 16x16 NeRFCamera views from distance 1.  ``prime`` runs on
the reduced flagship surface of ``test_torch_params``, ``prime_identity``
on a 2x16 net; both take 3 AdamW steps with the JAX package's uniforms
replayed from its key chain (``replay``), so both draw the same points.

Tolerances: surface values rtol 1e-5 / atol 1e-6 of the largest and
gradients rtol 1e-4 / atol 1e-5 of the largest (float32 in another order;
``box_sdf``'s norm at a zero vector is NaN in JAX and 0 in torch, ROADMAP
Queue 3's accepted note: points inside a box are left out of the parameter
gradients, and input gradients are compared where JAX's is finite); the
intersections as ``test_torch_path``'s integrators; ``prime``'s losses
rtol 1e-5 and its parameters within 1e-6 + 1e-4 relative (three Adam
steps of 1e-3; a gradient near 0 can flip the sign of its first step);
the camera rays rtol 1e-6 / atol 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu.cameras import NeRFMMCamera as JNeRFMM
from neural_raytracing_tpu.cameras import NeRVCamera as JNeRV
from neural_raytracing_tpu.nn import SkipConnMLP as JMLP
from neural_raytracing_tpu.nn.mlp import prime_identity as j_prime_identity
from neural_raytracing_tpu.shapes import SDF as JSDF
from neural_raytracing_tpu.shapes import sdf as jsdf_mod
from neural_raytracing_tpu_torch.cameras import NeRFCamera, NeRFMMCamera, NeRVCamera, nerf_c2w
from neural_raytracing_tpu_torch.nn import SkipConnMLP, prime_identity
from neural_raytracing_tpu_torch.params import load_jax_params, state_dict_from_jax
from neural_raytracing_tpu_torch.render import _tile_positions
from neural_raytracing_tpu_torch.shapes import (
    SDF, CapsuleSDF, ParametricSDFSet, RoundBoxSDF, prime, sphere_sdf,
)
from test_torch_bsdf_sampling import GEN, replay, uniform  # noqa: F401  (replay: a fixture)
from test_torch_occlusion import FOCAL
from test_torch_params import scene_pair
from test_torch_path import _compare

torch.set_num_threads(1)

SURFACES = {
    "round_box": (jsdf_mod.RoundBoxSDF, RoundBoxSDF, dict(n=8, k=16.0)),
    "capsule": (jsdf_mod.CapsuleSDF, CapsuleSDF, dict(n=8, k=16.0)),
    "parametric": (jsdf_mod.ParametricSDFSet, ParametricSDFSet, dict(num_shapes=4, k=32.0)),
}


def _flat(tree):
    return {k: v.numpy() for k, v in state_dict_from_jax(jax.tree.map(np.asarray, tree)).items()}


@functools.lru_cache(maxsize=None)
def _surface_tree(name, seed=0):
    jcls, _, kw = SURFACES[name]
    return jax.tree.map(np.asarray, jcls(**kw).init(jax.random.PRNGKey(seed)))


def _surface_pair(name, max_steps=64):
    jcls, cls, kw = SURFACES[name]
    tree = _surface_tree(name)
    return (JSDF(jcls(**kw), max_steps=max_steps), tree,
            load_jax_params(SDF(cls(**kw), max_steps=max_steps), tree, device="cpu"))


def _points(n=384, seed=0):
    return np.random.default_rng(seed).uniform(-0.9, 0.9, size=(n, 3)).astype(np.float32)


def _jax_values_and_grads(jsdf, tree, p, w):
    def loss(params, q):
        return jnp.sum(jsdf.sdf(params, q) * w)
    params = jax.tree.map(jnp.asarray, tree)
    gp, gq = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(p))
    return np.asarray(jax.jit(jsdf.sdf)(params, jnp.asarray(p))), _flat(gp), np.asarray(gq)


@pytest.mark.parametrize("name", sorted(SURFACES))
def test_surface_values_and_gradients_match_jax(name):
    jsdf, tree, sdf = _surface_pair(name)
    p = _points()
    w = np.random.default_rng(1).normal(size=len(p)).astype(np.float32)
    want, _, want_gq = _jax_values_and_grads(jsdf, tree, p, w)
    finite = np.isfinite(want_gq).all(-1)
    assert finite.mean() > 0.5
    # the parameter gradients over the points where JAX's are finite
    _, want_gp, _ = _jax_values_and_grads(jsdf, tree, p[finite], w[finite])
    q = torch.from_numpy(p).requires_grad_()
    got = sdf.sdf(q)
    torch.sum(got * torch.from_numpy(w)).backward()
    gq = q.grad.numpy()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    assert np.isfinite(gq).all()
    np.testing.assert_allclose(gq[finite], want_gq[finite], rtol=1e-4,
                               atol=1e-5 * np.abs(want_gq[finite]).max())
    sdf.zero_grad()
    q = torch.from_numpy(p[finite])
    torch.sum(sdf.sdf(q) * torch.from_numpy(w[finite])).backward()
    named = dict(sdf.named_parameters())
    assert set(named) == set(want_gp)
    for k, prm in named.items():
        g = torch.zeros_like(prm) if prm.grad is None else prm.grad
        np.testing.assert_allclose(g.numpy(), want_gp[k], rtol=1e-4,
                                   atol=1e-5 * max(np.abs(want_gp[k]).max(), 1e-6), err_msg=k)


@functools.lru_cache(maxsize=None)
def _rays():
    """Two 16x16 views from distance 1 (the surfaces at init are small)."""
    c2w = np.stack([nerf_c2w(30, 45, 1.0), nerf_c2w(-20, 160, 1.0)])[:, :3]
    cam = NeRFCamera(torch.from_numpy(c2w), FOCAL)
    return cam.sample_positions(_tile_positions(0.0, 0.0, 16, "cpu"), size=16).numpy()


@pytest.mark.parametrize("name", sorted(SURFACES))
def test_surface_intersect_on_the_plain_loop_matches_jax(name):
    jsdf, tree, sdf = _surface_pair(name)
    rays = _rays()
    it_j, hit_j = jax.jit(lambda pr, r: jsdf.intersect(pr, r, primary=False))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(rays))
    assert not sdf._use_kernel(torch.zeros(1, 3))
    with torch.no_grad():
        it, hit = sdf.intersect(torch.from_numpy(rays), primary=False)
    hit, hit_j = hit.numpy(), np.asarray(hit_j)
    both = _compare(it.t.numpy()[..., None], hit, np.asarray(it_j.t)[..., None], hit_j, "t")
    # JAX's normal is NaN at a hit inside another shape's box (a zero-vector
    # norm; ParametricSDFSet's box term at most of its hits)
    n, n_j = it.n.numpy(), np.asarray(it_j.n)
    finite = both & np.isfinite(n_j).all(-1)
    assert np.isfinite(n).all() and finite.sum() >= 50
    np.testing.assert_allclose(n[finite], n_j[finite], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", sorted(SURFACES))
def test_surface_init_draws_the_jax_distributions(name):
    _, cls, kw = SURFACES[name]
    surface = cls(**kw)
    surface.reset_parameters(torch.Generator().manual_seed(0))
    want = _flat(_surface_tree(name))
    got = {k: v.detach().numpy() for k, v in surface.state_dict().items()}
    assert sorted(got) == sorted(want)
    lo_hi = {"centers": (-0.15, 0.15), "b": (0.0, 0.2), "radii": (-0.1, 0.1),
             "tfs": (0.0, 0.0)}
    if name == "capsule":
        lo_hi = {"a": (-0.05, 0.05), "b": (-0.05, 0.05), "radii": (-0.05, 0.05)}
    if name == "parametric":
        lo_hi = {"offsets": (-0.5, 0.5), "sph_rads": (0.1, 0.4), "box_sizes": (0.1, 0.4),
                 "capsules": (0.0, 1.0), "descriptors": (0.0, 1.0)}
    for k, (lo, hi) in lo_hi.items():
        assert got[k].shape == want[k].shape, k
        for arr in (got[k], want[k]):
            assert lo <= arr.min() and arr.max() <= hi, k


# ---- prime and prime_identity --------------------------------------------------------------

def _key_chain(key, iters, shape):
    """The uniforms a JAX prime loop draws: ``pkey, key = split(key)`` a step."""
    out = []
    for _ in range(iters):
        pkey, key = jax.random.split(key)
        out.append(uniform(pkey, shape))
    return out


def _close_params(module, tree, what):
    want = _flat(tree)
    for k, prm in module.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), want[k], rtol=1e-4, atol=1e-6,
                                   err_msg=f"{what}: {k}")


def _known(lib):
    if lib == "jax":
        return lambda p: jnp.linalg.norm(p, axis=-1) - 0.5
    return lambda p: sphere_sdf(p, 0.5)


def test_prime_matches_jax(replay):
    jscene, tree, scene = scene_pair()
    key = jax.random.PRNGKey(5)
    jparams, jloss = jsdf_mod.prime(jscene.shape, jax.tree.map(jnp.asarray, tree["shape"]),
                                    _known("jax"), key, lr=1e-3, iters=3, batch_size=64,
                                    lo=-1.0, hi=1.0)
    replay(_key_chain(key, 3, (64, 3)))
    loss = prime(scene.shape, _known("torch"), GEN, lr=1e-3, iters=3, batch_size=64,
                 lo=-1.0, hi=1.0)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    before = dict(_flat(tree["shape"]))
    moved = [k for k, v in scene.shape.named_parameters()
             if not np.array_equal(v.detach().numpy(), before[k])]
    assert "centers" in moved and "shift.out.w" in moved
    _close_params(scene.shape, jparams, "prime")


def test_prime_identity_matches_jax(replay):
    kw = dict(in_size=3, out=3, num_layers=2, hidden_size=16, freqs=4)
    jmlp = JMLP(**kw)
    tree = jax.tree.map(np.asarray, jmlp.init(jax.random.PRNGKey(2)))
    mlp = load_jax_params(SkipConnMLP(**kw), tree, device="cpu")
    key = jax.random.PRNGKey(8)
    jparams, jloss = j_prime_identity(jmlp, jax.tree.map(jnp.asarray, tree), key, lr=1e-3,
                                      iters=3, batches=128)
    replay(_key_chain(key, 3, (128, 3)))
    loss = prime_identity(mlp, GEN, lr=1e-3, iters=3, batches=128)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _close_params(mlp, jparams, "prime_identity")


def test_prime_lowers_the_loss_and_needs_a_generator():
    _, _, scene = scene_pair()
    gen = torch.Generator().manual_seed(0)
    first = prime(scene.shape, _known("torch"), gen, lr=1e-3, iters=1, batch_size=256,
                  lo=-1.0, hi=1.0)
    last = prime(scene.shape, _known("torch"), gen, lr=1e-3, iters=40, batch_size=256,
                 lo=-1.0, hi=1.0)
    assert float(last) < float(first)
    with pytest.raises(ValueError):
        prime(scene.shape, _known("torch"), None, iters=1)


# ---- the NeRF-- and NeRV cameras -------------------------------------------------------------

def _rotations(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 3, 3))
    return np.stack([np.linalg.qr(m)[0] for m in q]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _camera_inputs():
    rng = np.random.default_rng(11)
    axis = rng.normal(size=(2, 3))
    axis = (axis / np.linalg.norm(axis, axis=-1, keepdims=True)).astype(np.float32)
    w2c = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    w2c[:, :3, :3] = _rotations(2, 12)
    return dict(
        nerfmm=dict(t=rng.normal(size=(2, 3)).astype(np.float32),
                    angle=rng.uniform(-3, 3, size=(2, 1)).astype(np.float32), axis=axis,
                    focals=rng.uniform(10, 20, size=(2, 2)).astype(np.float32)),
        nerv=dict(world_to_cam=w2c, loc=rng.normal(size=(2, 3)).astype(np.float32),
                  focal=np.float32(13.5)))


def _camera(lib, kind):
    kw = _camera_inputs()[kind]
    if lib == "jax":
        cls = JNeRFMM if kind == "nerfmm" else JNeRV
        return cls(**{k: jnp.asarray(v) for k, v in kw.items()})
    cls = NeRFMMCamera if kind == "nerfmm" else NeRVCamera
    return cls(**{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else float(v)
                  for k, v in kw.items()})


@pytest.mark.parametrize("noise", [False, 0.5])
@pytest.mark.parametrize("kind", ["nerfmm", "nerv"])
def test_nerfmm_and_nerv_cameras_match_jax(kind, noise, replay):
    pos = _tile_positions(3.0, 5.0, 8, "cpu")
    key = jax.random.PRNGKey(4)
    want = np.asarray(_camera("jax", kind).sample_positions(
        jnp.asarray(pos.numpy()), key=key, bundle_size=2, size=24, with_noise=noise))
    if noise:
        replay([uniform(key, (8, 8, 2, 2))])
    cam = _camera("torch", kind)
    got = cam.to("cpu").sample_positions(pos, generator=GEN, bundle_size=2, size=24,
                                         with_noise=noise)
    assert got.shape == want.shape == (2, 8, 8, 2, 6) and len(cam) == 2
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(want[..., 3:], axis=-1), 1.0, atol=1e-6)
