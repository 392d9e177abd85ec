"""Port parity: Monte Carlo transport — Direct's BSDF arm, ``Path``, the
debug integrators, ``SDF.level_surfaces`` and ``SDF.batch_throughput``, the
analytic shapes; then the JAX tests' closed forms and Monte Carlo checks
(``tests/test_integrators.py``, ``tests/test_bsdfs.py``) on the port.  The
BSDFs, ``Constant`` and ``mis_weight`` are held against JAX in
``test_torch_bsdf_sampling``.

The port draws every uniform through ``ops.sampling.uniform``.  The parity
tests replace it with a replay of the uniforms the JAX function draws from
its key, in call order (``test_torch_bsdf_sampling``'s ``replay``),
re-deriving the JAX key tree here: Direct splits ``ikey, ekey, bkey`` and folds the sample index into
``ekey`` and ``bkey`` (``integrators.py:240,261,284``); Path splits ``ikey,
key``, then ``ekey, bkey, nkey, key`` a bounce (``:343,355``);
``sample_emitter`` splits its key again before the light's draw
(``scene.py:68-70``); a mixture splits K+1 keys, one a lobe and the last
for the Gumbel pick (``bsdfs.py:377-380``).  Seeded numpy inputs and the JAX
params (``load_jax_params``) go through both packages.  The scenes are the
reduced NeRV scene of ``test_torch_occlusion`` (8 spheres, nets 16 wide,
7 lobes; the JAX SDF takes its generic loops on the CPU), with its point
light or a ``Constant(5, 0.5)``.

Tolerances: the analytic shapes and the SDF scans rtol 1e-5 and atol 1e-6
of the largest value (float32 in another order), their hit flags exactly;
``batch_throughput`` and the silhouette throughput rtol 1e-4 and atol 1e-5
of the largest, its gradients rtol 1e-4 and atol 1e-5 of each leaf's
largest.  The integrators on 512 camera rays: the hit
flags equal on >= 99% of the rays, and the values within 1e-4 of the
largest value where both hit on all but 1% of them (a bounce or shadow ray
within rounding of the surface flips the whole term of its ray); each
component's gradient within 1e-4 relative L2 of JAX's (sums in another
order through the march, the normals and two bounces).  The readings they
were set from: every hit flag equal, the values within 4.4e-6 of the
largest on every ray, the gradients of Path training within 4.3e-6.  The
Monte Carlo checks keep the JAX tests' bounds.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_raytracing_tpu.bsdf.bsdfs as jbsdfs
import neural_raytracing_tpu.integrators as JI
from neural_raytracing_tpu.kernels import FusedSkipConnMLP as JFused
from neural_raytracing_tpu.lights import Constant as JConstant
import neural_raytracing_tpu.shapes as JS
import neural_raytracing_tpu_torch as T
import neural_raytracing_tpu_torch.integrators as I
from neural_raytracing_tpu_torch import bsdf as B
from neural_raytracing_tpu_torch.cameras import NeRFCamera
from neural_raytracing_tpu_torch.interaction import Interaction
from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP
from neural_raytracing_tpu_torch.lights import Constant, PointLights
from neural_raytracing_tpu_torch.nn import SkipConnMLP
from neural_raytracing_tpu_torch.params import load_jax_params
from neural_raytracing_tpu_torch.render import _tile_positions
from neural_raytracing_tpu_torch.shapes import Sphere, SphereCloud, quad_solve
from test_torch_bsdf_sampling import (  # noqa: F401  (replay: a fixture)
    GEN, _close, _close_grads, _rel_l2, bsdf_draws, replay, uniform,
)
from test_torch_occlusion import C2W, FOCAL, nerv_params, nerv_scene
from test_torch_params import NETS

torch.set_num_threads(1)


# ---- the integrators on the reduced NeRV scene -----------------------------------------

def _mixture(lib):
    """Two NeuralBSDF(softplus) lobes under a spatially-varying weight net."""
    m, mlp = (jbsdfs, JFused) if lib == "jax" else (B, FusedSkipConnMLP)
    return m.ComposeSpatialVarying(
        [m.NeuralBSDF("softplus", mlp=mlp(**NETS["lobe"])) for _ in range(2)],
        sp_var_fn=mlp(**dict(NETS["weight"], out=2)))


def _scene_pair(lights="point", occlusion="hard"):
    """(JAX scene, JAX params, port scene): the reduced NeRV scene (32 march
    steps) with two lobes, its spheres 4x as far apart (a surface with
    creases, where bounce rays hit it again), its point light above the
    surface or a Constant(5, 0.5)."""
    jscene = nerv_scene("jax", max_steps=32, occlusion=occlusion)
    scene = nerv_scene("torch", max_steps=32, occlusion=occlusion)
    jscene.bsdf, scene.bsdf = _mixture("jax"), _mixture("torch")
    tree = nerv_params(jscene)
    tree["shape"]["centers"] = 4.0 * tree["shape"]["centers"]
    if lights == "constant":
        jscene.lights, scene.lights = JConstant(5.0, 0.5), Constant(5.0, 0.5)
        tree["lights"] = {"intensity": np.float32(0.5)}
    return jscene, tree, load_jax_params(scene, tree, device="cpu")


@functools.lru_cache(maxsize=None)
def _camera_rays():
    """Two 16x16 NeRFCamera views of the surface, no jitter: [2, 16, 16, 1, 6]."""
    cam = NeRFCamera(torch.from_numpy(C2W), FOCAL)
    return cam.sample_positions(_tile_positions(0.0, 0.0, 16, "cpu"), size=16).numpy()


def direct_draws(jscene, key, batch, emitter_samples, bsdf_samples, training=False):
    """The uniforms the JAX ``Direct.sample`` draws from ``key``, in order."""
    ikey, ekey, bkey = jax.random.split(key, 3)
    out = [uniform(ikey, ())] if training else []
    constant = isinstance(jscene.lights, JConstant)
    for i in range(emitter_samples):
        _, lkey = jax.random.split(jax.random.fold_in(ekey, i))
        out += [uniform(lkey, batch + (2,))] if constant else []
    for i in range(bsdf_samples if constant else 0):
        out += bsdf_draws(jscene.bsdf, jax.random.fold_in(bkey, i), batch)
    return out


def path_draws(jscene, key, batch, max_depth, training=False):
    """The uniforms the JAX ``Path.sample`` draws from ``key``, in order."""
    ikey, key = jax.random.split(key)
    out = [uniform(ikey, ())] if training else []
    constant = isinstance(jscene.lights, JConstant)
    for depth in range(max_depth):
        ekey, bkey, _, key = jax.random.split(key, 4)
        if constant:
            out.append(uniform(jax.random.split(ekey)[1], batch + (2,)))
        if depth < max_depth - 1:
            out += bsdf_draws(jscene.bsdf, bkey, batch)
    return out


def _jax_run(jscene, tree, jintegrator, rays, key, w, training, with_grad=True):
    """The JAX integrator on ``rays``: (values, active, throughput or None,
    gradients of sum(values * w) (+ sum(throughput)) or None)."""
    def fn(params):
        v, a, it = jintegrator.sample(jscene, params, jnp.asarray(rays), key=key,
                                      training=training)
        loss = jnp.sum(v * w)
        tp = None if it is None else it.throughput
        if tp is not None:
            loss = loss + jnp.sum(tp)
        return loss, (v, a, tp)

    params = jax.tree.map(jnp.asarray, tree)
    if not with_grad:
        return tuple(np.asarray(x) if x is not None else None
                     for x in jax.jit(fn)(params)[1]) + (None,)
    (_, (v, a, tp)), g = jax.jit(jax.value_and_grad(fn, has_aux=True))(params)
    return np.asarray(v), np.asarray(a), None if tp is None else np.asarray(tp), g


def _compare(got, got_hit, want, want_hit, what, atol=1e-4):
    """Hit flags equal on >= 99% of the rays; values within ``atol`` of the
    largest where both hit, on all but 1% of them."""
    got, want = np.asarray(got), np.asarray(want)
    agree = got_hit == want_hit
    assert agree.mean() >= 0.99 and 0.05 < want_hit.mean() < 0.95, (what, agree.mean())
    both = agree & want_hit
    close = (np.abs(got - want) <= atol * np.abs(want).max() + 1e-5 * np.abs(want)).all(-1)
    assert close[both].mean() >= 0.99, (what, close[both].mean())
    return both & close


def _grad_l2s(scene, jg, components=("shape", "bsdf", "lights")):
    return {c: _rel_l2(scene, jg, c) for c in components}


@functools.lru_cache(maxsize=None)
def _jax_path(depth, lights):
    """The JAX Path (max_depth ``depth``) on the camera rays from PRNGKey(21)."""
    jscene, tree, _ = _scene_pair(lights)
    return _jax_run(jscene, tree, JI.Path(max_depth=depth), _camera_rays(),
                    jax.random.PRNGKey(21), 0.0, False, with_grad=False)[:2]


@pytest.mark.parametrize("depth,lights", [(1, "point"), (2, "point")])
def test_path_matches_jax(depth, lights, replay):
    jscene, tree, scene = _scene_pair(lights)
    rays = _camera_rays()
    want, jhit = _jax_path(depth, lights)
    replay(path_draws(jscene, jax.random.PRNGKey(21), rays.shape[:-1], depth))
    with torch.no_grad():
        got, hit, _ = I.Path(max_depth=depth).sample(scene, torch.from_numpy(rays), GEN)
    close = _compare(got, hit.numpy(), want, jhit, f"Path depth {depth}")
    if (depth, lights) == (2, "point"):
        # the rays whose bounce found the surface again and its light: the
        # first bounce is depth 1's, drawn from the same key
        first, _ = _jax_path(1, "point")
        bounced = (np.abs(want - first) > 1e-3 * np.abs(first).max()).any(-1)
        assert bounced.sum() >= 5 and close[bounced].mean() >= 0.8


def test_path_training_gradients_match_jax(replay):
    """Path(training=True) under Constant: the first interaction's
    throughput, the gradients through two bounces (the light's intensity
    among them), the throughput detached each bounce (an undetached one
    would carry the sampled lobes' gradients into the loss)."""
    jscene, tree, scene = _scene_pair("constant")
    rays = _camera_rays()
    batch = rays.shape[:-1]
    key = jax.random.PRNGKey(23)
    w = np.random.default_rng(2).normal(size=batch + (3,)).astype(np.float32)
    want, jhit, jtp, jg = _jax_run(jscene, tree, JI.Path(max_depth=2, training=True), rays,
                                   key, w, True)
    replay(path_draws(jscene, key, batch, 2, training=True))
    got, hit, it = I.Path(max_depth=2, training=True).sample(
        scene, torch.from_numpy(rays), GEN)
    _compare(got.detach(), hit.numpy(), want, jhit, "Path training")
    _close(it.throughput, jtp, "throughput", rtol=1e-4, scale=1e-5)
    assert it.raw_normals is not None
    (torch.sum(got * torch.from_numpy(w)) + torch.sum(it.throughput)).backward()
    l2 = _grad_l2s(scene, jg)
    assert all(e <= 1e-4 for e in l2.values()), l2
    assert scene.lights.intensity.grad.abs() > 0


def test_direct_bsdf_arm_matches_jax(replay):
    """Direct(emitter_samples=1, bsdf_samples=1) under Constant with hard
    shadows: the MIS weights on both arms and the BSDF arm's shadow ray up
    to the light's ``intersect`` distance, ray by ray."""
    jscene, tree, scene = _scene_pair("constant", "hard")
    rays = _camera_rays()
    batch = rays.shape[:-1]
    key = jax.random.PRNGKey(25)
    w = np.random.default_rng(3).normal(size=batch + (3,)).astype(np.float32)
    jint = JI.Direct(emitter_samples=1, bsdf_samples=1, training=False)
    # the BSDF arm's shadow rays: some blocked, some reaching the light
    with torch.no_grad():
        it, hit = scene.shape.intersect(torch.from_numpy(rays), primary=False)
        bs, _ = scene.bsdf.sample(it, torch.Generator().manual_seed(0), hit)
        new_rays = it.spawn_rays(it.from_local(bs.wo))
        light_t, _ = scene.lights.intersect(new_rays)
        free = scene.shape.intersect_test(new_rays, max_t=light_t)[hit]
    assert 0.0 < free.float().mean() < 1.0 and (light_t[hit] > 3.0).all()
    want, jhit, _, _ = _jax_run(jscene, tree, jint, rays, key, w, False, with_grad=False)
    replay(direct_draws(jscene, key, batch, 1, 1))
    with torch.no_grad():
        got, hit, _ = I.Direct(emitter_samples=1, bsdf_samples=1, training=False).sample(
            scene, torch.from_numpy(rays), GEN)
    _compare(got, hit.numpy(), want, jhit, "Direct BSDF arm")


DEBUG = {
    "debug": (JI.Debug, I.Debug), "silhouette": (JI.Silhouette, I.Silhouette),
    "depth": (JI.Depth, I.Depth),
    "depth_scaled": (lambda: JI.Depth(scale=True), lambda: I.Depth(scale=True)),
    "level_surfaces": (JI.LevelSurfaces, I.LevelSurfaces),
    "basis_brdf": (JI.BasisBRDF, I.BasisBRDF),
    "illumination": (JI.Illumination, I.Illumination),
    "luminance": (JI.Luminance, I.Luminance),
}


@functools.lru_cache(maxsize=None)
def _jax_debug():
    """Every debug integrator's (values, active) on the camera rays, and
    ``level_surfaces``, from one JAX compile."""
    jscene, tree, _ = _scene_pair()

    def fn(params, rays):
        out = {n: DEBUG[n][0]().sample(jscene, params, rays)[:2] for n in DEBUG}
        return out, jscene.shape.level_surfaces(params["shape"], rays)

    return jax.tree.map(np.asarray, jax.jit(fn)(jax.tree.map(jnp.asarray, tree),
                                                jnp.asarray(_camera_rays())))


@pytest.mark.parametrize("name", sorted(DEBUG))
def test_debug_integrators_match_jax(name):
    _, _, scene = _scene_pair()
    rays = _camera_rays()
    want, jactive = _jax_debug()[0][name]
    with torch.no_grad():
        got, active, _ = DEBUG[name][1]().sample(scene, torch.from_numpy(rays))
    assert got.shape == want.shape and got.shape[-1] == {"basis_brdf": 2}.get(
        name, DEBUG[name][1]().dims())
    if name == "level_surfaces":
        assert active.all() and jactive.all()
        _close(got, want, name)
        _close(scene.shape.level_surfaces(torch.from_numpy(rays)), _jax_debug()[1],
               "SDF.level_surfaces")
        return
    _compare(got, active.numpy(), want, jactive, name, atol=1e-5)


def test_batch_throughput_matches_jax(replay):
    jscene, tree, scene = _scene_pair()
    rays = _camera_rays()
    r_o, r_d = rays[..., :3], rays[..., 3:]
    params = jax.tree.map(jnp.asarray, tree)
    w = np.random.default_rng(4).normal(size=r_o.shape[:-1]).astype(np.float32)
    for key in (None, jax.random.PRNGKey(3)):
        def fn(p, key=key):
            v = jscene.shape.batch_throughput(p, jnp.asarray(r_o), jnp.asarray(r_d), key=key)
            return jnp.sum(v * w), v

        (_, want), jg = jax.jit(jax.value_and_grad(fn, has_aux=True))(params["shape"])
        if key is not None:
            replay([uniform(key, ())])
        scene.zero_grad(set_to_none=True)
        got = scene.shape.batch_throughput(torch.from_numpy(r_o), torch.from_numpy(r_d),
                                           GEN if key is not None else None)
        _close(got, want, "batch_throughput", rtol=1e-4, scale=1e-5)
        torch.sum(got * torch.from_numpy(w)).backward()
        _close_grads(scene.shape, jg, "batch_throughput")


# ---- the analytic shapes ---------------------------------------------------------------

def _analytic_rays(n=256, seed=13):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o *= (rng.uniform(0.2, 3.5, size=(n, 1)) / np.linalg.norm(o, axis=-1, keepdims=True))
    target = rng.normal(scale=0.6, size=(n, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d], -1).astype(np.float32)


def _close_interaction(got, want, ghit, whit):
    np.testing.assert_array_equal(ghit.numpy(), np.asarray(whit))
    for name in ("p", "t", "n", "wi"):
        _close(getattr(got, name), getattr(want, name), name, scale=1e-5)


def test_quad_solve_and_sphere_match_jax():
    rng = np.random.default_rng(14)
    a, b, c = (rng.normal(size=64).astype(np.float32) for _ in range(3))
    for got, want in zip(quad_solve(*map(torch.from_numpy, (a, b, c))),
                         JS.analytic.quad_solve(a, b, c)):
        _close(got.float(), np.asarray(want, np.float32), "quad_solve")
    js, ts = JS.Sphere((0.1, -0.2, 0.3), 0.8), Sphere((0.1, -0.2, 0.3), 0.8)
    rays = _analytic_rays()
    jit, jhit = js.intersect({}, jnp.asarray(rays))
    it, hit = ts.intersect(torch.from_numpy(rays))
    assert 0.2 < hit.float().mean() < 1.0
    _close_interaction(it, jit, hit, jhit)
    max_t = np.random.default_rng(15).uniform(0.5, 4.0, size=len(rays)).astype(np.float32)
    for mt in (2.0, max_t):
        np.testing.assert_array_equal(
            ts.intersect_test(torch.from_numpy(rays), torch.as_tensor(mt)).numpy(),
            np.asarray(js.intersect_test({}, jnp.asarray(rays), jnp.asarray(mt))))
    lower, upper, ok = ts.intersect_limits(torch.from_numpy(rays))
    jlower, jupper, jok = js.intersect_limits({}, jnp.asarray(rays))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    _close(lower[ok], np.asarray(jlower)[np.asarray(jok)], "lower")
    _close(upper[ok], np.asarray(jupper)[np.asarray(jok)], "upper")
    assert (upper[ok] >= lower[ok]).all()
    assert ts.state_dict() == {} and ts.to("cpu").center.shape == (3,)


def test_sphere_cloud_matches_jax():
    rng = np.random.default_rng(16)
    centers = rng.normal(scale=0.8, size=(6, 3)).astype(np.float32)
    radii = rng.uniform(0.1, 0.5, size=6).astype(np.float32)
    js, ts = JS.SphereCloud(centers, radii), SphereCloud(centers, radii)
    rays = _analytic_rays()
    jit, jhit = js.intersect({}, jnp.asarray(rays))
    it, hit = ts.intersect(torch.from_numpy(rays))
    assert 0.1 < hit.float().mean() < 0.9
    _close_interaction(it, jit, hit, jhit)
    for mt in (1.5, np.inf):
        np.testing.assert_array_equal(
            ts.intersect_test(torch.from_numpy(rays), mt).numpy(),
            np.asarray(js.intersect_test({}, jnp.asarray(rays), mt)))
    one = SphereCloud(centers, 0.3)
    assert one.radii.shape == (6,) and ts.state_dict() == {}


# ---- the JAX tests' closed forms and Monte Carlo checks, on the port -------------------

HEAD_ON = torch.tensor([[0.0, 0.0, 3.0, 0.0, 0.0, -1.0]])


def simple_scene(light=(0.0, 0.0, 4.0), scale=50.0, refl=(0.6, 0.4, 0.2), **kw):
    return T.Scene(shape=Sphere((0.0, 0.0, 0.0), 1.0), bsdf=B.Diffuse(refl),
                   lights=PointLights(location=light, scale=scale), **kw).to("cpu")


def _gen(seed=1):
    return torch.Generator().manual_seed(seed)


@torch.no_grad()
def test_direct_closed_forms():
    """tests/test_integrators.py TestDirectClosedForm: the head-on radiance,
    the cosine falloff, a hard shadow from a second sphere."""
    refl, scale = np.asarray([0.6, 0.4, 0.2]), 50.0
    out, active, _ = I.Direct(training=False).sample(simple_scene(), HEAD_ON, _gen())
    d = 3.0 - 1e-5                       # the surface offset moves the hit towards the light
    falloff = 1e-6 + 1e-6 * d + d * d
    expected = refl / math.pi * scale * (np.ones(3) / math.sqrt(3.0)) / falloff
    assert active[0]
    np.testing.assert_allclose(out[0].numpy(), expected, rtol=1e-3)
    oblique, _, _ = I.Direct(training=False).sample(simple_scene(light=(4.0, 0.0, 4.0)),
                                                    HEAD_ON, _gen())
    assert oblique.sum() < out.sum()
    cloud = SphereCloud([[0.0, 0.0, 0.0], [0.0, 1.5, 2.0]], torch.tensor([1.0, 0.3]))
    blocked = T.Scene(shape=cloud, bsdf=B.Diffuse(),
                      lights=PointLights(location=(0.0, 3.0, 3.0)), occlusion="hard")
    out, active, _ = I.Direct(training=False).sample(blocked, HEAD_ON, _gen())
    assert active[0] and out.abs().max() <= 1e-6
    lit = blocked.replace(shape=Sphere((0.0, 0.0, 0.0), 1.0))
    assert I.Direct(training=False).sample(lit, HEAD_ON, _gen())[0].sum() > 0


@torch.no_grad()
def test_debug_family_closed_forms():
    """TestDebugFamily: the normal's colour, the depth, silhouette and mask."""
    scene = simple_scene()
    out, _, _ = I.Debug().sample(scene, HEAD_ON)
    np.testing.assert_allclose(out[0].numpy(), [0.5, 0.5, 1.0], atol=1e-4)
    depth, _, _ = I.Depth().sample(scene, HEAD_ON)
    np.testing.assert_allclose(depth[0, 0].item(), 2.0, atol=1e-5)
    rays = torch.cat([HEAD_ON, torch.tensor([[5.0, 0, 3, 0, 0, -1.0]])])
    sil, _, _ = I.Silhouette().sample(scene, rays)
    assert sil[0, 0] == 0.0 and sil[1, 0] == 1.0
    masked, active, _ = I.Mask(I.Direct(training=False)).sample(scene, rays, _gen())
    assert masked.shape[-1] == 4 and masked[0, 3] == 1.0 and masked[1, 3] == 0.0
    assert active.all()
    scaled, _, _ = I.Depth(scale=True).sample(scene, rays)
    # the miss's -1 is scaled too, as in the JAX package
    assert scaled[0, 0] == 1.0 and scaled[1, 0] == -0.5
    illum, _, _ = I.Illumination().sample(scene, HEAD_ON)
    np.testing.assert_allclose(illum[0].numpy(), [0.75, 0.75, 1.0], atol=1e-4)


def test_monte_carlo_integrators_raise_without_a_generator():
    """TestKeylessMonteCarloRaises: a fixed stream would average the same
    samples over repeated passes."""
    constant = T.Scene(shape=Sphere(), bsdf=B.Diffuse(), lights=Constant())
    with pytest.raises(ValueError, match="requires a generator"):
        I.Direct(bsdf_samples=2, training=False).sample(constant, HEAD_ON)
    with pytest.raises(ValueError, match="requires a generator"):
        I.Direct(training=False).sample(constant, HEAD_ON)      # the light's draw
    out, _, _ = I.Direct(training=False).sample(simple_scene(), HEAD_ON)
    assert torch.isfinite(out).all()                            # a delta light: no draw
    with pytest.raises(ValueError, match="requires a generator"):
        I.Path(max_depth=2, training=False).sample(simple_scene(), HEAD_ON)


@torch.no_grad()
def test_path_depth_one_is_direct_and_bounces_add_radiance():
    scene = simple_scene()
    d, _, _ = I.Direct(training=False).sample(scene, HEAD_ON, _gen())
    p1, _, _ = I.Path(max_depth=1).sample(scene, HEAD_ON, _gen())
    p2, _, _ = I.Path(max_depth=2).sample(scene, HEAD_ON, _gen())
    np.testing.assert_allclose(p1.numpy(), d.numpy(), rtol=1e-5)
    assert p2.sum() >= p1.sum() - 1e-6


def test_path_gradients_flow_on_an_sdf():
    """TestPath.test_gradients_flow_but_throughput_detached on the port."""
    from neural_raytracing_tpu_torch.shapes import SDF, SphereSDF
    sdf = SDF(SphereSDF(n=8, mlp=SkipConnMLP(in_size=3, out=1, num_layers=2, hidden_size=16,
                                             freqs=4, activation="softplus", init="zeros")),
              max_steps=16, throughput_steps=8)
    scene = T.Scene(shape=sdf, bsdf=B.Diffuse(),
                    lights=PointLights(location=(0.0, 0.0, 4.0))).init(_gen(0), device="cpu")
    xs = torch.linspace(-0.1, 0.1, 4)
    gx, gy = torch.meshgrid(xs, xs, indexing="xy")
    r_o = torch.stack([gx, gy, torch.full_like(gx, 0.8)], -1).reshape(-1, 3)
    rays = torch.cat([r_o, torch.tensor([0.0, 0.0, -1.0]).expand(r_o.shape)], -1)
    out, _, it = I.Path(max_depth=2, training=True).sample(scene, rays, _gen())
    (out.sum() + it.throughput.sum()).backward()
    total = sum(p.grad.abs().sum().item() for p in scene.parameters() if p.grad is not None)
    assert np.isfinite(total) and total > 0


class _ClampedDiffuse(B.Diffuse):
    """Diffuse with its spectrum clamped at 0 (the JAX tests'
    ``preprocess=clamped_div_pi``)."""

    def eval_and_pdf(self, it, wo, active=True):
        spectrum, pdf, aux = super().eval_and_pdf(it, wo, active)
        return torch.clamp_min(spectrum, 0.0), pdf, aux


def _mis_rays(passes):
    """256 head-on rays near the pole, repeated over ``passes`` passes."""
    xy = torch.stack(torch.meshgrid(torch.linspace(-0.2, 0.2, 16),
                                    torch.linspace(-0.2, 0.2, 16), indexing="xy"), -1)
    xy = xy.reshape(-1, 2)
    rays = torch.cat([xy, torch.full((256, 1), 3.0), torch.tensor([0.0, 0.0, -1.0])
                      .expand(256, 3)], -1)
    return rays.expand(passes, 256, 6).contiguous()


def _mc(integrator, scene, passes=64):
    """-> (the mean over passes and rays, the std over passes of a pass's mean)."""
    vals, active, _ = integrator.sample(scene, _mis_rays(passes), _gen(42))
    vals = vals.detach()[:, active[0]]
    return vals.mean(dim=(0, 1)).numpy(), vals.mean(dim=1).std(dim=0).numpy()


@torch.no_grad()
def test_mis_arms_match_the_analytic_value():
    """TestDirectMIS: both estimators agree with the closed form rho * I on a
    clamped diffuse sphere under Constant, and MIS cuts the variance."""
    refl = np.asarray([0.6, 0.4, 0.2])
    scene = T.Scene(shape=Sphere(), bsdf=_ClampedDiffuse(tuple(refl)),
                    lights=Constant(radius=5.0, intensity=0.5))
    em_mean, em_std = _mc(I.Direct(emitter_samples=1, training=False), scene)
    mis_mean, mis_std = _mc(I.Direct(emitter_samples=1, bsdf_samples=1, training=False),
                            scene)
    np.testing.assert_allclose(em_mean, refl * 0.5, rtol=0.05)
    np.testing.assert_allclose(mis_mean, refl * 0.5, rtol=0.02)
    assert (mis_std < 0.5 * em_std).all(), (mis_std, em_std)


@torch.no_grad()
def test_sigmoid_mixture_bsdf_arm_unbiased():
    """The mixture's eval pdf is the density of its sample (k_i / sum k):
    with four zero-init lobes (k_i = 0.5, sum k = 2) the BSDF arm is not
    off by sum k."""
    refls = [(0.6, 0.4, 0.2), (0.2, 0.6, 0.4), (0.1, 0.1, 0.8), (0.5, 0.5, 0.1)]
    mlp = SkipConnMLP(in_size=3, out=4, num_layers=2, hidden_size=16, freqs=4, init="zeros")
    scene = T.Scene(shape=Sphere(),
                    bsdf=B.ComposeSpatialVarying([_ClampedDiffuse(r) for r in refls],
                                                 sp_var_fn=mlp),
                    lights=Constant(radius=5.0, intensity=0.5)).init(_gen(0), device="cpu")
    expected = 0.5 * np.sum(np.asarray(refls), axis=0) * 0.5
    mis_mean, _ = _mc(I.Direct(emitter_samples=1, bsdf_samples=1, training=False), scene,
                      passes=128)
    np.testing.assert_allclose(mis_mean, expected, rtol=0.05)


@torch.no_grad()
def test_delta_lights_unchanged_by_the_bsdf_arm():
    rays = _mis_rays(1)[0, :64]
    v0, _, _ = I.Direct(training=False).sample(simple_scene(), rays, _gen())
    v1, _, _ = I.Direct(bsdf_samples=2, training=False).sample(simple_scene(), rays, _gen())
    np.testing.assert_allclose(v0.numpy(), v1.numpy(), atol=1e-6)


@pytest.mark.parametrize("integrator", ["direct", "path"])
def test_horizon_mask_zeroes_backlit_light(integrator):
    """A light behind the surface: the unclamped Diffuse gives negative
    radiance, ``horizon_mask`` zeroes it (tests/test_integrators.py)."""
    scene = T.Scene(shape=Sphere(), bsdf=B.Diffuse((0.8, 0.8, 0.8)),
                    lights=PointLights(location=(0.0, 0.0, -4.0), scale=100.0))
    rays = torch.tensor([[0.0, 0.0, 2.0, 0.0, 0.0, -1.0]])
    make = (lambda hm: I.Direct(training=False, horizon_mask=hm)) if integrator == "direct" \
        else (lambda hm: I.Path(max_depth=2, horizon_mask=hm))
    ref, active, _ = make(False).sample(scene, rays, _gen())
    masked, _, _ = make(True).sample(scene, rays, _gen())
    assert active[0] and ref.min() < 0.0 and masked.min() >= 0.0


def _it(n=8192, seed=0):
    """tests/test_bsdfs.py make_it: frames from up-facing normals, one wi."""
    g = _gen(seed)
    normal = torch.randn(n, 3, generator=g)
    normal[:, 2] = normal[:, 2].abs() + 0.5
    normal = normal / normal.norm(dim=-1, keepdim=True)
    it = Interaction(p=torch.randn(n, 3, generator=g), t=torch.ones(n)).with_normals(normal)
    wi = torch.tensor([0.2, 0.1, 0.95])
    return it._replace(wi=(wi / wi.norm()).expand(n, 3))


WO = torch.tensor([0.1, -0.2, 0.97]) / torch.tensor([0.1, -0.2, 0.97]).norm()


@torch.no_grad()
def test_bsdf_closed_forms():
    """tests/test_bsdfs.py: Plastic's eval and its mixture of lobes, the
    two-sided mirror, Compose's softmax eval and its pdf's integral, the
    hard selection, the mixture's weights, the zeroed lobe."""
    it = _it(256)
    wo = WO.expand(256, 3)
    spec, pdf, _ = B.Plastic().eval_and_pdf(it, wo)
    assert (spec >= 0).all() and (pdf <= WO[2] / math.pi + 1e-6).all()
    bs, spec = B.Plastic().sample(it, _gen(3))
    assert torch.isfinite(bs.wo).all() and torch.isfinite(spec).all() and (bs.pdf > 0).all()
    from neural_raytracing_tpu_torch.ops.math import reflect
    specular = (bs.wo * reflect(it.frame[..., 2], it.wi)).sum(-1) > 1.0 - 1e-6
    assert 0 < specular.sum() < 256           # both lobes sampled
    two = B.Bidirectional(B.Diffuse((0.5, 0.5, 0.5)))
    front = two.eval_and_pdf(it, wo)
    back = two.eval_and_pdf(it._replace(wi=B.invert_z(it.wi)), B.invert_z(wo))
    for a, b in zip(front[:2], back[:2]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=1e-6)
    mix = B.Compose([B.Diffuse((1.0, 0.0, 0.0)), B.Diffuse((0.0, 1.0, 0.0))])
    mix.reset_parameters(_gen(0))
    k = torch.softmax(mix.weights.detach(), -1)
    spec, pdf, _ = mix.eval_and_pdf(it, wo)
    np.testing.assert_allclose(spec[:, 0].detach().numpy(), k[0].item() * WO[2].item() / math.pi,
                               rtol=1e-5)
    np.testing.assert_allclose(pdf.detach().numpy(), WO[2].item() / math.pi, rtol=1e-5)
    v = torch.randn(20000, 3, generator=_gen(3))
    v = v / v.norm(dim=-1, keepdim=True)
    v[:, 2] = v[:, 2].abs()
    _, pdf, _ = mix.eval_and_pdf(_it(20000), v)
    assert abs(pdf.mean().item() * 2.0 * math.pi - 1.0) < 0.03
    sel = B.SelectBSDF(lambda p: (p[..., 0] > 0).long(),
                       [B.Diffuse((1.0, 0.0, 0.0)), B.Diffuse((0.0, 1.0, 0.0))])
    spec, _, _ = sel.eval_and_pdf(it, wo)
    left = it.p[:, 0] <= 0
    assert (spec[left, 1] < 1e-7).all() and (spec[~left, 0] < 1e-7).all()
    small = B.ComposeSpatialVarying(
        [B.Diffuse((1.0, 0.2, 0.1)), B.Diffuse((0.1, 0.2, 1.0))],
        sp_var_fn=SkipConnMLP(in_size=3, out=2, num_layers=2, hidden_size=16, freqs=4,
                              init="xavier"))
    small.reset_parameters(_gen(0))
    w, _ = small.normalized_weights(torch.randn(32, 3, generator=_gen(1)))
    assert ((w >= 0) & (w <= 1)).all()
    _, _, aux = small.eval_and_pdf(it, wo)
    assert aux["normalized_weights"].shape == aux["nonnormalized_weights"].shape == (256, 2)


@torch.no_grad()
def test_bsdf_sampling_frequencies():
    """tests/test_bsdfs.py: Compose picks its bases ~ the softmax weights (a
    binomial 3 sigma) with the joint pdf, and its directions have E[cos] =
    2/3; SelectBSDF's sample is the selected basis's; the spatial mixture's
    spectra come from one basis each, both picked."""
    n = 4096
    mix = B.Compose([B.Diffuse((1.0, 0.0, 0.0)), B.Diffuse((0.0, 1.0, 0.0))])
    with torch.no_grad():
        mix.weights.copy_(torch.tensor([2.0, 0.0]))
    w = torch.softmax(mix.weights.detach(), -1).numpy()
    bs, spec = mix.sample(_it(n), _gen(7))
    wo, pdf, spec = bs.wo.detach().numpy(), bs.pdf.detach().numpy(), spec.detach().numpy()
    assert (wo[:, 2] > 0).all() and (pdf > 0).all()
    ratio = pdf / (wo[:, 2] / math.pi)
    sel0, sel1 = np.isclose(ratio, w[0], rtol=1e-4), np.isclose(ratio, w[1], rtol=1e-4)
    assert (sel0 | sel1).all()
    assert abs(sel0.sum() - n * w[0]) < 3 * math.sqrt(n * w[0] * w[1])
    assert (np.abs(spec[sel0, 1]) <= 1e-7).all() and (np.abs(spec[sel1, 0]) <= 1e-7).all()
    bs, _ = B.Compose([B.Diffuse(), B.Diffuse()]).sample(_it(8192), _gen(9))
    assert abs(bs.wo[:, 2].mean().item() - 2.0 / 3.0) < 0.01
    it = _it(256)
    sel = B.SelectBSDF(lambda p: (p[..., 0] > 0).long(),
                       [B.Diffuse((1.0, 0.0, 0.0)), B.Conductor()])
    bs, _ = sel.sample(it, _gen(5))
    right = it.p[:, 0] > 0
    from neural_raytracing_tpu_torch.ops.math import local_reflect
    np.testing.assert_allclose(bs.wo[right].detach().numpy(),
                               local_reflect(it.wi)[right].numpy(), atol=1e-6)
    np.testing.assert_allclose(bs.pdf[right].detach().numpy(), 1.0, atol=1e-6)
    assert (bs.wo[~right, 2] > 0).all()
    np.testing.assert_allclose(bs.pdf[~right].detach().numpy(),
                               bs.wo[~right, 2].detach().numpy() / math.pi, rtol=1e-4)
    small = B.ComposeSpatialVarying(
        [B.Diffuse((1.0, 0.2, 0.1)), B.Diffuse((0.1, 0.2, 1.0))],
        sp_var_fn=SkipConnMLP(in_size=3, out=2, num_layers=2, hidden_size=16, freqs=4,
                              init="xavier"))
    small.reset_parameters(_gen(0))
    _, spec = small.sample(_it(512), _gen(2))
    r = spec[:, 0].detach().numpy()
    a, b = np.isclose(r, 1.0 / math.pi, atol=1e-5), np.isclose(r, 0.1 / math.pi, atol=1e-5)
    assert (a | b).all() and a.any() and b.any()
