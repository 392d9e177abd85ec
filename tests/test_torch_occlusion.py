"""Port parity: occlusion — the direction helpers, ``PointLights``, the
shadow march (K4's plain version) and ``sample_emitter`` in its three
modes, then ``pathtrace`` of a reduced NeRV scene with hard and learned
shadows.

The reduced NeRV scene keeps the structure of ``scripts/nerv.py``
(SDF(SphereSDF) + ComposeSpatialVarying(7 x NeuralBSDF(softplus)) +
PointLights(scale=100) + the occlusion MLP) at the narrow widths of
``test_torch_params``; its light sits above the surface so that some shadow
rays are blocked and some are not.  The JAX side runs its generic loop
(``fused_loops="off"``) and its Pallas kernel in interpret mode
(``block_rows=64``).

Tolerances: the direction helpers and ``PointLights`` atol 1e-6 / rtol 1e-5
(float32 in another order); the shadow march's not-blocked flags exactly
equal (the same float32 steps; the cases below are built so that one step's
rounding cannot flip them); ``sample_emitter`` values and gradients rtol
1e-5 / atol 1e-5 of the largest value; the render as ``test_torch_render``
(mask agreement >= 99%, max |difference| <= 1e-4 where both masks agree).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_raytracing_tpu as J
from neural_raytracing_tpu.bsdf import ComposeSpatialVarying as JCompose
from neural_raytracing_tpu.bsdf import NeuralBSDF as JNeuralBSDF
from neural_raytracing_tpu.cameras import NeRFCamera as JNeRF
from neural_raytracing_tpu.integrators import Direct as JDirect
from neural_raytracing_tpu.interaction import Interaction as JInteraction
from neural_raytracing_tpu.kernels import FusedSkipConnMLP as JFused
from neural_raytracing_tpu.kernels import fused_march as jfm
from neural_raytracing_tpu.kernels.fused_sdf import FusedSphereSDF as JFusedSphereSDF
from neural_raytracing_tpu.lights import PointLights as JPointLights
from neural_raytracing_tpu.nn import SkipConnMLP as JMLP
from neural_raytracing_tpu.ops import dirs as jdirs
from neural_raytracing_tpu.scene import sample_emitter as j_sample_emitter
from neural_raytracing_tpu.shapes import SDF as JSDF
from neural_raytracing_tpu.shapes import SphereSDF as JSphereSDF
import neural_raytracing_tpu_torch as T
from neural_raytracing_tpu_torch.bsdf import ComposeSpatialVarying, NeuralBSDF
from neural_raytracing_tpu_torch.cameras import NeRFCamera, nerf_c2w
from neural_raytracing_tpu_torch.integrators import Direct
from neural_raytracing_tpu_torch.interaction import Interaction
from neural_raytracing_tpu_torch.kernels import (
    FusedSkipConnMLP, FusedSphereSDF, shadow_march_plain,
)
from neural_raytracing_tpu_torch.lights import PointLights
from neural_raytracing_tpu_torch.nn import SkipConnMLP
from neural_raytracing_tpu_torch.ops import dirs
from neural_raytracing_tpu_torch.params import load_jax_params, state_dict_from_jax
from neural_raytracing_tpu_torch.shapes import SDF, SphereSDF
from test_torch_params import NETS, scene_params

torch.set_num_threads(1)
OCC = dict(in_size=5, out=1, num_layers=2, hidden_size=16, freqs=4)
LIGHT = np.asarray([[0.2, 0.9, 0.6]], np.float32)
SIZE, CHUNK = 16, 8
FOCAL = 0.5 * SIZE / np.tan(0.5 * 0.6911)
C2W = np.stack([nerf_c2w(30, 45, 2.0), nerf_c2w(-20, 160, 2.2)])[:, :3]


def nerv_scene(lib, max_steps=16, occlusion="learned", march_bound=None,
               fused_sdf=False):
    """The reduced NeRV scene, built from the JAX package ("jax") or the port."""
    if lib == "jax":
        mlp, plain, scene, sdf, lights = JFused, JMLP, J.Scene, JSDF, JPointLights
        compose, lobe = JCompose, JNeuralBSDF
        surface = (JFusedSphereSDF(n=8, mlp=JMLP(**NETS["shift"]), mode="off")
                   if fused_sdf else JSphereSDF(n=8, mlp=JFused(**NETS["shift"])))
    else:
        mlp, plain, scene, sdf, lights = FusedSkipConnMLP, SkipConnMLP, T.Scene, SDF, PointLights
        compose, lobe = ComposeSpatialVarying, NeuralBSDF
        surface = (FusedSphereSDF(n=8, mlp=SkipConnMLP(**NETS["shift"]))
                   if fused_sdf else SphereSDF(n=8, mlp=FusedSkipConnMLP(**NETS["shift"])))
    return scene(
        shape=sdf(surface, max_steps=max_steps, march_bound=march_bound),
        bsdf=compose([lobe(activation="softplus", mlp=mlp(**NETS["lobe"]))
                      for _ in range(7)], sp_var_fn=mlp(**dict(NETS["weight"], out=7))),
        lights=lights(scale=100.0), occ=plain(**OCC), occlusion=occlusion)


def nerv_params(jscene, location=LIGHT, seed=0):
    tree = scene_params(jscene, seed)
    tree["lights"]["location"] = np.asarray(location, np.float32)
    return tree


def nerv_pair(location=LIGHT, **kw):
    """(JAX scene, JAX params, port scene on the CPU with those params)."""
    jscene = nerv_scene("jax", **kw)
    tree = nerv_params(jscene, location)
    return jscene, tree, load_jax_params(nerv_scene("torch", **kw), tree, device="cpu")


def _flat(tree):
    return {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, tree)).items()}


# ---- directions and point lights ------------------------------------------------

def _dir_inputs(name):
    rng = np.random.default_rng(1)
    if name in ("dir_to_elev_azim", "dir_to_uv"):
        v = rng.normal(size=(64, 3))
        v[:4] = [[0, 0, 1], [0, 0, -1], [1e-9, 0, 0], [0, 0, 0]]   # poles, zero
        return v.astype(np.float32)
    if name in ("uv_to_elev_azim", "uv_to_dir"):
        return rng.uniform(-1.2, 1.2, size=(64, 2)).astype(np.float32)
    return rng.uniform(-4.0, 4.0, size=(64, 2)).astype(np.float32)


@pytest.mark.parametrize("name", ["dir_to_elev_azim", "elev_azim_to_dir",
                                  "uv_to_elev_azim", "elev_azim_to_uv",
                                  "dir_to_uv", "uv_to_dir"])
def test_direction_helpers_match_jax(name):
    x = _dir_inputs(name)
    got = getattr(dirs, name)(torch.from_numpy(x)).numpy()
    want = np.asarray(getattr(jdirs, name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _light_case():
    rng = np.random.default_rng(2)
    tree = {"intensity": np.asarray([[0.9, 0.5, 0.2]], np.float32),
            "location": rng.normal(size=(2, 3)).astype(np.float32) + [0, 2, 0],
            "const": np.float32(0.3), "linear": np.float32(0.2),
            "square": np.float32(0.7), "scale": np.float32(3.0)}
    p = rng.normal(size=(2, 3, 4, 1, 3)).astype(np.float32) * 0.5
    active = rng.uniform(size=(2, 3, 4, 1)) > 0.3
    return tree, p, active


def test_point_lights_match_jax():
    tree, p, active = _light_case()
    w = np.random.default_rng(3).normal(size=p.shape).astype(np.float32)
    jl = JPointLights()

    def jfn(params, pp):
        ds, spec = jl.sample_direction(params, JInteraction(p=pp, t=pp[..., 0]),
                                       active=jnp.asarray(active))
        return jnp.sum(spec * w) + jnp.sum(ds.d * w) + jnp.sum(ds.dist), (ds, spec)

    (_, (jds, jspec)), (jg, jgp) = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(p))
    light = load_jax_params(PointLights(), tree, device="cpu")
    assert light.location.shape == (2, 3) and light.scale.shape == ()
    pt = torch.from_numpy(p).requires_grad_()
    ds, spec = light.sample_direction(Interaction(p=pt, t=pt[..., 0]),
                                      active=torch.from_numpy(active))
    (torch.sum(spec * torch.from_numpy(w)) + torch.sum(ds.d * torch.from_numpy(w))
     + torch.sum(ds.dist)).backward()
    for a, b in ((ds.d, jds.d), (ds.dist, jds.dist), (ds.p, jds.p), (ds.pdf, jds.pdf),
                 (spec, jspec)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    assert ds.delta and light.delta and not spec[~torch.from_numpy(active)].any()
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jgp), rtol=1e-4, atol=1e-5)
    for k, g in _flat(jg).items():
        np.testing.assert_allclose(getattr(light, k).grad.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * np.abs(g).max(), err_msg=k)
    probe = p.reshape(-1, 3)
    np.testing.assert_allclose(light.envmap(torch.from_numpy(probe)).detach().numpy(),
                               np.asarray(jl.envmap(tree, jnp.asarray(probe))),
                               rtol=1e-5, atol=1e-6)
    rays = torch.zeros(5, 6)
    assert not light.intersect(rays)[1].any() and not light.eval_pdf(rays)[1].any()


def test_point_lights_location_resizes_and_the_rest_stays_strict():
    light = PointLights()
    light.set_location(np.ones((3, 3), np.float32))
    assert light.location.shape == (3, 3) and light.location.grad is None
    light.load_state_dict({k: torch.zeros_like(v) if k != "location" else torch.ones(1, 3)
                           for k, v in light.state_dict().items()})
    assert light.location.shape == (1, 3) and light.scale.item() == 0.0
    light.reset_parameters()
    assert light.scale.item() == 100.0 and light.location.tolist() == [[0.0, 1.0, 0.0]]
    for bad in ({"intensity": torch.ones(2, 3)}, {"scale": torch.ones(2)}):
        sd = dict(light.state_dict(), **bad)
        with pytest.raises(RuntimeError, match="size mismatch"):
            light.load_state_dict(sd)
    sd = light.state_dict()
    del sd["const"]
    with pytest.raises(RuntimeError, match="Missing"):
        light.load_state_dict(sd)


# ---- the shadow march --------------------------------------------------------------

def _shadow_rays(n=96, seed=4):
    """Rays from points on a shell of radius 0.6 towards the light; every
    7th ray has a zero direction.  -> (r_o, r_d, distance to the light)."""
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3))
    p = 0.6 * p / np.linalg.norm(p, axis=-1, keepdims=True)
    to_light = LIGHT[0] - p
    dist = np.linalg.norm(to_light, axis=-1)
    r_d = to_light / dist[:, None]
    r_d[::7] = 0.0
    return p.astype(np.float32), r_d.astype(np.float32), dist.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _shadow_case(past_light_exit, per_ray):
    jscene, tree, scene = nerv_pair(max_steps=16, occlusion="hard")
    r_o, r_d, dist = _shadow_rays()
    max_t = dist if per_ray else 10.0
    jsdf = JSDF(jscene.shape.module, max_steps=16, fused_loops="off",
                shadow_past_light_exit=past_light_exit)
    want = np.asarray(jsdf.intersect_test(tree["shape"], jnp.asarray(np.concatenate(
        [r_o, r_d], -1)), max_t=jnp.asarray(max_t)))
    kernel = np.asarray(jfm.fused_shadow_march(
        jscene.shape.module, tree["shape"], jnp.asarray(r_o), jnp.asarray(r_d),
        jnp.asarray(max_t), max_steps=16, epsilon=1e-3, block_rows=64,
        interpret=True, past_light_exit=past_light_exit))
    return scene, r_o, r_d, max_t, want, kernel


@pytest.mark.parametrize("per_ray", [False, True])
@pytest.mark.parametrize("past_light_exit", [True, False])
def test_shadow_march_plain_matches_jax(past_light_exit, per_ray):
    scene, r_o, r_d, max_t, want, kernel = _shadow_case(past_light_exit, per_ray)
    np.testing.assert_array_equal(kernel, want)   # the JAX loop and its kernel
    sdf = scene.shape.replace(shadow_past_light_exit=past_light_exit)
    mt = torch.from_numpy(max_t) if per_ray else max_t
    got, evals = shadow_march_plain(sdf.sdf, torch.from_numpy(r_o), torch.from_numpy(r_d),
                                    mt, max_steps=16, epsilon=1e-3,
                                    past_light_exit=past_light_exit)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.0 < (~got).float().mean() < 1.0          # some blocked, some not
    assert got[::7].all()                              # zero-direction rays are free
    assert evals.max() <= 16 and evals.sum() > 0
    if not past_light_exit:                            # only a hit stops a ray
        assert (evals[got] == 16).all()
    rays = torch.from_numpy(np.concatenate([r_o, r_d], -1))
    np.testing.assert_array_equal(sdf.intersect_test(rays, max_t=mt).numpy(), want)


def _one_sphere(lib):
    """An exact SDF: one sphere of radius 0.5 at the origin, the exact
    smooth-min and a zero shift, so every step below is exact in float32."""
    shift = dict(in_size=3, out=1, num_layers=1, hidden_size=4, freqs=2, init="zeros")
    if lib == "jax":
        module = JSphereSDF(n=1, mlp=JMLP(**shift), stable_min=True)
        params = jax.tree.map(np.asarray, module.init(jax.random.PRNGKey(0)))
        params.update(centers=np.zeros((1, 3), np.float32),
                      radii=np.full((1,), 0.5, np.float32))
        return module, params
    module = SphereSDF(n=1, mlp=SkipConnMLP(**shift), stable_min=True)
    with torch.no_grad():
        module.radii.fill_(0.5)
    return module


EPS = 2.0 ** -10          # depth starts at 1e2 * EPS = 25/256, exactly


def _reference_loop(sdf, r_o, r_d, max_t, steps, lt=True, advance=True,
                    depth0=1e2 * EPS):
    """The shadow loop with one of its three rules switchable, to show that
    each case below tells the rules apart."""
    depths = torch.full(r_o.shape[:-1], depth0)
    remaining = torch.ones(r_o.shape[:-1], dtype=torch.bool)
    for _ in range(steps):
        live = remaining & (depths < max_t)
        sd = sdf(r_o + r_d * depths[..., None])
        hits = live & ((sd < EPS) if lt else (sd <= EPS))
        depths = torch.where(live & (advance | ~hits), depths + sd, depths)
        remaining = remaining & ~hits
    return (depths >= max_t) | remaining


def shadow_rule_case(name):
    """-> (r_o [1, 3], r_d [1, 3], max_t [1], steps, the rule it pins).

    "strict_lt": the first step lands at sd == eps exactly, then the ray
    leaves the sphere (free; blocked under <=).  "hit_step_advance": a
    grazing ray hits with 0 < sd < eps and the light sits within that last
    step (free; blocked without the advance).  "start_depth": the origin is
    within eps of the surface, the ray leaves it (free; blocked if the march
    started at 0)."""
    module = _one_sphere("torch")
    if name == "strict_lt":
        r_o = torch.tensor([[0.5 + EPS - 1e2 * EPS, 0.0, 0.0]])
        return r_o, torch.tensor([[1.0, 0.0, 0.0]]), torch.tensor([10.0]), 8, {"lt": False}
    if name == "start_depth":
        r_o = torch.tensor([[0.5 + 0.5 * EPS, 0.0, 0.0]])
        return r_o, torch.tensor([[1.0, 0.0, 0.0]]), torch.tensor([10.0]), 8, {"depth0": 0.0}
    r_o = torch.tensor([[0.0, 0.3, 1.5]])
    r_d = torch.nn.functional.normalize(torch.tensor([[0.0, 0.02, -1.0]]), dim=-1)
    with torch.no_grad():      # walk the ray to its hit step
        depth = torch.tensor([1e2 * EPS])
        for steps in range(1, 64):
            sd = module(r_o + r_d * depth[:, None])
            if sd.item() < EPS:
                break
            depth = depth + sd
    assert 0.0 < sd.item() < EPS
    return r_o, r_d, depth + 0.5 * sd, steps, {"advance": False}


@pytest.mark.parametrize("name", ["strict_lt", "hit_step_advance", "start_depth"])
def test_shadow_march_rules(name):
    r_o, r_d, max_t, steps, mutant = shadow_rule_case(name)
    module = _one_sphere("torch")
    with torch.no_grad():
        got, _ = shadow_march_plain(module, r_o, r_d, max_t, max_steps=steps,
                                    epsilon=EPS, past_light_exit=True)
        assert _reference_loop(module, r_o, r_d, max_t, steps).item()
        assert not _reference_loop(module, r_o, r_d, max_t, steps, **mutant).item()
    assert got.item()
    jmodule, params = _one_sphere("jax")
    jsdf = JSDF(jmodule, epsilon=EPS, max_steps=steps, fused_loops="off")
    rays = jnp.asarray(torch.cat([r_o, r_d], -1).numpy())
    assert bool(jsdf.intersect_test(params, rays, max_t=jnp.asarray(max_t.numpy()))[0])
    assert bool(jfm.fused_shadow_march(
        jmodule, params, rays[:, :3], rays[:, 3:], jnp.asarray(max_t.numpy()),
        max_steps=steps, epsilon=EPS, block_rows=64, interpret=True,
        past_light_exit=True)[0])


# ---- sample_emitter and the render ---------------------------------------------------

@functools.lru_cache(maxsize=None)
def _emitter_case(occlusion):
    rng = np.random.default_rng(5)
    p = rng.normal(size=(2, 3, 4, 1, 3))
    p = (0.55 * p / np.linalg.norm(p, axis=-1, keepdims=True)).astype(np.float32)
    active = rng.uniform(size=(2, 3, 4, 1)) > 0.2
    location = np.concatenate([LIGHT, LIGHT + [[-0.9, 0.1, 0.3]]]).astype(np.float32)
    jscene, tree, scene = nerv_pair(max_steps=16, occlusion=occlusion, location=location)
    w = rng.normal(size=p.shape).astype(np.float32)

    def jfn(params, pp):
        ds, spec = j_sample_emitter(jscene, params, JInteraction(p=pp, t=pp[..., 0]),
                                    None, jnp.asarray(active))
        return jnp.sum(spec * w), (ds, spec)

    (_, (jds, jspec)), grads = jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(p))
    return scene, p, active, w, jds, np.asarray(jspec), grads


@pytest.mark.parametrize("occlusion", ["none", "hard", "learned"])
def test_sample_emitter_matches_jax(occlusion):
    scene, p, active, w, jds, jspec, (jg, jgp) = _emitter_case(occlusion)
    pt = torch.from_numpy(p).requires_grad_()
    ds, spec = T.sample_emitter(scene, Interaction(p=pt, t=pt[..., 0]), None,
                                torch.from_numpy(active))
    torch.sum(spec * torch.from_numpy(w)).backward()
    scale = np.abs(jspec).max()
    np.testing.assert_allclose(ds.d.detach().numpy(), np.asarray(jds.d), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(spec.detach().numpy(), jspec, rtol=1e-5, atol=1e-5 * scale)
    if occlusion != "none":
        nb = scene.shape.intersect_test(torch.cat([pt, ds.d], -1).detach(),
                                        max_t=ds.dist.detach())
        assert 0.0 < (~nb[torch.from_numpy(active)]).float().mean() < 1.0
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(jgp), rtol=1e-4,
                               atol=1e-5 * np.abs(jgp).max())
    named = dict(scene.named_parameters())
    flat = _flat(jg)
    comps = {"none": ("lights",), "hard": ("lights",), "learned": ("lights", "occ")}
    for k, g in flat.items():
        if k.split(".")[0] not in comps[occlusion] or k.endswith(".B"):
            continue
        assert named[k].grad is not None, k
        np.testing.assert_allclose(named[k].grad.numpy(), g, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(g).max(), 1e-12), err_msg=k)
    if occlusion == "learned":
        assert np.abs(flat["occ.out.w"]).max() > 0


@functools.lru_cache(maxsize=None)
def _render_case(occlusion):
    location = np.concatenate([LIGHT, LIGHT + [[-0.9, 0.1, 0.3]]]).astype(np.float32)
    jscene, tree, scene = nerv_pair(max_steps=32, occlusion=occlusion, location=location)
    want, _ = J.pathtrace(jscene, tree, JNeRF(cam_to_world=jnp.asarray(C2W), focal=FOCAL),
                          JDirect(training=False), size=SIZE, chunk_size=CHUNK,
                          bundle_size=1, background=0.0, key=None)
    return scene, np.asarray(want)


@pytest.mark.parametrize("occlusion", ["hard", "learned"])
def test_pathtrace_nerv_matches_jax(occlusion):
    scene, want = _render_case(occlusion)
    got, _ = T.pathtrace(scene, NeRFCamera(torch.from_numpy(C2W), FOCAL),
                         Direct(training=False), size=SIZE, chunk_size=CHUNK,
                         bundle_size=1, background=0.0, key=None, device="cpu")
    got = got.numpy()
    mask, jmask = np.abs(got).sum(-1) > 0, np.abs(want).sum(-1) > 0
    assert 0 < jmask.mean() < 1
    assert (mask == jmask).mean() >= 0.99
    agree = mask == jmask
    np.testing.assert_allclose(got[agree], want[agree], atol=1e-4, rtol=0)
    # the shadows change the image
    free, _ = T.pathtrace(scene.replace(occlusion="none"),
                          NeRFCamera(torch.from_numpy(C2W), FOCAL),
                          Direct(training=False), size=SIZE, chunk_size=CHUNK,
                          bundle_size=1, background=0.0, key=None, device="cpu")
    assert np.abs(free.numpy() - got).max() > 1e-3
