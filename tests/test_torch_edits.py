"""Port parity: scene editing — the point warps and value edits of
``edits.py``, ``SDF(warp=)`` / ``with_warp`` and ``EditedModule``.

Seeded numpy points go through each edit of both packages; the warped SDF
is the reduced flagship surface of ``test_torch_params`` (8 spheres, a
non-zero 2x16 shift net) with the JAX params; its rays are two 16x16
NeRFCamera views of ``test_torch_occlusion``.  The gates are checked with
``fused_loops="force"``, under which an unwarped SphereSDF takes the
kernels on any device: the kernel wrappers are swapped for functions that
fail, so a route to them shows.

Tolerances: edit values rtol 1e-6 / atol 1e-6 and input gradients rtol
1e-5 / atol 1e-5 (float32 in another order); at the centre of ``add_hole``
JAX's norm gradient is NaN and torch's 0 (ROADMAP.md, Queue 3's accepted
note), so gradients are compared where JAX's is finite; the warped
surface's values rtol 1e-5 / atol 1e-5 of the largest, its intersections
as ``test_torch_path``'s integrators (hit flags equal on >= 99% of the
rays, values within 1e-4 of the largest where both hit, on all but 1%) and
its shadow flags equal on >= 99% of the rays.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu import edits as jedits
from neural_raytracing_tpu.shapes import SDF as JSDF
import neural_raytracing_tpu_torch.shapes.sdf as sdf_mod
from neural_raytracing_tpu_torch import edits
from neural_raytracing_tpu_torch.cameras import NeRFCamera
from neural_raytracing_tpu_torch.kernels import supports
from neural_raytracing_tpu_torch.render import _tile_positions
from neural_raytracing_tpu_torch.shapes import SDF
from neural_raytracing_tpu_torch.training import load_scene, save_scene
from test_torch_occlusion import C2W, FOCAL
from test_torch_params import build_scene, scene_pair
from test_torch_path import _compare

torch.set_num_threads(1)


def _points(n=512, seed=0, scale=0.8):
    p = np.random.default_rng(seed).uniform(-scale, scale, size=(n, 3)).astype(np.float32)
    # the hole's centre, an exact add_hole tie (|p| = 0.5 under radii 0.75
    # and 0.25) and points on the translate threshold
    p[0] = 0.0
    p[1] = (0.5, 0.0, 0.0)
    p[2, 1] = p[3, 1] = -0.05
    return p


WARPS = {
    "bend": lambda m: m.bend(k=2.5),
    "bend_axis2": lambda m: m.bend(k=-10.0, axis=2),
    "translate_above": lambda m: m.translate_above(a=0.1),
    "scale_axis": lambda m: m.scale_axis(s=0.2),
    "compose": lambda m: m.compose(m.bend(k=1.5), m.translate_above(a=0.2, coord=2, move=1),
                                   m.scale_axis(s=0.5, axis=0)),
}


def _value_and_grad_jax(fn, p, w):
    def loss(q):
        return jnp.sum(fn(q) * w)
    return np.asarray(fn(jnp.asarray(p))), np.asarray(jax.grad(loss)(jnp.asarray(p)))


def _value_and_grad_torch(fn, p, w):
    q = torch.from_numpy(p).requires_grad_()
    out = fn(q)
    (g,) = torch.autograd.grad(torch.sum(out * torch.from_numpy(w)), q)
    return out.detach().numpy(), g.numpy()


@pytest.mark.parametrize("name", sorted(WARPS))
def test_point_warps_match_jax(name):
    p = _points()
    w = np.random.default_rng(1).normal(size=p.shape).astype(np.float32)
    want, want_g = _value_and_grad_jax(WARPS[name](jedits), p, w)
    got, got_g = _value_and_grad_torch(WARPS[name](edits), p, w)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-5, atol=1e-5)


def _ball(lib, r=0.75):
    if lib == "jax":
        return lambda params, p: jnp.linalg.norm(p, axis=-1) - r
    return lambda p: torch.linalg.norm(p, dim=-1) - r


VALUE_EDITS = {
    "add_hole": lambda m, f: m.add_hole(f, radius=0.25),
    "add_hole_offset": lambda m, f: m.add_hole(f, radius=0.3, center=(0.1, -0.2, 0.05)),
    "displace": lambda m, f: m.displace(f),
    "displace_strong": lambda m, f: m.displace(f, amp=0.2, freq=7.0),
}


@pytest.mark.parametrize("name", sorted(VALUE_EDITS))
def test_value_edits_match_jax(name):
    p = _points()
    w = np.random.default_rng(2).normal(size=p.shape[:-1]).astype(np.float32)
    jfn = VALUE_EDITS[name](jedits, _ball("jax"))
    want, want_g = _value_and_grad_jax(lambda q: jfn(None, q), p, w)
    got, got_g = _value_and_grad_torch(VALUE_EDITS[name](edits, _ball("torch")), p, w)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.isfinite(got_g).all()
    finite = np.isfinite(want_g).all(-1)
    if name == "add_hole":
        assert not finite[0] and np.array_equal(got_g[0], np.zeros(3))   # norm at 0
        np.testing.assert_array_equal(want_g[1], np.zeros(3))            # the tie: halves
    np.testing.assert_allclose(got_g[finite], want_g[finite], rtol=1e-5, atol=1e-5)


# ---- the warped SDF on the reduced flagship surface --------------------------------------

@functools.lru_cache(maxsize=None)
def _rays():
    cam = NeRFCamera(torch.from_numpy(C2W), FOCAL)
    return cam.sample_positions(_tile_positions(0.0, 0.0, 16, "cpu"), size=16).numpy()


def _pair(warp_name=None, value_edit=None):
    """(JAX SDF, JAX shape params, port SDF) of the reduced flagship surface,
    under a warp or a value edit."""
    jscene, tree, scene = scene_pair()
    jsdf, sdf = jscene.shape, scene.shape
    if warp_name is not None:
        jsdf, sdf = (jsdf.with_warp(WARPS[warp_name](jedits)),
                     sdf.with_warp(WARPS[warp_name](edits)))
    if value_edit is not None:
        jsdf = JSDF(jedits.EditedModule(jsdf.module,
                                        lambda f: VALUE_EDITS[value_edit](jedits, f)),
                    max_steps=jsdf.max_steps)
        sdf = SDF(edits.EditedModule(sdf.module, lambda f: VALUE_EDITS[value_edit](edits, f)),
                  max_steps=sdf.max_steps)
    return jsdf, tree["shape"], sdf


CASES = [("bend", None), ("translate_above", None), ("scale_axis", None),
         ("compose", None), (None, "displace_strong"), (None, "add_hole_offset")]


@pytest.mark.parametrize("warp_name,value_edit", CASES)
def test_edited_sdf_values_and_normals_match_jax(warp_name, value_edit):
    jsdf, params, sdf = _pair(warp_name, value_edit)
    p = _points(seed=5)
    want = np.asarray(jsdf.sdf(jax.tree.map(jnp.asarray, params), jnp.asarray(p)))
    want_n = np.asarray(jsdf.normals(jax.tree.map(jnp.asarray, params), jnp.asarray(p)))
    with torch.no_grad():
        got = sdf.sdf(torch.from_numpy(p)).numpy()
        got_n = sdf.normals(torch.from_numpy(p)).numpy()
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    finite = np.isfinite(want_n).all(-1)
    assert finite.mean() > 0.99 and np.isfinite(got_n).all()
    np.testing.assert_allclose(got_n[finite], want_n[finite], rtol=1e-5,
                               atol=1e-5 * np.abs(want_n[finite]).max())


@functools.lru_cache(maxsize=None)
def _jax_intersect(warp_name, value_edit, primary):
    jsdf, params, _ = _pair(warp_name, value_edit)
    it, hit = jax.jit(lambda pr, r: jsdf.intersect(pr, r, primary=primary))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(_rays()))
    tp = None if it.throughput is None else np.asarray(it.throughput)
    return np.asarray(it.p), np.asarray(it.t), np.asarray(it.n), tp, np.asarray(hit)


@pytest.mark.parametrize("primary", [False, True])
@pytest.mark.parametrize("warp_name,value_edit", [("bend", None), (None, "displace_strong")])
def test_edited_intersect_matches_jax(warp_name, value_edit, primary):
    jp, jt, jn, jtp, jhit = _jax_intersect(warp_name, value_edit, primary)
    _, _, sdf = _pair(warp_name, value_edit)
    with torch.no_grad():
        it, hit = sdf.intersect(torch.from_numpy(_rays()), primary=primary)
    hit = hit.numpy()
    _compare(it.p.numpy(), hit, jp, jhit, "p")
    _compare(it.t.numpy()[..., None], hit, jt[..., None], jhit, "t")
    _compare(it.n.numpy(), hit, jn, jhit, "n")
    if primary:
        tp, scale = it.throughput.numpy(), np.abs(jtp).max()
        assert (np.abs(tp - jtp) <= 1e-5 * scale + 1e-5 * np.abs(jtp)).mean() >= 0.99
    else:
        assert it.throughput is None and jtp is None


@pytest.mark.parametrize("warp_name,value_edit", [("bend", None), (None, "add_hole_offset")])
def test_edited_intersect_test_matches_jax(warp_name, value_edit):
    jsdf, params, sdf = _pair(warp_name, value_edit)
    rays = _rays().reshape(-1, 6)
    # shadow rays from points around the surface towards a light above it
    rng = np.random.default_rng(7)
    o = rng.uniform(-0.6, 0.6, size=(rays.shape[0], 3)).astype(np.float32)
    d = np.asarray([0.2, 0.9, 0.6], np.float32) - o
    dist = np.linalg.norm(d, axis=-1)
    shadow = np.concatenate([o, d / dist[:, None]], -1).astype(np.float32)
    want = np.asarray(jsdf.intersect_test(jax.tree.map(jnp.asarray, params),
                                          jnp.asarray(shadow), max_t=jnp.asarray(dist)))
    got = sdf.intersect_test(torch.from_numpy(shadow), max_t=torch.from_numpy(dist)).numpy()
    assert 0.05 < want.mean() < 0.95
    assert (got == want).mean() >= 0.99


# ---- the gates ---------------------------------------------------------------------------

def _no_kernels(monkeypatch):
    """Every kernel route of ``shapes.sdf`` fails; returns the routes taken."""
    taken = []

    def fail(name):
        def fn(*a, **k):
            taken.append(name)
            raise AssertionError(f"{name} was routed to")
        return fn

    for name in ("fused_march", "fused_min_scan", "fused_shadow_march",
                 "sphere_sdf_eval_plain"):
        monkeypatch.setattr(sdf_mod, name, fail(name))
    return taken


def _forced(sdf, **kw):
    return sdf.replace(fused_loops="force", **kw)


def test_the_gates_route_an_unwarped_sphere_sdf_to_the_kernels(monkeypatch):
    _, _, sdf = _pair()
    taken = _no_kernels(monkeypatch)
    rays = torch.from_numpy(_rays())
    for call in (lambda s: s.intersect(rays, primary=False),
                 lambda s: s.throughput(rays[..., :3], rays[..., 3:]),
                 lambda s: s.intersect_test(rays)):
        with pytest.raises(AssertionError):
            call(_forced(sdf))
    assert taken == ["fused_march", "fused_min_scan", "fused_shadow_march"]


@pytest.mark.parametrize("edit", ["warp", "edited_module"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_no_kernel_route_under_a_warp_or_an_edited_module(edit, dtype, monkeypatch):
    warp, value = ("bend", None) if edit == "warp" else (None, "displace_strong")
    _, _, sdf = _pair(warp, value)
    sdf = _forced(sdf, march_dtype=dtype)
    assert not sdf._use_kernel(torch.zeros(1, 3))
    assert sdf._loop_sdf() == sdf.sdf
    assert supports(sdf.module) == (edit == "warp")
    taken = _no_kernels(monkeypatch)
    rays = torch.from_numpy(_rays())
    with torch.no_grad():
        it, hit = sdf.intersect(rays, primary=True)
        sdf.intersect_test(rays)
    assert taken == [] and hit.any()


def test_a_bf16_march_under_a_warp_takes_the_f32_loop(monkeypatch):
    _, _, sdf = _pair("bend")
    rays = torch.from_numpy(_rays())
    f32 = sdf._march(rays[..., :3], rays[..., 3:], 10.0)
    taken = _no_kernels(monkeypatch)
    bf16 = sdf.replace(march_dtype=torch.bfloat16)
    got = bf16._march(rays[..., :3], rays[..., 3:], 10.0)
    assert taken == []
    for a, b in zip(got, f32):
        assert torch.equal(a, b)
    # unwarped, the bf16 march reads the bf16 plain version (it differs)
    monkeypatch.undo()
    plain = sdf.replace(warp=None, march_dtype=torch.bfloat16)
    assert plain._loop_sdf() != plain.sdf


def test_replace_keeps_the_warp_and_with_warp_replaces_it():
    _, _, sdf = _pair()
    w1, w2 = edits.bend(k=2.5), edits.scale_axis(s=0.5)
    warped = sdf.with_warp(w1)
    assert warped.replace(max_steps=7).warp is w1
    assert warped.replace(max_steps=7).max_steps == 7
    assert warped.with_warp(w2).warp is w2
    assert sdf.warp is None                                    # a view; the original is kept
    p = torch.from_numpy(_points(seed=9))
    with torch.no_grad():
        assert torch.equal(warped.with_warp(w2).sdf(p), sdf.with_warp(w2).sdf(p))
        assert torch.equal(warped.sdf(p), sdf.module(w1(p)))
    # every other setting carries over, the parameters are the same tensors
    s = sdf.replace(epsilon=2e-3, omega=1.3, march_bound=1.2, throughput_steps=64)
    v = s.with_warp(w1)
    for k in ("epsilon", "omega", "march_bound", "throughput_steps", "max_steps", "dist",
              "alpha", "fused_loops", "march_dtype", "shadow_past_light_exit"):
        assert getattr(v, k) == getattr(s, k), k
    assert v.centers is sdf.centers and v.shift is sdf.shift


@pytest.mark.parametrize("order", ["edit_then_load", "load_then_edit"])
def test_edited_module_scene_loads_the_same_artifact(order, tmp_path):
    _, tree, scene = scene_pair()
    save_scene(str(tmp_path), scene)
    fresh = build_scene("torch")
    fresh.init(torch.Generator().manual_seed(3), device="cpu")

    def edit(s):
        return s.replace(shape=SDF(edits.EditedModule(s.shape.module, edits.displace)))

    if order == "edit_then_load":
        fresh = edit(fresh)
        load_scene(str(tmp_path), fresh)
    else:
        load_scene(str(tmp_path), fresh)
        fresh = edit(fresh)
    want = scene.state_dict()
    got = fresh.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert isinstance(fresh.shape.module, edits.EditedModule)
    p = torch.from_numpy(_points(seed=4))
    with torch.no_grad():
        np.testing.assert_array_equal(fresh.shape.sdf(p).numpy(),
                                      edits.displace(scene.shape.module)(p).numpy())


def test_edited_module_owns_no_parameters_of_its_own():
    _, _, scene = scene_pair()
    module = scene.shape.module
    em = edits.EditedModule(module, edits.add_hole)
    assert dict(em.named_parameters()).keys() == dict(module.named_parameters()).keys()
    assert all(a is b for a, b in zip(em.parameters(), module.parameters()))
    assert em.shift is module.shift and not supports(em)
    with pytest.raises(ValueError):
        edits.EditedModule(module.shift, edits.displace)      # a module with a buffer
