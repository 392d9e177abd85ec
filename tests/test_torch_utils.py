"""Port parity: ``utils``, ``profiling``, ``ops.misc``, the rest of
``ops.math`` and ``ops.frames``, ``cameras.spherical_positions``,
``bsdf.identity`` / ``Diffuse(preprocess=)``, callable activations, the
``fit_sphere`` and visualization twins, and the export parity of the two
packages.

Each function runs on the same seeded numpy inputs in both packages.
Tolerances: values atol 1e-6 (rtol 1e-5), gradients of a seeded weighting
of the outputs atol 1e-5 (rtol 1e-4); integer bins exactly; the sphere
render of ``sphere_render_bsdf`` atol 1e-5 with the camera jitter off in
both packages (each package's ``pathtrace`` called with ``with_noise=0``:
their jitter generators differ); ``fit_sphere``'s first-step loss rtol 1e-5
with the silhouette jitter off in both (the JAX SDF's ``throughput``
keyless, the port without a generator, ``test_torch_train_step``'s way).

The export-parity test reads every module of the JAX package with ``ast``
and asserts that each public name it defines or re-exports is bound in the
port's module of the same path (typing imports left out).
"""

import ast
import functools
import os
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_raytracing_tpu as J
import neural_raytracing_tpu.ops.math as JM
import neural_raytracing_tpu.ops.misc as JX
import neural_raytracing_tpu_torch as T
import neural_raytracing_tpu_torch.ops.math as TM
import neural_raytracing_tpu_torch.ops.misc as TX
from neural_raytracing_tpu_torch import profiling, utils
from neural_raytracing_tpu_torch.params import load_jax_params, state_dict_from_jax
from test_torch_bsdf_sampling import replay  # noqa: F401  (a fixture)
from test_torch_params import jax_tree_from_port

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))


def _pair(jfn, tfn, *arrays, grad=True, out_index=None):
    """Run ``jfn`` and ``tfn`` on the arrays; compare the (float) outputs
    and the gradients of a seeded weighting of them."""
    rng = np.random.default_rng(len(arrays) + sum(a.size for a in arrays))

    def pick(out):
        return out if out_index is None else out[out_index]

    want = pick(jax.jit(jfn)(*map(jnp.asarray, arrays)))
    ts = [torch.from_numpy(a).requires_grad_(grad) for a in arrays]
    got = pick(tfn(*ts))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
    if not grad:
        return
    weight = rng.normal(size=np.shape(want)).astype(np.float32)
    jg = jax.jit(jax.grad(lambda *a: jnp.sum(pick(jfn(*a)) * weight),
                          argnums=tuple(range(len(arrays)))))(*map(jnp.asarray, arrays))
    (got * torch.from_numpy(weight)).sum().backward()
    for t, g in zip(ts, jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5, rtol=1e-4)


def _points(n=64, seed=0, scale=2.0):
    return (scale * np.random.default_rng(seed).normal(size=(n, 3))).astype(np.float32)


# ---- ops.misc ---------------------------------------------------------------------------

def test_misc_partition_helpers_match_jax():
    p = _points()
    p[0] = 0.0                                   # the eps guards
    p[1, :2] = 0.0
    _pair(JX.cartesian_to_log_polar, TX.cartesian_to_log_polar, p)
    lp = np.asarray(JX.cartesian_to_log_polar(jnp.asarray(p)))
    for i in (0, 1):
        _pair(JX.log_polar_indices, TX.log_polar_indices, lp, out_index=1)
        want, got = JX.log_polar_indices(jnp.asarray(lp)), TX.log_polar_indices(
            torch.from_numpy(lp))
        assert got[0].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        _pair(JX.cartesian_indices, TX.cartesian_indices, p, out_index=1)
        want, got = JX.cartesian_indices(jnp.asarray(p)), TX.cartesian_indices(
            torch.from_numpy(p))
        assert got[0].dtype == torch.int32
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        lp, p = lp * 3.0, p * 3.0                # past the clips


def test_misc_ray_and_image_helpers_match_jax():
    d = _points(seed=1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for k in (0, 1):
        _pair(JX.finite_diff_ray, TX.finite_diff_ray, d, out_index=k)
    img = np.random.default_rng(2).uniform(size=(9, 7, 3)).astype(np.float32)
    _pair(JX.edge_detection, TX.edge_detection, img)
    x = np.random.default_rng(3).uniform(-0.99, 0.99, size=(50,)).astype(np.float32)
    _pair(JX.inverse_tan_activation, TX.inverse_tan_activation, x)
    np.testing.assert_allclose(TX.gaussian_kernel(3, 1.5).numpy(),
                               np.asarray(JX.gaussian_kernel(3, 1.5)), atol=1e-7)
    assert TX.gaussian_kernel(2).dtype == torch.float32
    np.testing.assert_array_equal(TX.crop(torch.from_numpy(img), 2, 1, 4).numpy(),
                                  np.asarray(JX.crop(jnp.asarray(img), 2, 1, 4)))


# ---- ops.math, ops.frames, cameras ------------------------------------------------------

@pytest.mark.parametrize("name", ["weak_sigmoid", "pos_weak_sigmoid", "almost_identity"])
def test_math_scalar_functions_match_jax(name):
    x = np.random.default_rng(4).normal(scale=0.3, size=(200,)).astype(np.float32)
    x[:4] = [0.0, 1e-4, -1e-4, 0.1]             # the linear regions and the thresholds
    _pair(getattr(JM, name), getattr(TM, name), x)


def test_math_vector_functions_match_jax():
    rng = np.random.default_rng(5)
    a, b = (rng.normal(size=(10, 3)).astype(np.float32) for _ in range(2))
    _pair(JM.dot, TM.dot, a, b)
    _pair(functools.partial(JM.dot, keepdims=False), functools.partial(TM.dot, keepdims=False),
          a, b)
    img = rng.normal(size=(2, 5, 4, 3)).astype(np.float32)
    _pair(JM.fwidth, TM.fwidth, img)
    q, r = (rng.normal(size=(6, 4)).astype(np.float32) for _ in range(2))
    _pair(JM.qmul, TM.qmul, q, r)
    axis = a / np.linalg.norm(a, axis=-1, keepdims=True)
    theta = rng.uniform(-3, 3, size=(10, 1)).astype(np.float32)
    _pair(JM.quat_rot, TM.quat_rot, b, axis, theta)
    # a scalar angle, as the JAX function takes it too
    np.testing.assert_allclose(TM.quat_rot(torch.from_numpy(b), torch.from_numpy(axis),
                                           0.7).numpy(),
                               np.asarray(JM.quat_rot(jnp.asarray(b), jnp.asarray(axis), 0.7)),
                               atol=1e-6)
    assert (TM.PI, TM.TWO_PI, TM.INV_PI) == (JM.PI, JM.TWO_PI, JM.INV_PI)


def test_partial_frame_and_spherical_positions_match_jax():
    from neural_raytracing_tpu.cameras import spherical_positions as jsp
    from neural_raytracing_tpu.ops.frames import partial_frame as jpf
    from neural_raytracing_tpu_torch.cameras import spherical_positions
    from neural_raytracing_tpu_torch.ops.frames import partial_frame
    rng = np.random.default_rng(6)
    n, wi = (rng.normal(size=(8, 3)).astype(np.float32) for _ in range(2))
    _pair(jpf, partial_frame, n, wi)
    for kw in ({}, dict(min_elev=-10.0, max_elev=60.0, n_elev=3, n_azim=5, dist=2.5)):
        (jr, jt), (r, t) = jsp(**kw), spherical_positions(**kw)
        assert r.shape == (kw.get("n_elev", 8) * kw.get("n_azim", 8), 3, 3)
        np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-6)
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-5)


# ---- bsdf, activations ------------------------------------------------------------------

def test_diffuse_preprocess_matches_jax():
    from neural_raytracing_tpu.bsdf import Diffuse as JDiffuse
    from neural_raytracing_tpu.bsdf import identity as jidentity
    from neural_raytracing_tpu.interaction import Interaction as JIt
    from neural_raytracing_tpu_torch.bsdf import Diffuse, identity, identity_div_pi
    from neural_raytracing_tpu_torch.interaction import Interaction
    rng = np.random.default_rng(7)
    wo = rng.normal(size=(20, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=-1, keepdims=True)
    p = rng.normal(size=(20, 3)).astype(np.float32)
    for jpre, pre in ((jidentity, identity), (None, None)):
        jb = JDiffuse((0.9, 0.5, 0.2)) if jpre is None else JDiffuse((0.9, 0.5, 0.2), jpre)
        b = Diffuse((0.9, 0.5, 0.2)) if pre is None else Diffuse((0.9, 0.5, 0.2), pre)
        assert b.preproc is (identity_div_pi if pre is None else identity)
        jspec, jpdf, _ = jb.eval_and_pdf(jb.init(), JIt(p=jnp.asarray(p), t=jnp.zeros(20)),
                                         jnp.asarray(wo))
        it = Interaction(p=torch.from_numpy(p), t=torch.zeros(20))
        spec, pdf, _ = b.eval_and_pdf(it, torch.from_numpy(wo))
        np.testing.assert_allclose(spec.detach().numpy(), np.asarray(jspec), atol=1e-7)
        np.testing.assert_allclose(pdf.numpy(), np.asarray(jpdf), atol=1e-7)
        _, jsample_spec = jb.sample(jb.init(), JIt(p=jnp.asarray(p), t=jnp.zeros(20)),
                                    jax.random.PRNGKey(0))
        _, sample_spec = b.sample(it, torch.Generator().manual_seed(0))
        np.testing.assert_allclose(sample_spec.detach().numpy(), np.asarray(jsample_spec),
                                   atol=1e-7)


def test_callable_activation_against_the_named_one():
    from neural_raytracing_tpu.nn import SkipConnMLP as JMLP
    from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP
    from neural_raytracing_tpu_torch.nn import (
        ACTIVATIONS, SkipConnMLP, activation_name, resolve_activation,
    )
    import torch.nn.functional as F
    cfg = dict(in_size=3, out=2, num_layers=3, hidden_size=16, freqs=4)
    params = jax.jit(JMLP(activation="softplus", **cfg).init)(jax.random.PRNGKey(0))
    x = _points(32, seed=8, scale=0.5)
    want = np.asarray(jax.jit(JMLP(activation=lambda v: jax.nn.softplus(v), **cfg).__call__)(
        params, jnp.asarray(x)))
    named = load_jax_params(SkipConnMLP(activation="softplus", **cfg), jax.tree.map(
        np.asarray, params), device="cpu")
    custom = lambda v: F.softplus(v)           # noqa: E731
    assert activation_name(ACTIVATIONS["softplus"]) == "softplus"
    assert activation_name(custom) is None and resolve_activation(custom) is custom
    with pytest.raises(ValueError, match="unknown activation"):
        resolve_activation("swish")
    for act, name in ((ACTIVATIONS["softplus"], "softplus"), (custom, None)):
        for cls, kw in ((SkipConnMLP, {}), (FusedSkipConnMLP, dict(mode="force"))):
            net = cls(activation=act, **cfg, **kw)
            net.load_state_dict(named.state_dict())
            assert net.activation_name == name
            if name is None:
                # no kernel takes a custom callable: it runs plain, even forced
                got = net(torch.from_numpy(x))
                np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
            elif kw:
                with pytest.raises(RuntimeError, match="needs CUDA"):
                    net(torch.from_numpy(x))
            else:
                torch.testing.assert_close(net(torch.from_numpy(x)), named(torch.from_numpy(x)),
                                           rtol=0, atol=0)
    # a custom shift net marches by the plain loop
    from neural_raytracing_tpu_torch.kernels import supports
    from neural_raytracing_tpu_torch.shapes import SphereSDF
    assert supports(SphereSDF(n=4, mlp=SkipConnMLP(in_size=3, out=1, activation="softplus")))
    assert not supports(SphereSDF(n=4, mlp=SkipConnMLP(in_size=3, out=1, activation=custom)))


# ---- utils ------------------------------------------------------------------------------

def test_sphere_render_bsdf_matches_jax(monkeypatch):
    from neural_raytracing_tpu.bsdf import Diffuse as JDiffuse
    from neural_raytracing_tpu.utils import sphere_render_bsdf as jrender
    from neural_raytracing_tpu_torch import render
    from neural_raytracing_tpu_torch.bsdf import Diffuse
    monkeypatch.setattr(J, "pathtrace", functools.partial(J.pathtrace, with_noise=0.0))
    monkeypatch.setattr(render, "pathtrace", functools.partial(render.pathtrace,
                                                               with_noise=0.0))
    jb = JDiffuse((0.9, 0.2, 0.1))
    want = np.asarray(jrender(jb, jb.init(), size=32, chunk_size=16))
    got = utils.sphere_render_bsdf(Diffuse((0.9, 0.2, 0.1)), size=32, chunk_size=16,
                                   device="cpu").numpy()
    assert got.shape == (32, 32, 3) and got[0, 0].min() == 1.0
    assert got[16, 16, 0] > got[16, 16, 2]
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sphere_examples_heightmap_and_depth_image():
    from neural_raytracing_tpu.utils import depth_image as jdepth
    from neural_raytracing_tpu.utils import heightmap as jheight
    from neural_raytracing_tpu.warps import MipMap as JMipMap
    from neural_raytracing_tpu_torch.bsdf import ComposeSpatialVarying, Diffuse
    from neural_raytracing_tpu_torch.nn import SkipConnMLP
    from neural_raytracing_tpu_torch.warps import MipMap
    mix = ComposeSpatialVarying([Diffuse((1.0, 0.1, 0.1)), Diffuse((0.1, 0.1, 1.0))],
                                sp_var_fn=SkipConnMLP(in_size=3, out=2, num_layers=2,
                                                      hidden_size=16, freqs=4))
    mix.reset_parameters(torch.Generator().manual_seed(0))
    a, b = utils.sphere_examples(mix, size=16, chunk_size=16)
    assert a[8, 8, 0] > a[8, 8, 2] and b[8, 8, 2] > b[8, 8, 0]
    jw = JMipMap(depth=4)
    jp = jw.init(jax.random.PRNGKey(1))
    w = load_jax_params(MipMap(depth=4), jax.tree.map(np.asarray, jp), device="cpu")
    np.testing.assert_allclose(utils.heightmap(w, size=12).detach().numpy(),
                               np.asarray(jheight(jw, jp, size=12)), atol=1e-6)
    img = np.random.default_rng(9).uniform(size=(5, 6, 2)).astype(np.float32)
    np.testing.assert_allclose(utils.depth_image(torch.from_numpy(img)).numpy(),
                               np.asarray(jdepth(jnp.asarray(img))), atol=1e-7)


@pytest.mark.parametrize("scene", ["flagship", "nerv", "hash"])
def test_count_parameters_counts_the_jax_tree(scene):
    """The port keeps some JAX leaves as buffers (the Fourier bases): its
    count is the JAX params tree's."""
    from neural_raytracing_tpu.utils import count_parameters as jcount
    from neural_raytracing_tpu_torch.workloads import nerf_synthetic, nerv
    import nerf_synthetic as jnerf_synthetic
    import nerv as jnerv
    if scene == "nerv":
        jscene, tscene = jnerv.build_scene(), nerv.build_scene()
    else:
        surface = "hash" if scene == "hash" else "spheres"
        jscene = jnerf_synthetic.build_scene(surface=surface)
        tscene = nerf_synthetic.build_scene(surface=surface)
    params = jax.eval_shape(jscene.init, jax.random.PRNGKey(0))
    for comp in ("shape", "bsdf", "lights", "occ"):
        part = getattr(tscene, comp, None)
        want = jcount(params.get(comp, {}))
        assert (utils.count_parameters(part) if part is not None else 0) == want, comp
    assert utils.count_parameters(tscene) == jcount(params)
    assert utils.count_parameters({"a": np.zeros((2, 3)), "b": (np.zeros(5),)}) == 11


# ---- profiling --------------------------------------------------------------------------

def test_throughput_meter_and_step_timer():
    m = profiling.Throughput()
    m.step(100)
    time.sleep(0.01)
    m.step(100)
    s = m.summary()
    assert s["rays_per_sec_ema"] > 0 and s["step_time_ema"] > 0
    assert m.total_rays == 100
    t = profiling.StepTimer()
    with t.phase("work", block_on={"x": torch.ones(3)}):
        time.sleep(0.01)
    with t.phase("work"):
        time.sleep(0.01)
    assert t.times["work"] >= 0.02


def test_trace_writes_a_file_with_the_annotation(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("nrt_step_phase"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    assert Path(prof.trace_path).parent == tmp_path
    assert "nrt_step_phase" in Path(prof.trace_path).read_text()


def test_debug_nans_toggles_anomaly_detection():
    profiling.debug_nans(True)
    try:
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    finally:
        profiling.debug_nans(False)
    assert not torch.is_anomaly_enabled()


# ---- the fit_sphere and visualization twins ---------------------------------------------

def test_fit_sphere_first_step_loss_matches_jax():
    import neural_raytracing_tpu.training as JT
    from neural_raytracing_tpu.bsdf import Diffuse as JDiffuse
    from neural_raytracing_tpu.cameras import FoVPerspectiveCamera as JFoV
    from neural_raytracing_tpu.cameras import look_at_view_transform as jlook
    from neural_raytracing_tpu.integrators import Direct as JDirect
    from neural_raytracing_tpu.lights import PointLights as JPointLights
    from neural_raytracing_tpu.shapes import SDF as JSDF
    from neural_raytracing_tpu.shapes import SphereSDF as JSphereSDF
    from neural_raytracing_tpu_torch.workloads import fit_sphere
    size, crop = 16, 12
    args = fit_sphere.parser().parse_args(["--size", str(size), "--crop-size", str(crop),
                                           "--iters", "1", "--device", "cpu", "--skip-test"])
    imgs, masks = fit_sphere.render_gt(size, "cpu")
    assert 0 < masks.mean() < 1 and np.isfinite(imgs).all()
    # scripts/fit_sphere.py's scene, optimizer and first train step
    jscene = J.Scene(shape=JSDF(JSphereSDF(n=32), max_steps=32, throughput_steps=64, dist=4.0),
                     bsdf=JDiffuse((0.5, 0.5, 0.5)),
                     lights=JPointLights(location=(0.0, 1.0, 4.0), scale=50.0))
    js = jscene.shape
    js.throughput = lambda params, r_o, r_d, key=None: JSDF.throughput(
        js, params, r_o, r_d, key=None)
    jopt = JT.make_optimizer(fit_sphere.LRS)
    # the twin's seeded weights, in both packages
    params = jax_tree_from_port(jscene, fit_sphere.build_scene().init(
        torch.Generator().manual_seed(args.seed), device="cpu"))
    jparams = jax.tree.map(jnp.asarray, params)        # the JAX step donates its state
    jstate = JT.TrainState(jparams, jopt.init(jparams), jnp.int32(0))
    r, t = jlook(dist=2.0, elev=np.tile(np.linspace(0, 40, 4), 4),
                 azim=np.repeat(np.linspace(-60, 60, 4), 4))
    cams = JFoV(R=r, T=t)
    make_camera = lambda idxs: JFoV(R=cams.R[np.asarray(idxs)], T=cams.T[np.asarray(idxs)])
    _, jlosses = JT.train(jscene, JDirect(training=True), jopt, jstate, make_camera, imgs,
                          masks, jax.random.PRNGKey(args.seed + 1), size=size, crop_size=crop,
                          iters=1, n_views=args.n_views, log_every=0)
    scene = load_jax_params(fit_sphere.build_scene(), params, device="cpu")
    out = fit_sphere.run(args, gt=(imgs, masks), scene=scene, generator=None, save=False,
                         log_fn=lambda *a: None)
    np.testing.assert_allclose(out["losses"][0], jlosses[0], rtol=1e-5)


def test_visualization_twins_render_on_the_cpu():
    """The three twins at 8^2 on seed-0 scenes: every image finite, of the
    expected count and shape."""
    from types import SimpleNamespace
    from neural_raytracing_tpu_torch.cameras import nerf_c2w
    from neural_raytracing_tpu_torch.training import DTUDataset, NeRFDataset
    from neural_raytracing_tpu_torch.workloads import dtu, dtu_vis, nerf_synthetic, nerv
    from neural_raytracing_tpu_torch.workloads import nerv_vis, visualize
    size = 8
    c2ws = np.stack([nerf_c2w(30, 45, 1.0), nerf_c2w(10, 160, 1.0)])[:, :3].astype(np.float32)
    nerf = NeRFDataset(c2ws, 0.5 * size / np.tan(0.35), np.zeros((2, size, size, 3)),
                       np.zeros((2, size, size)))
    seeded = lambda s: s.init(torch.Generator().manual_seed(0), device="cpu")  # noqa: E731
    base = dict(size=size, outputs="unused", device="cpu", cpu=False)
    v = visualize.run(SimpleNamespace(n_orbit=1, **base), nerf, "t",
                      scene=seeded(nerf_synthetic.build_scene(max_steps=16)), save=False,
                      log_fn=lambda *a: None)
    assert len(v["orbit"]) == 1 and len(v["basis"]) == 8 and len(v["spheres"]) == 8
    assert v["counts"]["shape"] > 0
    n = nerv_vis.run(SimpleNamespace(views=2, **base), nerf, "t",
                     scene=seeded(nerv.build_scene(max_steps=16)), save=False)
    assert len(n["weights"][1]) == 7 and n["sil"][0].shape == (size, size, 1)
    poses = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    poses[:, :3] = c2ws
    poses[:, :3, 1:3] *= -1                       # the OpenCV axes DTU cameras take
    k = np.tile(np.diag([size, size, 1.0, 1.0]).astype(np.float32), (2, 1, 1))
    k[:, :2, 2] = size / 2
    scan = DTUDataset(poses, k, np.zeros((2, size, size, 3)), np.zeros((2, size, size)),
                      (size, size))
    d = dtu_vis.run(SimpleNamespace(views=1, **base), scan, "t",
                    scene=seeded(dtu.build_scene(max_steps=16)), save=False)
    assert len(d["render"]) == 1 and len(d["weights"][0]) == 6
    for out in (v, n, d):
        for key, images in out.items():
            if key == "counts":
                continue
            flat = images.values() if isinstance(images, dict) else images
            for img in flat:
                for a in (img if isinstance(img, list) else [img]):
                    assert np.isfinite(a).all(), key


# ---- the visualization twins against their scripts' flows ------------------------------

VS = 16                                 # the views' and the spheres' size


def _vis_scene(lib):
    """A reduced scene of the flagship's structure (SDF(SphereSDF) +
    ComposeSpatialVarying of NeuralBSDF lobes + LightField) with 2 lobes and
    2-layer nets, built from the JAX package or the port.  NeRV's scene is lit by point
    lights instead, which none of ``nerv_vis``'s renders reads (the sphere
    renders bring their own), so the three twins share this one."""
    from test_torch_params import NETS
    if lib == "jax":
        from neural_raytracing_tpu.bsdf import ComposeSpatialVarying as compose
        from neural_raytracing_tpu.bsdf import NeuralBSDF as lobe
        from neural_raytracing_tpu.kernels import FusedSkipConnMLP as mlp
        from neural_raytracing_tpu.lights import LightField
        from neural_raytracing_tpu.shapes import SDF as sdf
        from neural_raytracing_tpu.shapes import SphereSDF as sphere
        scene = J.Scene
    else:
        from neural_raytracing_tpu_torch.bsdf import ComposeSpatialVarying as compose
        from neural_raytracing_tpu_torch.bsdf import NeuralBSDF as lobe
        from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP as mlp
        from neural_raytracing_tpu_torch.lights import LightField
        from neural_raytracing_tpu_torch.shapes import SDF as sdf
        from neural_raytracing_tpu_torch.shapes import SphereSDF as sphere
        scene = T.Scene
    narrow = lambda net, **kw: mlp(**dict(NETS[net], num_layers=2, **kw))  # noqa: E731
    return scene(shape=sdf(sphere(n=8, mlp=mlp(**NETS["shift"])), max_steps=48),
                 bsdf=compose([lobe(activation="softplus", mlp=narrow("lobe"))
                               for _ in range(2)], sp_var_fn=narrow("weight", out=2)),
                 lights=LightField(mlp=narrow("light")))


@functools.lru_cache(maxsize=None)
def _jax_vis():
    """The JAX side the twins share: the scene, its params (numpy: the
    port's seed-0 weights, the shift net's output scaled by 0.1 and the
    radii raised to [0.25, 0.35] as ``test_torch_params.scene_params``
    does), its sphere renders
    (``utils.sphere_examples``) and one instance of each integrator, so
    that each render compiles once."""
    from neural_raytracing_tpu.integrators import BasisBRDF, Debug, Direct, Silhouette
    from neural_raytracing_tpu.utils import sphere_examples
    jscene = _vis_scene("jax")
    tree = jax_tree_from_port(jscene, _vis_scene("torch").init(
        torch.Generator().manual_seed(0), device="cpu"))
    shape = tree["shape"]
    shape["shift"]["out"] = {k: 0.1 * v for k, v in shape["shift"]["out"].items()}
    shape["radii"] = 0.3 + 0.5 * shape["radii"]
    params = jax.tree.map(jnp.asarray, tree)
    spheres = [np.asarray(img) for img in sphere_examples(jscene.bsdf, params["bsdf"], size=VS)]
    integ = {"direct": Direct(training=False), "debug": Debug(), "sil": Silhouette(),
             "basis": BasisBRDF(jscene.bsdf)}
    return jscene, tree, params, spheres, integ


def _vis_data(twin):
    """Two views at VS^2: the NeRF cameras of ``test_torch_occlusion``, or
    two of ``test_torch_dtu_workload``'s generator views."""
    from neural_raytracing_tpu_torch.training import NeRFDataset, NeRVDataset
    from test_torch_occlusion import C2W, FOCAL, SIZE
    assert SIZE == VS
    blank = np.zeros((2, VS, VS, 3), np.float32)
    if twin == "visualize":
        return NeRFDataset(C2W.astype(np.float32), float(FOCAL), blank, blank[..., 0])
    if twin == "nerv_vis":
        return NeRVDataset(C2W.astype(np.float32), float(FOCAL), blank, blank[..., 0],
                           np.zeros((2, 3), np.float32), None)
    from test_torch_dtu_workload import SIZE as DTU_SIZE
    from test_torch_dtu_workload import _split
    assert DTU_SIZE == VS
    d = _split()
    return d._replace(poses=d.poses[1:3], intrinsics=d.intrinsics[1:3], images=d.images[1:3],
                      masks=d.masks[1:3])


def _jax_vis_flow(twin, data):
    """The flow of ``scripts/{twin}.py`` at VS^2 on two views -> (its
    images in the twin's layout, the camera jitter it draws in the twin's
    call order)."""
    from neural_raytracing_tpu.cameras import DTUCamera, NeRFCamera
    from neural_raytracing_tpu.utils import count_parameters
    from test_torch_bsdf_sampling import uniform
    jscene, _, params, sphere_imgs, integ = _jax_vis()
    jitter = []

    def render(cam, name, key, dtu=False):
        img, _ = J.pathtrace(jscene, params, cam, integ[name], size=VS, chunk_size=VS,
                             background=0.0, key=jax.random.PRNGKey(key))
        if not dtu:                        # the DTU camera takes no jitter
            ckey, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(key), 0))
            jitter.append(uniform(ckey, (VS, VS, 4, 2)))     # pathtrace's bundle of 4
        return np.asarray(img)

    def spheres():                     # sphere_render_bsdf: PRNGKey(0), a bundle of 1
        ckey, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 0))
        jitter.extend(uniform(ckey, (VS, VS, 1, 2)) for _ in sphere_imgs)
        return list(sphere_imgs)

    def split(weights):
        return [weights[..., b:b + 1] for b in range(weights.shape[-1])]

    nerf_cam = lambda i: NeRFCamera(cam_to_world=jnp.asarray(data.cam_to_worlds[i:i + 1]),  # noqa: E731
                                    focal=data.focal)
    if twin == "visualize":                      # scripts/visualize.py:45-77
        out = {"counts": {c: count_parameters(params.get(c, {}))
                          for c in ("shape", "bsdf", "lights")}, "orbit": {}, "normals": {}}
        for i in range(2):                         # --n-orbit 2: views 0 and 1
            out["orbit"][i] = render(nerf_cam(i), "direct", i)
            out["normals"][i] = render(nerf_cam(i), "debug", i)
        out["basis"] = split(render(nerf_cam(0), "basis", 0))
        out["spheres"] = spheres()
        return out, jitter
    out = {"spheres": spheres(), "weights": {}, "normals": {}}
    if twin == "nerv_vis":                       # scripts/nerv_vis.py:41-64
        out["sil"] = {}
        for i in range(2):
            out["weights"][i] = split(render(nerf_cam(i), "basis", i))
            out["normals"][i] = render(nerf_cam(i), "debug", i)
            out["sil"][i] = render(nerf_cam(i), "sil", i)
        return out, jitter
    out["render"] = {}                           # scripts/dtu_vis.py:46-83
    src = np.asarray(data.src_size, np.float32)
    for i in range(2):
        cam = DTUCamera(pose=jnp.asarray(data.poses[i:i + 1]),
                        intrinsic=jnp.asarray(data.intrinsics[i:i + 1]), src_size=src)
        out["weights"][i] = split(render(cam, "basis", i, dtu=True))
        out["normals"][i] = render(cam, "debug", i, dtu=True)
        out["render"][i] = render(cam, "direct", i, dtu=True)
    return out, jitter


def _images(tree, path=""):
    """The images of a twin's result, by path."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _images(sub, f"{path}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for b, sub in enumerate(tree) for k, v in _images(sub, f"{path}/{b}").items()}
    return {path: np.asarray(tree)}


@pytest.mark.parametrize("twin", ["visualize", "nerv_vis", "dtu_vis"])
def test_visualization_twin_matches_its_scripts_flow(twin, replay):
    """Each twin against its JAX script's flow on the same carried params
    at 16^2 on two views, every image compared: the renders, normals, basis
    weights as ``test_torch_path``'s integrators (the lit pixels equal on
    >= 99%, values within 1e-4 of the largest on all but 1% where both are
    lit), the silhouettes exactly, the sphere renders (white background)
    within 1e-4 of the largest everywhere, the parameter counts exactly."""
    from neural_raytracing_tpu_torch.workloads import dtu_vis, nerv_vis, visualize
    from test_torch_path import _compare
    module = {"visualize": visualize, "nerv_vis": nerv_vis, "dtu_vis": dtu_vis}[twin]
    want, jitter = _jax_vis_flow(twin, _vis_data(twin))
    scene = load_jax_params(_vis_scene("torch"), _jax_vis()[1], device="cpu")
    argv = ["--data", "(in memory)", "--size", str(VS), "--device", "cpu"]
    argv += ["--n-orbit", "2"] if twin == "visualize" else ["--views", "2"]
    replay(jitter)
    kw = dict(log_fn=lambda *a: None) if twin == "visualize" else {}
    got = module.run(module.parser().parse_args(argv), _vis_data(twin), "t", scene=scene,
                     save=False, **kw)
    if twin == "visualize":
        assert got.pop("counts") == want.pop("counts")
    got, want = _images(got), _images(want)
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        if path.startswith("/spheres"):
            assert (w != 1.0).any() and w[0, 0].min() == 1.0, path
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=path)
        elif path.startswith("/sil"):
            # 1 - hit, on the background 0: black wherever the script renders
            np.testing.assert_array_equal(g, w, err_msg=path)
        else:
            lit = lambda a: np.abs(a).sum(-1) > 0        # noqa: E731
            _compare(g, lit(g), w, lit(w), path)


# ---- export parity ----------------------------------------------------------------------

TYPING = {"Any", "Callable", "Dict", "List", "NamedTuple", "Optional", "Sequence", "Tuple",
          "Union"}
# the JAX package's TPU backend query: the port decides by the tensor's device
TPU_ONLY = {"on_tpu"}


def _bound(path: Path, imports: bool) -> set:
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef, ast.AsyncFunctionDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and (imports or path.name == "__init__.py"):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.Import) and imports:
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
    return {n for n in names if not n.startswith("_")}


JAX_MODULES = sorted(str(p.relative_to(ROOT / "neural_raytracing_tpu"))
                     for p in (ROOT / "neural_raytracing_tpu").rglob("*.py"))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_jax_name_has_its_port_counterpart(module):
    jax_names = _bound(ROOT / "neural_raytracing_tpu" / module, imports=False)
    port = ROOT / "neural_raytracing_tpu_torch" / module
    assert port.exists(), f"no port module {module}"
    missing = jax_names - _bound(port, imports=True) - TYPING - TPU_ONLY
    assert not missing, f"{module}: {sorted(missing)}"
