"""Port parity: the colocate workload twin ``workloads.colocate`` — the strict
load of a JAX colocate scene, one reduced training step (``extra_loss`` and
the colocated ``light_update``) against the JAX step, the hard-shadow eval
render, and ``workloads.make_dataset`` -> ``workloads.colocate.main`` ->
``workloads.render --workload colocate`` end to end on the CPU.

The reduced scene keeps the structure of ``scripts/colocate.py``
(SDF(SphereSDF) + ComposeSpatialVarying([NeuralBSDF(softplus) x 2, Diffuse,
Conductor]) + PointLights(scale=5) + the occlusion MLP) at the narrow widths
of ``test_torch_params`` and 8 spheres; FoV cameras on the colocated grid at
distance 1, each view lit at 1.05 x its camera centre; analytic ground truth
of a sphere.  As in ``test_torch_nerv``, the JAX SDF's ``throughput`` is
swapped for a keyless one.

Tolerances (as ``test_torch_nerv``): the loss rtol 1e-5; each gradient leaf
within 1e-4 of its max|JAX gradient| (float32 sums in another order through
the march, the min-scan, the shadow march and the eikonal double backward),
the light intensity's within 1e-3 (it enters normalised: a difference of
nearly equal sums); AdamW updates within 1e-3 of the learning rate plus two
float32 spacings of the leaf's largest value where the JAX gradient is above
1e-3 of the leaf's max; the eval render's hit mask equal on >= 99% of the
pixels and the colour within 1e-4 where both hit.
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

import colocate as jcolocate  # noqa: E402  (scripts/colocate.py)

import neural_raytracing_tpu as J  # noqa: E402
import neural_raytracing_tpu.training as JT  # noqa: E402
from neural_raytracing_tpu.bsdf import ComposeSpatialVarying as JCompose  # noqa: E402
from neural_raytracing_tpu.bsdf import Conductor as JConductor  # noqa: E402
from neural_raytracing_tpu.bsdf import Diffuse as JDiffuse  # noqa: E402
from neural_raytracing_tpu.bsdf import NeuralBSDF as JNeuralBSDF  # noqa: E402
from neural_raytracing_tpu.cameras import FoVPerspectiveCamera as JFoV  # noqa: E402
from neural_raytracing_tpu.integrators import Direct as JDirect  # noqa: E402
from neural_raytracing_tpu.kernels import FusedSkipConnMLP as JFused  # noqa: E402
from neural_raytracing_tpu.lights import PointLights as JPointLights  # noqa: E402
from neural_raytracing_tpu.nn import SkipConnMLP as JMLP  # noqa: E402
from neural_raytracing_tpu.shapes import SDF as JSDF  # noqa: E402
from neural_raytracing_tpu.shapes import SphereSDF as JSphereSDF  # noqa: E402
import neural_raytracing_tpu_torch as T  # noqa: E402
import neural_raytracing_tpu_torch.training as TT  # noqa: E402
from neural_raytracing_tpu_torch.bsdf import (  # noqa: E402
    ComposeSpatialVarying, Conductor, Diffuse, NeuralBSDF,
)
from neural_raytracing_tpu_torch.cameras import (  # noqa: E402
    FoVPerspectiveCamera, look_at_view_transform,
)
from neural_raytracing_tpu_torch.integrators import Direct  # noqa: E402
from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP  # noqa: E402
from neural_raytracing_tpu_torch.lights import PointLights  # noqa: E402
from neural_raytracing_tpu_torch.nn import SkipConnMLP  # noqa: E402
from neural_raytracing_tpu_torch.params import load_jax_params, state_dict_from_jax  # noqa: E402
from neural_raytracing_tpu_torch.render import _tile_positions  # noqa: E402
from neural_raytracing_tpu_torch.shapes import SDF, SphereSDF  # noqa: E402
from neural_raytracing_tpu_torch.workloads import colocate, make_dataset, render  # noqa: E402
from test_torch_colocate import _jax_extra_loss  # noqa: E402
from test_torch_params import NETS, scene_params  # noqa: E402

torch.set_num_threads(1)
SIZE, CROP, UV = 16, 12, (2, 2)
LRS = {"shape": 8e-5, "bsdf": 8e-5, "lights": 8e-5, "occ": 8e-5}
OCC = dict(in_size=5, out=1, num_layers=2, hidden_size=16, freqs=4)
VIEWS = ((20.0, 30.0), (40.0, -60.0))          # (elevation, azimuth) at distance 1


def _flat(tree):
    return {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree.map(np.asarray, tree)).items()}


def colocate_scene(lib, max_steps=16, occlusion="learned"):
    """The reduced colocate scene, built from the JAX package ("jax") or the port."""
    if lib == "jax":
        mlp, plain, scene, sdf, sphere = JFused, JMLP, J.Scene, JSDF, JSphereSDF
        compose, lobe, diffuse, conductor, lights = (JCompose, JNeuralBSDF, JDiffuse,
                                                     JConductor, JPointLights)
    else:
        mlp, plain, scene, sdf, sphere = FusedSkipConnMLP, SkipConnMLP, T.Scene, SDF, SphereSDF
        compose, lobe, diffuse, conductor, lights = (ComposeSpatialVarying, NeuralBSDF,
                                                     Diffuse, Conductor, PointLights)
    bases = [lobe(activation="softplus", mlp=mlp(**NETS["lobe"])) for _ in range(2)]
    return scene(
        shape=sdf(sphere(n=8, mlp=mlp(**NETS["shift"])), max_steps=max_steps,
                  throughput_steps=16, dist=2.2),
        bsdf=compose(bases + [diffuse(), conductor()],
                     sp_var_fn=mlp(**dict(NETS["weight"], out=4))),
        lights=lights(scale=5.0), occ=plain(**OCC), occlusion=occlusion)


def colocate_pair(**kw):
    """(JAX scene, JAX params, port scene on the CPU with those params)."""
    jscene = colocate_scene("jax", **kw)
    tree = scene_params(jscene)
    return jscene, tree, load_jax_params(colocate_scene("torch", **kw), tree, device="cpu")


def _cameras():
    """-> (port camera, JAX camera, light locations [V, 3] at 1.05 x the centres)."""
    r, t = look_at_view_transform(dist=1.0, elev=[v[0] for v in VIEWS],
                                  azim=[v[1] for v in VIEWS])
    cam = FoVPerspectiveCamera(R=r, T=t)
    jcam = JFoV(R=jnp.asarray(r.numpy()), T=jnp.asarray(t.numpy()))
    return cam, jcam, cam.camera_center().numpy() * 1.05


def _gt():
    """A sphere of radius 0.3 seen by the cameras, shaded by its normal."""
    cam, _, _ = _cameras()
    rays = cam.sample_positions(_tile_positions(0.0, 0.0, SIZE, "cpu"), size=SIZE)
    r_o, r_d = rays[..., 0, :3].double().numpy(), rays[..., 0, 3:].double().numpy()
    b = np.sum(r_o * r_d, -1)
    disc = b * b - (np.sum(r_o * r_o, -1) - 0.3 ** 2)
    mask = (disc > 0).astype(np.float32)
    n = (r_o + (-b - np.sqrt(np.maximum(disc, 0)))[..., None] * r_d) / 0.3
    shade = np.clip(-np.sum(n * r_d, -1), 0, 1)
    img = mask[..., None] * shade[..., None] * np.asarray([0.6, 0.4, 0.3])
    return img.astype(np.float32), mask


def _keyless(jscene):
    js = jscene.shape
    js.throughput = lambda params, r_o, r_d, key=None: JSDF.throughput(
        js, params, r_o, r_d, key=None)


# ---- the scene and its parameters --------------------------------------------------

@pytest.mark.parametrize("stable_init", [False, True])
def test_colocate_scene_loads_the_jax_params_strictly(stable_init):
    jscene = jcolocate.build_scene(stable_init=stable_init, light_scale=1.5)
    tree = jax.tree.map(np.asarray, jscene.init(jax.random.PRNGKey(0)))
    scene = load_jax_params(colocate.build_scene(stable_init=stable_init, light_scale=1.5),
                            tree, device="cpu")
    conductor = scene.bsdf.bsdfs[3]
    assert isinstance(conductor, Conductor) and isinstance(scene.bsdf.bsdfs[2], Diffuse)
    assert conductor.k.item() == float(tree["bsdf"]["bsdfs"][3]["k"]) == 1.0
    assert scene.lights.scale.item() == 1.5 and scene.occ.in_size == 5
    assert scene.bsdf.sp_var_fn.zero_out == stable_init
    assert (scene.shape.max_steps, scene.shape.throughput_steps, scene.shape.dist) == (64, 128, 2.2)
    spec = TT.make_optimizer(LRS)
    groups = {g["name"]: g["params"] for g in spec.init(scene).param_groups}
    assert set(groups) == {"shape", "bsdf", "lights", "occ"}
    assert any(p is conductor.k for p in groups["bsdf"])      # AdamW carries k
    assert sum(p.numel() for g in groups.values() for p in g) == sum(
        np.asarray(v).size for v in jax.tree.leaves(tree)) - sum(
        np.asarray(v).size for k, v in _flat(tree).items() if k.endswith(".B"))
    del tree["bsdf"]["bsdfs"][3]["k"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(colocate.build_scene(), tree, device="cpu")
    # the test scene shares the parameters: hard shadows, 128 steps
    test = colocate.eval_scene(scene)
    assert test.occlusion == "hard" and test.shape.max_steps == 128
    assert test.shape.centers is scene.shape.centers


# ---- one reduced training step -------------------------------------------------------

def _jax_loss_and_grads(jscene, tree, jcam, exp, mask):
    """The JAX step's loss_fn (training/loop.py:83-111) with the colocate
    extra loss, no key."""
    from neural_raytracing_tpu.integrators import NeRFIntegrator
    from neural_raytracing_tpu.ops.losses import masked_loss
    from neural_raytracing_tpu.render import _tile_positions as jpos

    def loss_fn(params):
        rays = jcam.sample_positions(jpos(*map(float, UV), CROP), size=SIZE)
        values, _, it = NeRFIntegrator(JDirect(training=True)).sample(
            jscene, params, rays, training=True)
        got = jnp.mean(values, axis=-2)
        loss = masked_loss(got[..., :3], exp, jnp.mean(it.throughput, -1), mask,
                           mask_weight=15.0)
        return loss + _jax_extra_loss(it, got, exp, mask)

    return jax.jit(jax.value_and_grad(loss_fn))(tree)


@functools.lru_cache(maxsize=None)
def _step_case():
    """Two steps on both sides, each after the colocated light_update (the
    location goes from the init's [1, 3] to [2, 3] before the first)."""
    jscene, tree, scene = colocate_pair(max_steps=16)
    _keyless(jscene)
    _, jcam, locs = _cameras()
    img, mask = _gt()
    exp = img[:, UV[0]:UV[0] + CROP, UV[1]:UV[1] + CROP]
    msk = mask[:, UV[0]:UV[0] + CROP, UV[1]:UV[1] + CROP]
    jopt = JT.make_optimizer(LRS)
    jstep = JT.make_train_step(jscene, JDirect(training=True), jopt, donate=False,
                               size=SIZE, crop_size=CROP, extra_loss=_jax_extra_loss)
    params = dict(tree, lights=dict(tree["lights"], location=locs.astype(np.float32)))
    params = jax.tree.map(jnp.asarray, params)
    jstate = JT.TrainState(params, jopt.init(params), jnp.int32(0))
    args = (jcam, tuple(map(jnp.float32, UV)), jnp.asarray(exp), jnp.asarray(msk),
            jax.random.PRNGKey(0))
    jstate, jaux1 = jstep(jstate, *args)
    # the light update overwrites the location AdamW moved
    params = dict(jstate.params, lights=dict(jstate.params["lights"],
                                             location=jnp.asarray(locs, jnp.float32)))
    jloss, jgrads = _jax_loss_and_grads(jscene, params, jcam, jnp.asarray(exp),
                                        jnp.asarray(msk))
    jnew, jaux2 = jstep(jstate._replace(params=params), *args)
    np.testing.assert_allclose(float(jloss), float(jaux2["loss"]), rtol=1e-6)
    return (scene, exp, msk, float(jaux1["loss"]), float(jloss), _flat(jgrads),
            _flat(params), _flat(jnew.params))


def test_colocate_training_step_matches_jax():
    scene, exp, msk, jloss1, jloss2, want_g, before2, want_p = _step_case()
    cam, _, locs = _cameras()
    light_update = colocate.make_light_update(locs / 1.05)
    spec = TT.make_optimizer(LRS)
    state = TT.TrainState(scene, spec.init(scene), 0)
    step = TT.build_step_fn(scene, Direct(training=True), spec, size=SIZE,
                            crop_size=CROP, extra_loss=colocate.extra_loss)
    batch = (UV, torch.from_numpy(exp), torch.from_numpy(msk))
    light_update(scene, cam, [0, 1])
    assert scene.lights.location.shape == (2, 3)
    state, aux1 = step(state, cam, *batch)
    np.testing.assert_allclose(aux1["loss"].item(), jloss1, rtol=1e-5)
    light_update(scene, cam, [0, 1])
    old = {k: p.detach().clone() for k, p in scene.named_parameters()}
    np.testing.assert_allclose(old["lights.location"].numpy(), before2["lights.location"],
                               rtol=1e-6)
    state, aux2 = step(state, cam, *batch)
    assert state.step == 2
    np.testing.assert_allclose(aux2["loss"].item(), jloss2, rtol=1e-5)
    for k, p in scene.named_parameters():
        g, wg = p.grad.numpy(), want_g[k]
        assert np.isfinite(g).all(), k
        scale = np.abs(wg).max()
        rel = 1e-3 if k == "lights.intensity" else 1e-4
        np.testing.assert_allclose(g, wg, rtol=0, atol=rel * scale + 1e-12, err_msg=k)
        lr = LRS[k.split(".")[0]]
        upd, wupd = (p.detach() - old[k]).numpy(), want_p[k] - before2[k]
        sure = np.abs(wg) > 1e-3 * scale
        ulp = np.spacing(np.abs(before2[k]).max())
        np.testing.assert_allclose(upd[sure], wupd[sure], rtol=0, atol=1e-3 * lr + 2 * ulp,
                                   err_msg=k)
    # every part learns, the Diffuse and Conductor leaves included; the
    # Conductor's k only through AdamW (a zero gradient).  A light at 1.05 x
    # the camera centre blocks no shadow ray of these views, so the
    # occlusion net's gradient is zero in both packages (test_torch_nerv
    # holds it where rays are blocked)
    for k in ("bsdf.bsdfs.2.reflectance", "bsdf.bsdfs.3.specular", "bsdf.bsdfs.3.eta",
              "bsdf.sp_var_fn.init.w", "lights.location", "shape.centers"):
        assert np.abs(want_g[k]).max() > 0 and scene.get_parameter(k).grad.abs().max() > 0, k
    assert want_g["bsdf.bsdfs.3.k"] == 0.0 == scene.bsdf.bsdfs[3].k.grad.item()


def test_adamw_decays_the_conductors_k_as_optax():
    """No gradient reaches k, yet optax's AdamW decays it; the step hands
    torch's AdamW a zero gradient, so it decays k the same way."""
    _, tree, scene = colocate_pair(max_steps=8)
    cam, _, locs = _cameras()
    img, mask = _gt()
    spec = TT.make_optimizer(LRS, weight_decay=0.1)
    step = TT.build_step_fn(scene, Direct(training=True), spec, size=SIZE, crop_size=CROP,
                            extra_loss=colocate.extra_loss)
    colocate.make_light_update(locs / 1.05)(scene, cam, [0, 1])
    step(TT.TrainState(scene, spec.init(scene), 0), cam, UV,
         torch.from_numpy(img[:, 2:2 + CROP, 2:2 + CROP]),
         torch.from_numpy(mask[:, 2:2 + CROP, 2:2 + CROP]))
    k = {"bsdf": {"k": jnp.float32(tree["bsdf"]["bsdfs"][3]["k"])}}
    jopt = JT.make_optimizer(LRS, weight_decay=0.1)
    upd, _ = jopt.update(jax.tree.map(jnp.zeros_like, k), jopt.init(k), k)
    want = float(k["bsdf"]["k"] + upd["bsdf"]["k"])
    assert want != float(k["bsdf"]["k"])
    np.testing.assert_allclose(scene.bsdf.bsdfs[3].k.item(), want, rtol=1e-6)


# ---- the hard-shadow eval render ----------------------------------------------------

def test_hard_shadow_eval_render_matches_jax():
    jscene, tree, _ = colocate_pair(max_steps=128, occlusion="hard")
    cam, jcam, locs = _cameras()
    wants = []
    for i in range(len(VIEWS)):
        p = dict(tree, lights=dict(tree["lights"], location=jnp.asarray(locs[i:i + 1])))
        img, _ = J.pathtrace(jscene, p, JFoV(R=jcam.R[i:i + 1], T=jcam.T[i:i + 1]),
                             JDirect(training=False), size=SIZE, chunk_size=8,
                             bundle_size=1, background=0.0, key=None)
        wants.append(np.clip(np.asarray(img), 0, 1))
    # the training scene (learned occlusion, 16 steps) with its last step's
    # [V, 3] lights; eval_scene takes hard shadows and 128 steps
    train_scene = load_jax_params(colocate_scene("torch"), tree, device="cpu")
    train_scene.lights.set_location(locs)
    got = []
    out = TT.evaluate(colocate.eval_scene(train_scene),
                      lambda i: FoVPerspectiveCamera(R=cam.R[i:i + 1], T=cam.T[i:i + 1]),
                      np.stack(wants), Direct(training=False), size=SIZE, chunk_size=8,
                      key=None, light_update=lambda sc, c, i: colocate.make_light_update(
                          locs / 1.05)(sc, c, [i]),
                      save_fn=lambda i, im: got.append(im), log_fn=lambda s: None)
    assert train_scene.lights.location.shape == (2, 3)    # restored
    np.testing.assert_allclose(train_scene.lights.location.detach().numpy(), locs)
    assert out["psnr"] > 60                                 # the JAX renders are the GT
    for g, w in zip(got, wants):
        mask, jmask = np.abs(g).sum(-1) > 0, np.abs(w).sum(-1) > 0
        assert 0 < jmask.mean() < 1 and (mask == jmask).mean() >= 0.99
        both = mask & jmask
        np.testing.assert_allclose(g[both], w[both], atol=1e-4, rtol=0)


# ---- the twins end to end --------------------------------------------------------------

@pytest.fixture(scope="module")
def colocate_run(tmp_path_factory):
    """make_dataset's main on a 2 x 2 grid at 12x12 (SSIM's window is 11),
    two relight views, then colocate's main for 2 steps with the relight
    test."""
    root = tmp_path_factory.mktemp("colocate")
    data = root / "data"
    grid, relight = make_dataset.main(["--out", str(data), "--kind", "bunny", "--size", "12",
                                       "--n-elev", "2", "--n-azim", "2", "--device", "cpu"])
    from PIL import Image
    scene = make_dataset.build_scene("bunny", 1.5).init(
        torch.Generator().manual_seed(make_dataset.SEED), device="cpu")
    for k, l in ((0, 0), (2, 1)):
        rgba = make_dataset.render_view(scene, make_dataset.CAM_ELEVS[1],
                                        make_dataset.CAM_AZIMS[2],
                                        make_dataset.relight_light(k, l), size=12,
                                        device="cpu")
        Image.fromarray(make_dataset.quantise(rgba), "RGBA").save(
            data / f"gt_bunny_1_2_{k}_{l}.png")
    state, results = colocate.main([
        "--data", str(data), "--kind", "bunny", "--size", "12", "--n-elev", "2",
        "--n-azim", "2", "--iters", "2", "--crop-size", "12", "--n-views", "2",
        "--stable-init", "--light-scale", "1.5", "--clip-norm", "10", "--log-every", "1",
        "--relight-data", str(data), "--device", "cpu", "--outputs", str(root / "out"),
        "--models", str(root / "models")])
    return root, grid, relight, state, results


def test_make_dataset_main_writes_the_grid(colocate_run):
    root, grid, relight, _, _ = colocate_run
    assert sorted(grid) == [(0, 0), (0, 1), (1, 0), (1, 1)] and relight == {}
    data = TT.load_colocate(str(root / "data"), "bunny", 12, n_elev=2, n_azim=2)
    mem = make_dataset.as_dataset(grid, 2, 2)
    for name in ("images", "masks", "elevs", "azims"):
        np.testing.assert_array_equal(getattr(mem, name), getattr(data, name), err_msg=name)
    assert 0.1 < data.masks.mean() < 0.9 and data.images.max() > 0.05


def test_colocate_main_runs_on_the_cpu(colocate_run, capsys):
    root, _, _, state, results = colocate_run
    assert state.step == 2 and np.isfinite(results["losses"]).all()
    assert state.scene.lights.location.shape == (2, 3)         # the last step's lights
    assert all(np.isfinite(v) for v in results["test"].values())
    assert results["test_images"].shape == (4, 12, 12, 3)
    assert len(results["relight_psnrs"]) == 2 and np.isfinite(results["relight_psnrs"]).all()
    assert (root / "models" / "colocate_bunny" / "occ.msgpack").exists()
    assert (root / "out" / "colocate_bunny_test_03.png").exists()
    assert (root / "out" / "relight_bunny_1_2_2_1.png").exists()


def test_render_colocate_workload_on_the_cpu(colocate_run, capsys):
    root = colocate_run[0]
    frames = render.main(["--workload", "colocate", "--models",
                          str(root / "models" / "colocate_bunny"), "--size", "8",
                          "--frames", "2", "--max-steps", "16", "--device", "cpu",
                          "--outputs", str(root / "orbit")])
    assert frames.shape == (2, 8, 8, 3) and np.isfinite(frames).all()
    assert (root / "orbit" / "orbit_colocate_001.png").exists()
    assert "frame 2/2" in capsys.readouterr().out
