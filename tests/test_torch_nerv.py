"""Port parity: the NeRV workload — per-view point lights, learned
occlusion, ``light_update``/``space_reg`` in ``train``, ``evaluate`` and
``calibrate_exposure``, ``load_nerv``, the trained checkpoint, and the
workload twin ``workloads.nerv``.

The step and the loop run the reduced NeRV scene of ``test_torch_occlusion``
on the 2-view analytic sphere of ``test_torch_training`` (16x16, crops
12x12), tone-mapped, with one light per view.  As in ``test_torch_train_step``
the JAX SDF's ``throughput`` is swapped for a keyless one.  The trained
checkpoint ``scripts/models_seed_dir/nerv_mesh_gear_mirror200b`` (step
25,000 of ``scripts/nerv.py``) is rendered at full width on an 8x8 crop of a
200x200 view in both shadow modes by both packages.

Tolerances: the loss rtol 1e-5; each gradient leaf within 1e-4 of its
max|JAX gradient| (float32 sums in another order through the march, the
min-scan, the shadow march and the eikonal double backward); AdamW updates
within 1e-3 of the learning rate plus two float32 spacings of the leaf's
largest value (the update is a difference of two rounded parameters) where
the JAX gradient is above 1e-3 of the leaf's max; the light intensity's gradient within 1e-3 of its max (the
intensity enters normalised, so its gradient is the projection of the
unit colour's gradient: a difference of nearly equal sums over the rays);
the calibration ratio rtol 1e-4; the checkpoint render
mask agreement >= 99% and max |difference| <= 1e-4 where both masks agree.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_raytracing_tpu as J
import neural_raytracing_tpu.training as JT
from neural_raytracing_tpu.bsdf import ComposeSpatialVarying as JCompose
from neural_raytracing_tpu.bsdf import NeuralBSDF as JNeuralBSDF
from neural_raytracing_tpu.cameras import NeRFCamera as JNeRF
from neural_raytracing_tpu.integrators import Direct as JDirect
from neural_raytracing_tpu.lights import PointLights as JPointLights
from neural_raytracing_tpu.shapes import SDF as JSDF
from neural_raytracing_tpu.shapes import SphereSDF as JSphereSDF
from neural_raytracing_tpu.training import calibrate as jcalibrate
from neural_raytracing_tpu.training.datasets import load_nerv as j_load_nerv
import neural_raytracing_tpu_torch as T
import neural_raytracing_tpu_torch.training as TT
from neural_raytracing_tpu_torch.cameras import NeRFCamera
from neural_raytracing_tpu_torch.integrators import Direct
from neural_raytracing_tpu_torch.render import _tile_positions
from neural_raytracing_tpu_torch.training import calibrate as tcalibrate
from neural_raytracing_tpu_torch.workloads import nerv
from test_torch_occlusion import nerv_pair
from test_torch_training import C2W, FOCAL, SIZE, _flat, _gt

torch.set_num_threads(1)
CROP, UV = 12, (0, 2)
LRS = {"shape": 4e-5, "bsdf": 4e-5, "lights": 4e-5, "occ": 4e-5}
LOCS = np.asarray([[0.2, 0.9, 0.6], [-0.7, 1.0, 0.9]], np.float32)
ARTIFACTS = "scripts/models_seed_dir/nerv_mesh_gear_mirror200b"


# ---- the training step -------------------------------------------------------------

def _keyless(jscene):
    js = jscene.shape
    js.throughput = lambda params, r_o, r_d, key=None: JSDF.throughput(
        js, params, r_o, r_d, key=None)


def _jax_loss_and_grads(jscene, tree, exp, mask):
    """The JAX step's loss_fn (training/loop.py:83-111), tone-mapped, no key."""
    from neural_raytracing_tpu.integrators import NeRFIntegrator
    from neural_raytracing_tpu.ops.losses import masked_loss
    from neural_raytracing_tpu.render import _tile_positions as jpos
    camera = JNeRF(cam_to_world=jnp.asarray(C2W), focal=FOCAL)

    def loss_fn(params):
        rays = camera.sample_positions(jpos(*map(float, UV), CROP), size=SIZE)
        values, _, it = NeRFIntegrator(JDirect(training=True)).sample(
            jscene, params, rays, training=True)
        got = jnp.mean(values, axis=-2)
        loss = masked_loss(got[..., :3], exp, jnp.mean(it.throughput, -1), mask,
                           mask_weight=15.0, tone_mapping=True)
        return loss + JT.default_extra_loss(it, got, exp, mask)

    return jax.jit(jax.value_and_grad(loss_fn))(tree)


@functools.lru_cache(maxsize=None)
def _step_case():
    """Two steps on both sides: the first with the scene's one light, the
    second after light_update gave each view its own (so AdamW's moments
    change shape between them)."""
    jscene, tree, scene = nerv_pair(max_steps=16, occlusion="learned")
    for s in (jscene.shape, scene.shape):
        s.throughput_steps = 16
    _keyless(jscene)
    img, mask = _gt()
    exp = img[:, UV[0]:UV[0] + CROP, UV[1]:UV[1] + CROP]
    msk = mask[:, UV[0]:UV[0] + CROP, UV[1]:UV[1] + CROP]
    jopt = JT.make_optimizer(LRS)
    jstep = JT.make_train_step(jscene, JDirect(training=True), jopt, donate=False,
                               size=SIZE, crop_size=CROP, tone_mapping=True)
    camera = JNeRF(cam_to_world=jnp.asarray(C2W), focal=FOCAL)
    jstate = JT.TrainState(tree, jopt.init(tree), jnp.int32(0))
    args = (camera, tuple(map(jnp.float32, UV)), jnp.asarray(exp), jnp.asarray(msk),
            jax.random.PRNGKey(0))
    jstate, jaux1 = jstep(jstate, *args)
    params = dict(jstate.params)
    params["lights"] = dict(params["lights"], location=jnp.asarray(LOCS))
    jloss, jgrads = _jax_loss_and_grads(jscene, params, jnp.asarray(exp), jnp.asarray(msk))
    jnew, jaux2 = jstep(jstate._replace(params=params), *args)
    np.testing.assert_allclose(float(jloss), float(jaux2["loss"]), rtol=1e-6)
    return (scene, exp, msk, float(jaux1["loss"]), float(jloss), _flat(jgrads),
            _flat(params), _flat(jnew.params))


def test_nerv_training_step_matches_jax():
    scene, exp, msk, jloss1, jloss2, want_g, before2, want_p = _step_case()
    spec = TT.make_optimizer(LRS)
    state = TT.TrainState(scene, spec.init(scene), 0)
    step = TT.build_step_fn(scene, Direct(training=True), spec, size=SIZE,
                            crop_size=CROP, tone_mapping=True)
    camera = NeRFCamera(torch.from_numpy(C2W), FOCAL)
    batch = (UV, torch.from_numpy(exp), torch.from_numpy(msk))
    state, aux1 = step(state, camera, *batch)
    np.testing.assert_allclose(aux1["loss"].item(), jloss1, rtol=1e-5)
    scene.lights.set_location(LOCS)                   # the port's light_update
    old = {k: p.detach().clone() for k, p in scene.named_parameters()}
    np.testing.assert_allclose(old["lights.location"].numpy(), before2["lights.location"])
    state, aux2 = step(state, camera, *batch)
    assert state.step == 2
    np.testing.assert_allclose(aux2["loss"].item(), jloss2, rtol=1e-5)
    assert state.optimizer.state[scene.lights.location]["exp_avg"].shape == (2, 3)
    for k, p in scene.named_parameters():
        g, wg = p.grad.numpy(), want_g[k]
        scale = np.abs(wg).max()
        rel = 1e-3 if k == "lights.intensity" else 1e-4
        np.testing.assert_allclose(g, wg, rtol=0, atol=rel * scale + 1e-12, err_msg=k)
        lr = LRS[k.split(".")[0]]
        upd, wupd = (p.detach() - old[k]).numpy(), want_p[k] - before2[k]
        sure = np.abs(wg) > 1e-3 * scale
        ulp = np.spacing(np.abs(before2[k]).max())     # the float32 parameter's
        np.testing.assert_allclose(upd[sure], wupd[sure], rtol=0, atol=1e-3 * lr + 2 * ulp,
                                   err_msg=k)
    # the learned occlusion, the light location and the shape all learn
    for k in ("occ.out.w", "occ.init.w", "lights.location", "shape.centers"):
        assert np.abs(want_g[k]).max() > 0 and scene.get_parameter(k).grad.abs().max() > 0


# ---- the loop ---------------------------------------------------------------------

def _loop_setup():
    img, mask = _gt()
    imgs, masks = np.concatenate([img, img[::-1]]), np.concatenate([mask, mask[::-1]])
    c2ws = np.concatenate([C2W, C2W[::-1]])
    locs = np.concatenate([LOCS, LOCS[::-1] + 0.1]).astype(np.float32)
    _, _, scene = nerv_pair(max_steps=16, occlusion="learned")
    scene.shape.throughput_steps = 16
    make_camera = lambda idxs: NeRFCamera(torch.from_numpy(c2ws[np.asarray(idxs)]), FOCAL)
    light_update = lambda sc, cam, idxs: sc.lights.set_location(locs[np.asarray(idxs)])
    return scene, imgs, masks, make_camera, light_update, locs


def test_train_evaluate_train_with_light_update():
    scene, imgs, masks, make_camera, light_update, locs = _loop_setup()
    spec = TT.make_optimizer(LRS)
    state = TT.init_train_state(scene, spec, device="cpu")
    occ0 = scene.occ.out.w.detach().clone()
    kw = dict(size=SIZE, crop_size=CROP, iters=2, n_views=2, log_every=0,
              tone_mapping=True, uv_select=TT.rand_uv_mask, light_update=light_update)
    state, losses = TT.train(scene, Direct(training=True), spec, state, make_camera,
                             imgs, masks, torch.Generator().manual_seed(0), **kw)
    assert state.step == 2 and np.isfinite(losses).all()
    assert scene.lights.location.shape == (2, 3)
    assert not torch.equal(scene.occ.out.w, occ0)
    before = {k: v.clone() for k, v in scene.state_dict().items()}
    out = TT.evaluate(scene, lambda i: make_camera([i]), imgs[:2], Direct(training=False),
                      size=SIZE, chunk_size=8, log_fn=lambda s: None,
                      light_update=lambda sc, cam, i: sc.lights.set_location(locs[i:i + 1]))
    assert all(np.isfinite(v) for v in out.values())
    for k, v in scene.state_dict().items():          # values and shapes restored
        assert torch.equal(before[k], v), k
    state, losses = TT.train(scene, Direct(training=True), spec, state, make_camera,
                             imgs, masks, torch.Generator().manual_seed(1), seed=1, **kw)
    assert state.step == 4 and np.isfinite(losses).all()


def test_space_reg_enters_the_loss():
    scene, imgs, masks, make_camera, light_update, _ = _loop_setup()
    spec = TT.make_optimizer(LRS)
    calls = []

    def space_reg(sc, generator):
        calls.append(generator)
        return 100.0 * sc.shape.radii.square().sum()

    losses = {}
    for reg in (None, space_reg):
        sc = nerv_pair(max_steps=16, occlusion="learned")[2]
        sc.shape.throughput_steps = 16
        step = TT.build_step_fn(sc, Direct(training=True), spec, size=SIZE,
                                crop_size=CROP, tone_mapping=True, space_reg=reg)
        want = 100.0 * sc.shape.radii.detach().square().sum().item()
        _, aux = step(TT.TrainState(sc, spec.init(sc), 0), make_camera([0, 1]), UV,
                      torch.from_numpy(imgs[:2, :CROP, 2:2 + CROP]),
                      torch.from_numpy(masks[:2, :CROP, 2:2 + CROP]))
        losses[reg is None] = (aux["loss"].item(), sc.shape.radii.grad.clone(), want)
    (plain, g0, _), (reg_loss, g1, want) = losses[True], losses[False]
    np.testing.assert_allclose(reg_loss - plain, want, rtol=1e-5)
    assert len(calls) == 1 and not torch.allclose(g0, g1)
    # and the workload's full-space regularizer differentiates the field twice
    reg = nerv.make_space_reg(1.0, 1.0, 100.0)(scene, torch.Generator().manual_seed(0))
    reg.backward()
    assert torch.isfinite(reg) and scene.shape.shift.out.w.grad.abs().max() > 0


def test_broadcast_state_follows_the_parameter():
    p = torch.nn.Parameter(torch.ones(1, 3))
    opt = torch.optim.AdamW([p], lr=1e-3, weight_decay=0.0)
    p.grad = torch.ones(1, 3)
    opt.step()
    m = opt.state[p]["exp_avg"].clone()
    p.data = torch.zeros(4, 3)
    TT.broadcast_state(opt)
    assert opt.state[p]["exp_avg"].shape == (4, 3)
    assert torch.equal(opt.state[p]["exp_avg"], m.expand(4, 3))
    p.data = torch.zeros(2, 2)
    with pytest.raises(RuntimeError):
        TT.broadcast_state(opt)


# ---- calibration and the loader ---------------------------------------------------

@pytest.mark.parametrize("case", ["calibrated", "empty_masks", "no_scale"])
def test_calibrate_exposure_matches_jax(case, monkeypatch):
    monkeypatch.setattr(jcalibrate, "pathtrace",
                        functools.partial(J.pathtrace, with_noise=False))
    jscene, tree, scene = nerv_pair(max_steps=16, occlusion="hard")
    img, mask = _gt()
    imgs, masks = np.concatenate([img, img]), np.concatenate([mask, mask])
    if case == "empty_masks":
        masks = 0 * masks
    c2ws = np.concatenate([C2W, C2W])
    if case == "no_scale":
        from test_torch_params import scene_pair
        jscene, tree, scene = scene_pair(max_steps=16)
    jlu = lambda params, cam, idxs: dict(params, lights=dict(
        params["lights"], location=jnp.asarray(LOCS[np.asarray(idxs) % 2])))
    jstate = JT.TrainState(tree, None, 0)
    jstate, jratio = jcalibrate.calibrate_exposure(
        jscene, jstate, lambda i: JNeRF(cam_to_world=jnp.asarray(c2ws[np.asarray(i)]),
                                        focal=FOCAL),
        imgs, masks, size=SIZE, chunk_size=8, log_fn=lambda s: None,
        light_update=None if case == "no_scale" else jlu)
    before = {k: v.clone() for k, v in scene.state_dict().items()}
    state, ratio = tcalibrate.calibrate_exposure(
        scene, "state", lambda i: NeRFCamera(torch.from_numpy(c2ws[np.asarray(i)]), FOCAL),
        imgs, masks, size=SIZE, chunk_size=8, key=None, log_fn=lambda s: None,
        light_update=None if case == "no_scale" else
        (lambda sc, cam, idxs: sc.lights.set_location(LOCS[np.asarray(idxs) % 2])))
    assert state == "state"
    np.testing.assert_allclose(ratio, jratio, rtol=1e-4)
    after = scene.state_dict()
    for k, v in before.items():
        if k == "lights.scale":
            np.testing.assert_allclose(after[k].numpy(), np.asarray(
                jstate.params["lights"]["scale"]), rtol=1e-4)
        else:
            assert torch.equal(after[k], v), k
    if case == "calibrated":
        assert ratio != 1.0
    else:
        assert ratio == 1.0


def _write_nerv(root, split, n, rgba=True, top_level=False, weights=False):
    from PIL import Image
    base = root if top_level else root / f"{split}_point"
    base.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(len(split) + n)
    frames = []
    for i in range(n):
        img = (rng.uniform(size=(20, 20, 4 if rgba else 3)) * 255).astype(np.uint8)
        if rgba:
            img[..., 3] = np.where(rng.uniform(size=(20, 20)) > 0.5, 255, 0)
        Image.fromarray(img).save(base / f"r_{i}.png")
        c2w = np.eye(4)
        c2w[:3, 3] = rng.normal(size=3) * 4.0            # not normalised
        frame = {"file_path": f"r_{i}", "transform_matrix": c2w.tolist(),
                 "light_loc": rng.normal(size=3).tolist()}
        if weights:
            frame["light_weights"] = rng.uniform(size=2).tolist()
        frames.append(frame)
    (base / f"transforms_{split}.json").write_text(
        json.dumps({"camera_angle_x": 0.69, "frames": frames}))


@pytest.mark.parametrize("layout", ["point_dir", "top_level_rgb"])
def test_load_nerv_matches_jax(tmp_path, layout):
    if layout == "point_dir":
        _write_nerv(tmp_path, "train", 3, weights=True)
        _write_nerv(tmp_path, "train", 2, top_level=True)   # the subdirectory wins
    else:
        _write_nerv(tmp_path, "train", 3, rgba=False, top_level=True)
    got = TT.load_nerv(str(tmp_path), 16, "train")
    want = j_load_nerv(str(tmp_path), 16, "train")
    assert len(got.images) == 3 and got.images.shape == (3, 16, 16, 3)
    for name in ("cam_to_worlds", "images", "masks", "light_locs", "light_weights"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.focal == want.focal
    assert np.abs(got.cam_to_worlds[:, :3, 3]).max() > 1.5
    if layout == "top_level_rgb":
        assert got.masks.min() == 1.0


# ---- the trained checkpoint -------------------------------------------------------

def _jax_nerv_scene(occlusion, max_steps=128, march_bound=1.2):
    """scripts/nerv.py's build_scene in the JAX package."""
    return J.Scene(
        shape=JSDF(JSphereSDF(n=128), max_steps=max_steps, throughput_steps=128, dist=2.2,
                   march_bound=march_bound),
        bsdf=JCompose([JNeuralBSDF(activation="softplus") for _ in range(7)]),
        lights=JPointLights(scale=100.0), occlusion=occlusion)


def test_trained_checkpoint_loads_into_the_port():
    scene = nerv.build_scene()
    TT.load_scene(ARTIFACTS, scene)                  # location [1, 3] -> [3, 3]
    tree = TT.checkpoint.load_pytree(f"{ARTIFACTS}/lights.msgpack")
    assert scene.lights.location.shape == (3, 3)
    np.testing.assert_array_equal(scene.lights.location.detach().numpy(), tree["location"])
    assert scene.lights.scale.item() == pytest.approx(0.22125, rel=1e-4)
    assert scene.occ.B.shape == (5, 16) and scene.occ.init.w.shape == (37, 64)
    # every other leaf stays strict
    for change in ("missing", "extra", "shape"):
        bad = {k: dict(v) if isinstance(v, dict) else v for k, v in tree.items()}
        if change == "missing":
            del bad["square"]
        elif change == "extra":
            bad["falloff"] = np.ones(3, np.float32)
        else:
            bad["intensity"] = np.ones((2, 3), np.float32)
        with pytest.raises(RuntimeError):
            TT.checkpoint.load_tree_into(nerv.build_scene().lights, bad)


@functools.lru_cache(maxsize=None)
def _checkpoint_render(occlusion):
    from neural_raytracing_tpu.render import _tile_positions as jpos
    jscene = _jax_nerv_scene(occlusion)
    params = J.training.load_scene(ARTIFACTS, jax.tree.map(
        np.asarray, jscene.init(jax.random.PRNGKey(0))))
    params["lights"] = dict(params["lights"], location=params["lights"]["location"][:1])
    c2w = np.asarray(T.cameras.nerf_c2w(30, 45, 2.0))[None, :3].astype(np.float32)
    focal = 0.5 * 200 / np.tan(0.5 * 0.6911)
    rays = JNeRF(cam_to_world=jnp.asarray(c2w), focal=focal).sample_positions(
        jpos(96.0, 60.0, 8), size=200)
    values, active, _ = JDirect(training=False).sample(jscene, params, rays)
    return c2w, focal, np.asarray(values), np.asarray(active)


@pytest.mark.parametrize("occlusion", ["learned", "hard"])
def test_trained_checkpoint_renders_as_in_jax(occlusion):
    c2w, focal, want, jactive = _checkpoint_render(occlusion)
    scene = nerv.eval_scene(nerv.build_scene(), occlusion, 1.2)
    TT.load_scene(ARTIFACTS, scene)
    scene.lights.set_location(scene.lights.location[:1].detach())
    rays = NeRFCamera(torch.from_numpy(c2w), focal).sample_positions(
        _tile_positions(96.0, 60.0, 8, "cpu"), size=200)
    with torch.no_grad():
        got, active, _ = Direct(training=False).sample(scene, rays)
    got, active = got.numpy(), active.numpy()
    assert 0 < jactive.mean() and (active == jactive).mean() >= 0.99
    both = active & jactive
    np.testing.assert_allclose(got[both], want[both], atol=1e-4, rtol=0)
    assert want[both].max() > 0


# ---- the workload twin ------------------------------------------------------------

def test_nerv_workload_main_runs_on_the_cpu(tmp_path, capsys):
    data = tmp_path / "tiny"
    _write_nerv(data, "train", 3)
    _write_nerv(data, "test", 2)
    state, results = nerv.main([
        "--data", str(data), "--size", "16", "--iters", "2", "--crop-size", "12",
        "--n-views", "2", "--device", "cpu", "--log-every", "1",
        "--outputs", str(tmp_path / "out"), "--models", str(tmp_path / "models")])
    assert state.step == 2 and set(results) == {"soft", "hard"}
    assert all(np.isfinite(v) for r in results.values() for v in r.values())
    assert (tmp_path / "models" / "nerv_tiny" / "occ.msgpack").exists()
    assert (tmp_path / "out" / "nerv_tiny_hard_001.png").exists()
    log = capsys.readouterr().out
    assert "exposure calibration" in log and "NeRV test with hard shadows" in log
