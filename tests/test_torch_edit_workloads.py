"""Port parity: the scene-editing and test-split entry points —
``workloads.edit_nerf`` (``scripts/test_nerf.py``), ``workloads.edit_dtu``
(``scripts/edit_dtu.py``) and ``workloads.eval_nerv``
(``scripts/test_nerv.py``) — against the same flows written with the JAX
API, at 16x16 on the CPU.

``edit_nerf.run`` loads the reduced flagship of ``test_torch_params``
(saved with ``save_scene``; the twin's ``build_scene`` is swapped for the
reduced one) and evaluates a 2-view test split under each ``--edit``; the
JAX flow edits the JAX scene as ``test_nerf.py:46-63`` does and runs its
``evaluate``, the camera jitter replayed from its view and tile keys.
``edit_dtu.run`` does the same with the reduced DTU scene of
``test_torch_dtu_workload`` (48 march steps) on 2 generator views (no
jitter: the DTU camera ignores it), Direct and Debug, under bend, disp and
``--recolor 0``.  ``eval_nerv.run`` renders the trained NeRV checkpoint at
full width (16 march steps, hard shadows) on 2 frames of 2 lights each,
with weights, at 12x12 (the smallest size SSIM's window takes), against
``test_nerv.py``'s loop.

Tolerances: the renders as ``test_torch_path``'s integrators (pixel masks
equal on >= 99% of the pixels, values within 1e-4 of the largest where both
are lit, on all but 1%), the metrics' PSNRs within 0.05 dB and L1s within
1e-4, the SSIM within 1e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_raytracing_tpu as J
import neural_raytracing_tpu.training as JT
from neural_raytracing_tpu import edits as jedits
from neural_raytracing_tpu.bsdf import ComposeSpatialVarying as JCompose
from neural_raytracing_tpu.bsdf import Diffuse as JDiffuse
from neural_raytracing_tpu.cameras import DTUCamera as JDTUCamera
from neural_raytracing_tpu.cameras import NeRFCamera as JNeRF
from neural_raytracing_tpu.integrators import Debug as JDebug
from neural_raytracing_tpu.integrators import Direct as JDirect
from neural_raytracing_tpu.ops.ssim import ssim as jssim
from neural_raytracing_tpu.shapes import SDF as JSDF
from neural_raytracing_tpu_torch.params import load_jax_params
from neural_raytracing_tpu_torch.training import NeRFDataset, NeRVDataset, save_scene
from neural_raytracing_tpu_torch.workloads import (
    dtu, edit_dtu, edit_nerf, eval_nerv, nerf_synthetic,
)
from test_torch_bsdf_sampling import replay, uniform  # noqa: F401  (replay: a fixture)
from test_torch_dtu_workload import _split as dtu_split
from test_torch_dtu_workload import dtu_scene
from test_torch_nerv import ARTIFACTS, _jax_nerv_scene
from test_torch_occlusion import C2W, FOCAL
from test_torch_params import build_scene, scene_params
from test_torch_path import _compare

torch.set_num_threads(1)
SIZE = 16


def _images(seed, n=2, size=SIZE):
    return np.random.default_rng(seed).uniform(0, 0.5, size=(n, size, size, 3)).astype(
        np.float32)


def _jitter(key, views, bundle, size=SIZE):
    """The camera jitter of a one-tile render of each view: ``key(i)`` is the
    view's key; the tile's is ``fold_in(key, 0)``, split for the camera."""
    out = []
    for i in range(views):
        ckey, _ = jax.random.split(jax.random.fold_in(key(i), 0))
        out.append(uniform(ckey, (size, size, bundle, 2)))
    return out


def _lit(img):
    return np.abs(img).sum(-1) > 0


def _close_images(got, want, what):
    _compare(got, _lit(got), want, _lit(want), what)


# ---- edit_nerf -----------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _flagship_tree():
    return scene_params(build_scene("jax"))


def _nerf_test():
    return NeRFDataset(C2W.astype(np.float32), float(FOCAL), _images(1),
                       np.ones((2, SIZE, SIZE), np.float32))


@functools.lru_cache(maxsize=None)
def _jax_edit_nerf(edit, max_steps):
    """``scripts/test_nerf.py``'s flow on the reduced JAX flagship."""
    jscene = build_scene("jax", max_steps=max_steps)
    sdf = jscene.shape
    if edit == "bend":
        sdf = sdf.with_warp(jedits.bend(k=2.5))
    elif edit == "trans":
        sdf = sdf.with_warp(jedits.translate_above(a=0.1))
    elif edit == "scale_z":
        sdf = sdf.with_warp(jedits.scale_axis(s=0.2))
    elif edit in ("hole", "disp"):
        fn = jedits.add_hole if edit == "hole" else jedits.displace
        sdf = JSDF(jedits.EditedModule(sdf.module, fn), epsilon=sdf.epsilon,
                   max_steps=sdf.max_steps, dist=sdf.dist, throughput_steps=sdf.throughput_steps)
    jscene = jscene.replace(shape=sdf)
    test = _nerf_test()
    images = []
    out = JT.evaluate(
        jscene, jax.tree.map(jnp.asarray, _flagship_tree()),
        lambda i: JNeRF(cam_to_world=jnp.asarray(test.cam_to_worlds[i:i + 1]),
                        focal=test.focal),
        test.images, JDirect(training=False), size=SIZE, chunk_size=SIZE,
        save_fn=lambda i, im: images.append(np.asarray(im)), log_fn=lambda s: None)
    return out, np.stack(images)


@pytest.fixture(scope="module")
def flagship_models(tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    scene = load_jax_params(build_scene("torch"), _flagship_tree(), device="cpu")
    save_scene(str(root / "reduced"), scene)
    return root


@pytest.mark.parametrize("edit", edit_nerf.EDITS)
def test_edit_nerf_matches_the_jax_flow(edit, flagship_models, monkeypatch, replay):
    want, want_images = _jax_edit_nerf(edit, 48)
    monkeypatch.setattr(nerf_synthetic, "build_scene",
                        lambda max_steps: build_scene("torch", max_steps=max_steps))
    args = edit_nerf.parser().parse_args([
        "--data", "(in memory)", "--size", str(SIZE), "--edit", edit, "--test-max-steps",
        "48", "--models", str(flagship_models), "--device", "cpu"])
    replay(_jitter(lambda i: jax.random.fold_in(jax.random.PRNGKey(0), i), 2, 1))
    got = edit_nerf.run(args, _nerf_test(), "reduced", save=False)
    _close_images(got["images"], want_images, edit)
    np.testing.assert_allclose(got["psnr"], want["psnr"], atol=0.05)
    np.testing.assert_allclose(got["l1"], want["l1"], atol=1e-4)


def test_edit_nerf_scenes_share_the_loaded_parameters(flagship_models, monkeypatch):
    monkeypatch.setattr(nerf_synthetic, "build_scene",
                        lambda max_steps: build_scene("torch", max_steps=max_steps))
    bent, holed = (edit_nerf.edited_scene(edit_nerf.parser().parse_args([
        "--data", "x", "--models", str(flagship_models), "--device", "cpu", "--edit", edit]),
        "reduced") for edit in ("bend", "hole"))
    assert bent.shape.warp is not None and bent.shape.max_steps == 256
    assert holed.shape.warp is None and holed.shape.march_bound is None
    assert dict(holed.state_dict()).keys() == dict(bent.state_dict()).keys()
    for k, v in bent.state_dict().items():
        assert torch.equal(v, holed.state_dict()[k]), k


# ---- edit_dtu ------------------------------------------------------------------------

DTU_STEPS = 48


def _dtu_scene(lib):
    scene = dtu_scene(lib)
    if lib == "jax":
        scene.shape = JSDF(scene.shape.module, max_steps=DTU_STEPS, throughput_steps=16,
                           dist=2.2)
    else:
        scene.shape = scene.shape.replace(max_steps=DTU_STEPS)
    return scene


@functools.lru_cache(maxsize=None)
def _dtu_tree():
    return scene_params(dtu_scene("jax"))


@functools.lru_cache(maxsize=None)
def _jax_edit_dtu(edit, recolor):
    """``scripts/edit_dtu.py``'s flow on the reduced JAX DTU scene."""
    jscene = _dtu_scene("jax")
    params = jax.tree.map(jnp.asarray, _dtu_tree())
    data = dtu_split()
    src = np.asarray(data.src_size, np.float32)
    sdf = jscene.shape
    if edit == "bend":
        sdf = sdf.with_warp(jedits.bend(k=-10.0, axis=2))
    elif edit == "disp":
        sdf = JSDF(jedits.EditedModule(sdf.module, jedits.displace), epsilon=sdf.epsilon,
                   max_steps=sdf.max_steps, dist=sdf.dist, throughput_steps=sdf.throughput_steps)
    jscene = jscene.replace(shape=sdf)
    if recolor >= 0:
        bases, bparams = list(jscene.bsdf.bsdfs), list(params["bsdf"]["bsdfs"])
        flat = JDiffuse((1.0, 0.3, 0.1))
        bases[recolor], bparams[recolor] = flat, flat.init(jax.random.PRNGKey(0))
        jscene = jscene.replace(bsdf=JCompose(bases, sp_var_fn=jscene.bsdf.sp_var_fn))
        params = dict(params)
        params["bsdf"] = dict(params["bsdf"], bsdfs=tuple(bparams))
    out = {"render": [], "normals": []}
    for i in range(2):
        cam = JDTUCamera(pose=jnp.asarray(data.poses[i:i + 1]),
                         intrinsic=jnp.asarray(data.intrinsics[i:i + 1]), src_size=src)
        for integ, tag in ((JDirect(training=False), "render"), (JDebug(), "normals")):
            img, _ = J.pathtrace(jscene, params, cam, integ, size=SIZE, chunk_size=SIZE,
                                 background=0.0, key=jax.random.PRNGKey(i))
            out[tag].append(np.asarray(img))
    return {k: np.stack(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def dtu_models(tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    scene = load_jax_params(dtu_scene("torch"), _dtu_tree(), device="cpu")
    save_scene(str(root / "dtu_scan"), scene)
    return root


@pytest.mark.parametrize("edit,recolor", [("bend", -1), ("disp", -1), ("none", 0)])
def test_edit_dtu_matches_the_jax_flow(edit, recolor, dtu_models, monkeypatch):
    want = _jax_edit_dtu(edit, recolor)
    monkeypatch.setattr(dtu, "build_scene", lambda max_steps: _dtu_scene("torch"))
    args = edit_dtu.parser().parse_args([
        "--data", "(in memory)", "--size", str(SIZE), "--edit", edit, "--recolor",
        str(recolor), "--views", "2", "--models", str(dtu_models), "--device", "cpu"])
    got = edit_dtu.run(args, dtu_split(), "scan", save=False)
    for tag in ("render", "normals"):
        assert got[tag].shape == want[tag].shape == (2, SIZE, SIZE, 3)
        _close_images(got[tag], want[tag], f"{edit} {tag}")
    if recolor >= 0:
        # the swapped basis shows: the recoloured render differs from the plain one
        plain = _jax_edit_dtu("none", -1)["render"]
        assert np.abs(got["render"] - plain).max() > 1e-3
        scene = edit_dtu.edited_scene(args, "scan")
        assert scene.bsdf.bsdfs[0].reflectance.tolist() == pytest.approx([1.0, 0.3, 0.1])
        assert scene.bsdf.sp_var_fn.init.w.abs().sum() > 0


# ---- eval_nerv -----------------------------------------------------------------------

NERV_STEPS = 16
NV = 12                   # the smallest size SSIM's 11-pixel window takes
LIGHTS = np.asarray([[[0.2, 0.9, 0.6], [-0.7, 1.0, 0.9]],
                     [[0.9, 0.5, -0.3], [-0.2, 1.2, 0.4]]], np.float32)
WEIGHTS = np.asarray([[0.7, 0.3], [0.4, 0.6]], np.float32)


def _nerv_test(weights=WEIGHTS):
    return NeRVDataset(C2W.astype(np.float32), float(FOCAL * NV / SIZE), _images(2, size=NV),
                       np.ones((2, NV, NV), np.float32), LIGHTS, weights)


@functools.lru_cache(maxsize=None)
def _jax_eval_nerv():
    """``scripts/test_nerv.py``'s loop on the checkpoint (hard shadows)."""
    jscene = _jax_nerv_scene("hard", max_steps=NERV_STEPS)
    params = J.training.load_scene(ARTIFACTS, jax.tree.map(
        np.asarray, jscene.init(jax.random.PRNGKey(0))))
    test = _nerv_test()
    gots, exps, l1s, psnrs = [], [], [], []
    for i in range(2):
        cam = JNeRF(cam_to_world=jnp.asarray(test.cam_to_worlds[i:i + 1]), focal=test.focal)
        acc = None
        for loc, w in zip(test.light_locs[i], test.light_weights[i]):
            p = dict(params)
            p["lights"] = dict(p["lights"], location=jnp.asarray(loc[None]))
            img, _ = J.pathtrace(jscene, p, cam, JDirect(training=False), size=NV,
                                 chunk_size=NV, background=0.0, key=jax.random.PRNGKey(i))
            contrib = float(w) * np.asarray(img)[..., :3]
            acc = contrib if acc is None else acc + contrib
        got = np.clip(acc, 0, 1)
        exp = test.images[i]
        g, e = got / (1 + got), exp / (1 + exp)
        l1s.append(float(np.mean(np.abs(g - e))))
        psnrs.append(float(-10 * np.log10(np.mean((g - e) ** 2))))
        gots.append(g)
        exps.append(e)
    ssim = float(jssim(jnp.transpose(jnp.asarray(np.stack(gots)), (0, 3, 1, 2)),
                       jnp.transpose(jnp.asarray(np.stack(exps)), (0, 3, 1, 2))))
    return np.stack(gots), l1s, psnrs, ssim


def _nerv_args():
    return eval_nerv.parser().parse_args(["--data", "(in memory)", "--size", str(NV),
                                          "--device", "cpu"])


def _checkpoint_scene(args):
    scene = eval_nerv.build_test_scene(args, ARTIFACTS)
    scene.shape = scene.shape.replace(max_steps=NERV_STEPS)
    return scene


def test_eval_nerv_matches_the_jax_loop(replay):
    want, l1s, psnrs, ssim = _jax_eval_nerv()
    args = _nerv_args()
    scene = _checkpoint_scene(args)
    assert scene.occlusion == "hard" and scene.shape.march_bound == 1.2
    locs = scene.lights.location.detach().clone()
    # each frame renders once a light, both with the frame's key
    key = lambda i: jax.random.PRNGKey(i)
    draws = _jitter(key, 2, 4, NV)
    replay([d for d in draws for _ in range(2)])
    got = eval_nerv.run(args, _nerv_test(), scene, save=False)
    g = got["images"] / (1 + got["images"])
    _close_images(g, want, "eval_nerv")
    np.testing.assert_allclose(got["psnr"], psnrs, atol=0.05)
    np.testing.assert_allclose(got["l1"], l1s, atol=1e-4)
    assert abs(got["ssim"] - ssim) <= 1e-3
    assert torch.equal(scene.lights.location, locs)          # restored, [3, 3]


def test_eval_nerv_sums_the_single_light_renders(replay):
    """The weighted image is the weighted sum of the single-light renders
    (the same keys); without weights the lights count equally."""
    args = _nerv_args()
    scene = _checkpoint_scene(args)
    test = _nerv_test(weights=None)
    frame = eval_nerv.render_frame(scene, test, 1, 8, "cpu")
    singles = [eval_nerv.render_frame(scene, test._replace(light_locs=test.light_locs[:, j]),
                                      1, 8, "cpu") for j in range(2)]
    torch.testing.assert_close(frame, 0.5 * singles[0] + 0.5 * singles[1], rtol=1e-6,
                               atol=1e-7)
    assert (singles[0] - singles[1]).abs().max() > 1e-3       # the lights differ
    locs, w = eval_nerv.frame_lights(_nerv_test(), 0)
    assert locs.shape == (2, 3) and w.tolist() == pytest.approx([0.7, 0.3])
