"""Port parity: the entry points of Monte Carlo transport —
``workloads.render --integrator``, ``workloads.nerv --train-integrator
path`` and ``workloads.path_nerv``.

``render.main --workload nerv`` renders the trained NeRV checkpoint at full
width with each integrator at 8x8 on the CPU.  ``nerv.run
--train-integrator path`` takes one step on the reduced, creased NeRV scene
of ``test_torch_path`` (loaded with ``--load`` from the JAX params, one
12x12 view, so the host path's view and crop are fixed) against the JAX
training step (``build_step_fn``, ``grad_capture``: the gradients read from
its state) at the same view, crop and light, the port's uniforms replayed
from the JAX step's key; the port's gradients are read from AdamW's first
moment after the step (``(1 - b1) g`` exactly).  ``path_nerv.run`` renders
a 16x16 in-memory split of 2 views, 2 passes each, against the loop of
``scripts/path_nerv.py`` (``pathtrace`` of the JAX ``Path`` at
``PRNGKey(1000 i + s)``) on the same params, the camera jitter and the
integrator's uniforms replayed from each pass's tile key.

Tolerances: the step's loss rtol 1e-5 and each component's gradient within
1e-4 relative L2 (float32 sums in another order through two bounces, the
normals' double backward and SSIM; the readings: the loss 8e-8 apart, the
gradients within 2.6e-6); the relit images as
``test_torch_path``'s integrators (the hit flags equal on >= 99% of the
pixels, values within 1e-4 of the largest where both hit on all but 1%;
the reading: the same values), the PSNRs within 0.05 dB.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_raytracing_tpu as J
import neural_raytracing_tpu.integrators as JI
import neural_raytracing_tpu.training as JT
from neural_raytracing_tpu.cameras import NeRFCamera as JNeRF
from neural_raytracing_tpu.shapes import SDF as JSDF
from neural_raytracing_tpu_torch.training import NeRVDataset, save_scene
from neural_raytracing_tpu_torch.workloads import nerv, path_nerv, render
from test_torch_bsdf_sampling import replay, uniform  # noqa: F401  (replay: a fixture)
from test_torch_device_data import grad_capture
from test_torch_occlusion import C2W, FOCAL
from test_torch_path import _compare, _rel_l2, _scene_pair, path_draws

torch.set_num_threads(1)
ARTIFACTS = "scripts/models_seed_dir/nerv_mesh_gear_mirror200b"


@pytest.mark.parametrize("integrator", ["direct", "debug", "depth", "silhouette", "path"])
def test_render_integrators_on_the_cpu(integrator, tmp_path):
    frames = render.main(["--workload", "nerv", "--models", ARTIFACTS, "--size", "8",
                          "--frames", "1", "--integrator", integrator, "--device", "cpu",
                          "--outputs", str(tmp_path), "--dist", "2.0"])
    dims = 1 if integrator in ("depth", "silhouette") else 3
    assert frames.shape == (1, 8, 8, dims) and np.isfinite(frames).all()
    assert (tmp_path / "orbit_nerv_000.png").exists()
    if integrator == "debug":
        assert frames.min() >= 0.0 and frames.max() <= 1.0 and frames.max() > 0.0
    if integrator == "silhouette":
        assert set(np.unique(frames)) <= {0.0, 1.0}
    if integrator == "depth":      # scaled by the tile's largest depth, then the bundle's mean
        assert 0.9 < frames.max() <= 1.0
    if integrator in ("direct", "path"):
        assert frames.max() > 0.0


# ---- nerv --train-integrator path: one step against the JAX step ------------------------

SIZE = 12
LIGHT = np.asarray([[0.2, 0.9, 0.6]], np.float32)


def _split():
    """One 12x12 view of the creased surface (a soft disk as its ground truth)."""
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    disk = ((yy - 5.5) ** 2 + (xx - 6.0) ** 2 < 16).astype(np.float32)
    img = np.stack([0.3 * disk, 0.2 * disk, 0.1 * disk], -1)[None]
    c2w = C2W[:1].astype(np.float32)
    return NeRVDataset(c2w, float(FOCAL * SIZE / 16), img.astype(np.float32), disk[None],
                       LIGHT, None)


def _jax_step(jscene, tree, data, key):
    """The JAX training step (Path, tone mapping, SSIM, eikonal) at the view,
    crop and light the port's host path takes: its loss and gradients."""
    jopt = grad_capture()
    step = JT.build_step_fn(jscene, JI.Path(max_depth=2, training=True), jopt, size=SIZE,
                            crop_size=SIZE, tone_mapping=True, with_ssim=True)
    params = jax.tree.map(jnp.asarray, tree)
    params["lights"] = dict(params["lights"], location=jnp.asarray(data.light_locs[:1]))
    state = JT.TrainState(params, jopt.init(params), jnp.int32(0))
    cam = JNeRF(cam_to_world=jnp.asarray(data.cam_to_worlds[:1]), focal=data.focal)
    new, aux = jax.jit(step)(state, cam, (0.0, 0.0), jnp.asarray(data.images),
                             jnp.asarray(data.masks), key)
    return float(aux["loss"]), new.opt_state


def test_nerv_run_path_step_matches_jax(tmp_path, monkeypatch, replay):
    jscene, tree, scene = _scene_pair()
    save_scene(str(tmp_path / "nerv_creased"), scene)
    monkeypatch.setattr(nerv, "build_scene", lambda **kw: _scene_pair()[2])
    data = _split()
    key = jax.random.PRNGKey(31)
    jloss, jgrads = _jax_step(jscene, tree, data, key)
    _, ikey = jax.random.split(key)                 # the step's camera and integrator keys
    replay(path_draws(jscene, ikey, (1, SIZE, SIZE, 1), 2, training=True))
    args = nerv.parser().parse_args([
        "--data", "(in memory)", "--size", str(SIZE), "--crop-size", str(SIZE),
        "--n-views", "1", "--iters", "1", "--load", "--models", str(tmp_path),
        "--train-integrator", "path", "--device", "cpu", "--log-every", "0"])
    state, results = nerv.run(args, data, name="creased", save=False)
    np.testing.assert_allclose(results["losses"][0], jloss, rtol=1e-5)
    opt = state.optimizer
    b1 = opt.param_groups[0]["betas"][0]
    for p in state.scene.parameters():
        p.grad = opt.state[p]["exp_avg"] / (1.0 - b1)
    for c in ("shape", "bsdf", "lights"):
        assert _rel_l2(state.scene, jgrads, c) <= 1e-4, c


def test_nerv_run_path_on_the_device_data_path(tmp_path):
    args = nerv.parser().parse_args([
        "--data", "(in memory)", "--size", str(SIZE), "--crop-size", str(SIZE),
        "--n-views", "1", "--iters", "2", "--train-integrator", "path", "--device", "cpu",
        "--device-data", "--no-calibrate-exposure", "--log-every", "0", "--no-ssim",
        "--models", str(tmp_path)])
    original = nerv.build_scene
    nerv.build_scene = lambda **kw: _scene_pair()[2]
    try:
        state, results = nerv.run(args, _split(), save=False)
    finally:
        nerv.build_scene = original
    assert len(results["losses"]) == 2 and np.isfinite(results["losses"]).all()
    assert state.step == 2


# ---- path_nerv: the relit test views against the JAX script's loop ----------------------

def _test_split():
    rng = np.random.default_rng(3)
    c2w = np.stack([C2W[0], C2W[1]]).astype(np.float32)
    images = rng.uniform(0.0, 0.3, size=(2, 16, 16, 3)).astype(np.float32)
    locs = np.asarray([[0.2, 0.9, 0.6], [-0.7, 1.0, 0.9]], np.float32)
    return NeRVDataset(c2w, float(FOCAL), images, np.ones((2, 16, 16), np.float32), locs, None)


def _eval_pair():
    """The creased scene as ``path_nerv`` evaluates it: 128 steps, bounded
    by 1.2, hard shadows."""
    jscene, tree, scene = _scene_pair()
    jscene.shape = JSDF(jscene.shape.module, max_steps=128, march_bound=1.2)
    scene.shape = scene.shape.replace(max_steps=128, march_bound=1.2)
    return jscene, tree, scene


@functools.lru_cache(maxsize=None)
def _jax_relit(samples):
    """scripts/path_nerv.py's loop on the JAX scene -> (images, draws)."""
    jscene, tree, _ = _eval_pair()
    test = _test_split()
    images, draws = [], []
    for i in range(len(test.images)):
        params = jax.tree.map(jnp.asarray, tree)
        params["lights"] = dict(params["lights"], location=jnp.asarray(test.light_locs[i:i + 1]))
        cam = JNeRF(cam_to_world=jnp.asarray(test.cam_to_worlds[i:i + 1]), focal=test.focal)
        acc = None
        for s in range(samples):
            key = jax.random.PRNGKey(1000 * i + s)
            img, _ = J.pathtrace(jscene, params, cam, JI.Path(max_depth=2), size=16,
                                 chunk_size=16, bundle_size=1, background=0.0, key=key)
            acc = img if acc is None else acc + img
            # one tile: its key, split for the camera's jitter and the integrator
            ckey, ikey = jax.random.split(jax.random.fold_in(key, 0))
            draws += [uniform(ckey, (16, 16, 1, 2))]
            draws += path_draws(jscene, ikey, (1, 16, 16, 1), 2)
        images.append(np.clip(np.asarray(acc) / samples, 0, 1)[..., :3])
    return np.stack(images), draws


def test_path_nerv_run_matches_the_jax_loop(tmp_path, replay):
    want, draws = _jax_relit(2)
    _, _, scene = _eval_pair()
    args = path_nerv.parser().parse_args([
        "--data", "(in memory)", "--size", "16", "--samples", "2", "--device", "cpu",
        "--out-json", str(tmp_path / "relit.json")])
    replay(draws)
    out = path_nerv.run(args, _test_split(), scene, save=False)
    assert out["images"].shape == want.shape == (2, 16, 16, 3)
    hit = lambda im: np.abs(im).sum(-1) > 0
    _compare(out["images"], hit(out["images"]), want, hit(want), "path_nerv")
    test = _test_split()
    psnr = [float(-10.0 * np.log10(np.mean((w - e) ** 2))) for w, e in zip(want, test.images)]
    np.testing.assert_allclose(out["psnr"], psnr, atol=0.05)
    # the scene's light is as it was, and the metrics went to the JSON file
    assert scene.lights.location.shape == (1, 3)
    assert (tmp_path / "relit.json").exists()


def test_path_nerv_main_parser_defaults():
    args = path_nerv.parser().parse_args(["--data", "nerv/armadillo"])
    assert (args.samples, args.max_depth, args.shadows, args.size) == (32, 2, "hard", 200)
    assert args.eval_march_bound == 1.2 and args.device == "cuda"
    scene = path_nerv.build_scene(args)
    assert scene.shape.max_steps == 128 and scene.shape.march_bound == 1.2
    assert scene.occlusion == "hard" and len(scene.bsdf.bsdfs) == 7
