"""Port parity: the DTU workload twin ``workloads.dtu``, and the generator
twins driving the workload twins end to end on the CPU.

The strict load of ``scripts/dtu.py``'s scene; one reduced DTU step on the
on-device data path (the packed pose and intrinsic, mask weight 10) against
the JAX device step, the draws pinned to the JAX step's; then at 12^2 on the
CPU: ``make_dtu_dataset.main`` -> ``dtu.main`` (the host path and
``--device-data``) -> ``render.main --workload dtu``, and
``make_nerv_dataset.main`` -> ``nerv.main --device-data`` ->
``nerf_synthetic.main --skip-test`` on its ``train_point`` split ->
``render.main --workload nerf``.

The reduced DTU scene keeps the structure of ``scripts/dtu.py`` (SDF
(SphereSDF) + ComposeSpatialVarying over 6 NeuralBSDF(softplus) lobes +
LightField) at the narrow widths of ``test_torch_params``, 8 spheres;
the generator's cameras at 16x16 with the source size matched; analytic
ground truth of a sphere.  As in ``test_torch_train_step`` the JAX SDF's
``throughput`` is swapped for a keyless one.
Tolerances (as ``test_torch_device_data``, whose docstring gives the
readings they were set from): the loss rtol 1e-5, each component's
gradient within 8e-5 relative L2.
"""

import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import dtu as jdtu  # noqa: E402  (scripts/dtu.py)

import neural_raytracing_tpu as J  # noqa: E402
import neural_raytracing_tpu.training as JT  # noqa: E402
from neural_raytracing_tpu.bsdf import ComposeSpatialVarying as JCompose  # noqa: E402
from neural_raytracing_tpu.bsdf import NeuralBSDF as JNeuralBSDF  # noqa: E402
from neural_raytracing_tpu.cameras import DTUCamera as JDTUCamera  # noqa: E402
from neural_raytracing_tpu.integrators import Direct as JDirect  # noqa: E402
from neural_raytracing_tpu.kernels import FusedSkipConnMLP as JFused  # noqa: E402
from neural_raytracing_tpu.lights import LightField as JLightField  # noqa: E402
from neural_raytracing_tpu.shapes import SDF as JSDF  # noqa: E402
from neural_raytracing_tpu.shapes import SphereSDF as JSphereSDF  # noqa: E402
import neural_raytracing_tpu_torch as T  # noqa: E402
import neural_raytracing_tpu_torch.training as TT  # noqa: E402
from neural_raytracing_tpu_torch.bsdf import ComposeSpatialVarying, NeuralBSDF  # noqa: E402
from neural_raytracing_tpu_torch.integrators import Direct  # noqa: E402
from neural_raytracing_tpu_torch.kernels import FusedSkipConnMLP  # noqa: E402
from neural_raytracing_tpu_torch.lights import LightField  # noqa: E402
from neural_raytracing_tpu_torch.params import load_jax_params  # noqa: E402
from neural_raytracing_tpu_torch.render import _tile_positions  # noqa: E402
from neural_raytracing_tpu_torch.shapes import SDF, SphereSDF  # noqa: E402
from neural_raytracing_tpu_torch.workloads import (  # noqa: E402
    dtu, make_dtu_dataset, make_nerv_dataset, nerf_synthetic, nerv, render,
)
from test_torch_device_data import _jax_draws, _keyless, _rel_l2, grad_capture  # noqa: E402
from test_torch_params import NETS, scene_params  # noqa: E402
from test_torch_training import _flat  # noqa: E402

torch.set_num_threads(1)
SIZE, CROP, N_VIEWS = 16, 12, 2
LRS = {"shape": 8e-5, "bsdf": 8e-5, "lights": 8e-5}


# ---- the scene and its parameters --------------------------------------------------

def test_dtu_scene_loads_the_jax_params_strictly():
    # the JAX tree's structure and shapes, filled with seeded values
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(jdtu.build_scene().init, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(x.dtype), shapes)
    scene = load_jax_params(dtu.build_scene(), tree, device="cpu")
    assert len(scene.bsdf.bsdfs) == 6 and isinstance(scene.lights, LightField)
    assert (scene.shape.max_steps, scene.shape.throughput_steps, scene.shape.dist) == (64, 128, 2.2)
    assert scene.shape.march_bound is None
    del tree["lights"]["color"]
    with pytest.raises(RuntimeError, match="Missing key"):
        load_jax_params(dtu.build_scene(), tree, device="cpu")
    test = dtu.eval_scene(scene, 1.2)
    assert (test.shape.max_steps, test.shape.march_bound) == (128, 1.2)
    assert test.shape.centers is scene.shape.centers
    train_idx, test_idx = dtu.split(23, 10)
    np.testing.assert_array_equal(test_idx, [0, 10, 20])
    assert len(train_idx) == 20 and not set(train_idx) & set(test_idx)


# ---- one reduced step on the device data path, against the JAX device step -------------

def dtu_scene(lib):
    """The reduced DTU scene, built from the JAX package ("jax") or the port."""
    if lib == "jax":
        mlp, scene, sdf, sphere = JFused, J.Scene, JSDF, JSphereSDF
        compose, lobe, light = JCompose, JNeuralBSDF, JLightField
    else:
        mlp, scene, sdf, sphere = FusedSkipConnMLP, T.Scene, SDF, SphereSDF
        compose, lobe, light = ComposeSpatialVarying, NeuralBSDF, LightField
    return scene(
        shape=sdf(sphere(n=8, mlp=mlp(**NETS["shift"])), max_steps=16, throughput_steps=16,
                  dist=2.2),
        bsdf=compose([lobe(activation="softplus", mlp=mlp(**NETS["lobe"])) for _ in range(6)],
                     sp_var_fn=mlp(**dict(NETS["weight"], out=6))),
        lights=light(mlp=mlp(**NETS["light"])))


@functools.lru_cache(maxsize=None)
def _split():
    """4 generator views at 16x16 (source size matched) of a sphere of
    radius 0.3, shaded by its normal."""
    _, cams = make_dtu_dataset.scan_cameras(4, SIZE)
    blank = np.zeros((4, SIZE, SIZE, 3), np.float32)
    d = TT.dtu_dataset(cams, blank, blank[..., 0], SIZE, src_size=(SIZE, SIZE))
    cam = dtu.camera_maker(d)(range(4))
    rays = cam.sample_positions(_tile_positions(0.0, 0.0, SIZE, "cpu"), size=SIZE)
    r_o, r_d = rays[..., 0, :3].double().numpy(), rays[..., 0, 3:].double().numpy()
    b = np.sum(r_o * r_d, -1)
    disc = b * b - (np.sum(r_o * r_o, -1) - 0.3 ** 2)
    mask = (disc > 0).astype(np.float32)
    n = (r_o + (-b - np.sqrt(np.maximum(disc, 0)))[..., None] * r_d) / 0.3
    shade = np.clip(-np.sum(n * r_d, -1), 0, 1)
    img = (mask[..., None] * shade[..., None] * np.asarray([0.6, 0.4, 0.3])).astype(np.float32)
    return d._replace(images=img, masks=mask)


@functools.lru_cache(maxsize=None)
def _jax_case(seed):
    """The JAX device step from ``PRNGKey(seed)``: its draws, loss and
    gradients."""
    jscene = dtu_scene("jax")
    tree = scene_params(jscene)
    _keyless(jscene)
    d = _split()
    jdata = JT.device_dataset(d.images, d.masks, dtu.packed_cameras(d, np.arange(4)), CROP)
    src = jnp.asarray(d.src_size, jnp.float32)
    jopt = grad_capture()
    jdstep = JT.make_device_data_step(
        jscene, JDirect(training=True), jopt,
        lambda c: JDTUCamera(pose=c[:, 0], intrinsic=c[:, 1], src_size=src),
        n_views=N_VIEWS, size=SIZE, crop_size=CROP, mask_weight=10.0, donate=False)
    key = jax.random.PRNGKey(seed)
    jstate, jaux = jdstep(JT.TrainState(tree, jopt.init(tree), jnp.int32(0)), jdata, key)
    return (tree, _jax_draws(jdata, key, N_VIEWS, SIZE, CROP), float(jaux["loss"]),
            _flat(jstate.opt_state))


@pytest.mark.timeout(120)
def test_dtu_device_step_matches_jax_at_pinned_draws():
    tree, (idxs, u, w), jloss, jgrads = _jax_case(0)
    d = _split()
    assert 0 < d.masks[idxs, u:u + CROP, w:w + CROP].mean() < 1
    scene = load_jax_params(dtu_scene("torch"), tree, device="cpu")
    spec = TT.make_optimizer(LRS)
    data = TT.device_dataset(d.images, d.masks, dtu.packed_cameras(d, np.arange(4)), CROP,
                             device="cpu")
    dstep = TT.make_device_data_step(
        scene, Direct(training=True), spec, dtu.packed_camera_builder(d.src_size),
        n_views=N_VIEWS, size=SIZE, crop_size=CROP, mask_weight=10.0,
        draw=lambda data, gen: (torch.tensor(idxs), torch.tensor(u), torch.tensor(w)))
    state, aux = dstep(TT.TrainState(scene, spec.init(scene), 0), data, None)
    assert state.step == 1
    np.testing.assert_allclose(aux["loss"].item(), jloss, rtol=1e-5)
    alpha = aux["got"][..., 3]
    assert (alpha > 0.5).any() and (alpha < 0.5).any()
    for c in ("shape", "bsdf", "lights"):
        assert _rel_l2(scene, jgrads, c) <= 8e-5, c


# ---- the twins end to end -------------------------------------------------------------

@pytest.fixture(scope="module")
def dtu_run(tmp_path_factory):
    """make_dtu_dataset.main (4 views at 12x12), then dtu.main for 2 steps
    on the host path and 2 on the device path, each with its masked test."""
    root = tmp_path_factory.mktemp("dtu")
    data = root / "scan"
    make_dtu_dataset.main(["--out", str(data), "--views", "4", "--size", "12",
                           "--device", "cpu"])
    runs = {}
    for tag, extra in (("host", []), ("device", ["--device-data"])):
        runs[tag] = dtu.main([
            "--data", str(data), "--size", "12", "--iters", "2", "--crop-size", "12",
            "--n-views", "2", "--test-every", "2", "--log-every", "1", "--device", "cpu",
            "--outputs", str(root / f"out_{tag}"), "--models", str(root / f"models_{tag}"),
            *extra])
    return root, runs


@pytest.mark.timeout(120)
@pytest.mark.parametrize("path", ["host", "device"])
def test_dtu_main_runs_on_the_cpu(dtu_run, path):
    root, runs = dtu_run
    state, results = runs[path]
    assert state.step == 2 and len(results["losses"]) == 2
    assert np.isfinite(results["losses"]).all()
    assert all(np.isfinite(v) for v in results["test"].values())
    assert results["test_images"].shape == (2, 12, 12, 3)      # views 0 and 2
    assert (root / f"models_{path}" / "dtu_scan" / "shape.msgpack").exists()
    assert (root / f"out_{path}" / "dtu_scan_test_01.png").exists()
    lines = (root / f"out_{path}" / "metrics_dtu_scan.jsonl").read_text().splitlines()
    assert [json.loads(x)["step"] for x in lines] == [0, 1, 2]


@pytest.mark.timeout(120)
def test_render_dtu_workload_on_the_cpu(dtu_run, capsys):
    root = dtu_run[0]
    frames = render.main(["--workload", "dtu", "--models", str(root / "models_device" /
                                                                  "dtu_scan"),
                          "--size", "8", "--frames", "2", "--max-steps", "16",
                          "--device", "cpu", "--outputs", str(root / "orbit")])
    assert frames.shape == (2, 8, 8, 3) and np.isfinite(frames).all()
    assert (root / "orbit" / "orbit_dtu_001.png").exists()
    assert "frame 2/2" in capsys.readouterr().out


@pytest.fixture(scope="module")
def nerv_run(tmp_path_factory):
    """make_nerv_dataset.main (3 train and 2 test frames at 12x12), then
    nerv.main --device-data for 2 steps (no exposure calibration) with its
    test, then nerf_synthetic.main on the train split for 2 steps (a
    half-res warm-up step, the device path, mask-centred crops, a
    validation render each step)."""
    root = tmp_path_factory.mktemp("nerv")
    data = root / "armadillo"
    out = make_nerv_dataset.main(["--out", str(data), "--size", "12", "--train-views", "3",
                                  "--test-views", "2", "--device", "cpu"])
    nerv_res = nerv.main([
        "--data", str(data), "--size", "12", "--iters", "2", "--crop-size", "12",
        "--n-views", "2", "--device-data", "--no-calibrate-exposure", "--device", "cpu",
        "--log-every", "1", "--outputs", str(root / "out"), "--models", str(root / "models")])
    nerf_res = nerf_synthetic.main([
        "--data", str(data / "train_point"), "--size", "12", "--iters", "2",
        "--crop-size", "12", "--n-views", "2", "--skip-test", "--half-res-warmup", "1",
        "--device-data", "--mask-crops", "--valid-freq", "1", "--device", "cpu",
        "--outputs", str(root / "out"), "--models", str(root / "models")])
    return root, out, nerv_res, nerf_res


@pytest.mark.parametrize("frame", [0, 2])
def test_nerv_generator_render_matches_jax(frame):
    """A 16^2 frame of the NeRV generator twin with the JAX PRNGKey(7)
    weights against the JAX render (scripts/make_nerv_dataset.py's scene,
    camera and light), at the tolerances of the colocate generator's."""
    import make_dataset as jmake                     # scripts/make_dataset.py
    from neural_raytracing_tpu.bsdf import Diffuse as JDiffuse
    from neural_raytracing_tpu.cameras import NeRFCamera as JNeRF
    from neural_raytracing_tpu.integrators import Mask as JMask
    from neural_raytracing_tpu.lights import PointLights as JPointLights
    from neural_raytracing_tpu.nn import SkipConnMLP as JMLP
    jscene = J.Scene(
        shape=jmake.procedural_shape("armadillo"),
        bsdf=JCompose([JDiffuse((0.7, 0.4, 0.2)), JDiffuse((0.3, 0.3, 0.6))],
                      sp_var_fn=JMLP(in_size=3, out=2, num_layers=2, hidden_size=32,
                                     freqs=8, sigma=8.0)),
        lights=JPointLights(scale=1.5), occlusion="hard")
    tree = jax.tree.map(np.asarray, jscene.init(jax.random.PRNGKey(7)))
    scene = load_jax_params(make_nerv_dataset.build_scene(), tree, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(frame + 1):
        c2w, light = make_nerv_dataset.draw_frame(rng)
    p = dict(tree, lights=dict(tree["lights"], location=jnp.asarray(light[None])))
    img, _ = J.pathtrace(jscene, p, JNeRF(cam_to_world=jnp.asarray(c2w[None, :3, :4]),
                                          focal=make_nerv_dataset.focal(16)),
                         JMask(JDirect(training=False, horizon_mask=True)), size=16,
                         chunk_size=16, bundle_size=1, background=0.0, key=None)
    want = np.clip(np.asarray(img), 0, 1)
    got = make_nerv_dataset.render_frame(scene, c2w, light, size=16, key=None, device="cpu")
    mask, jmask = got[..., 3], want[..., 3]
    assert 0.1 < jmask.mean() < 0.9 and (mask == jmask).mean() >= 0.99
    both = (mask == 1) & (jmask == 1)
    diff = np.abs(got[..., :3] - want[..., :3])[both]
    assert (diff.max(-1) <= 1e-4).mean() >= 0.99
    assert want[..., :3][both].max() > 0.05 and not got[..., :3][mask == 0].any()


@pytest.mark.timeout(120)
def test_make_nerv_dataset_main_writes_the_splits(nerv_run):
    root, out, _, _ = nerv_run
    for split, n in (("train", 3), ("test", 2)):
        images, frames = out[split]
        assert images.shape == (n, 12, 12, 4) and len(frames) == n
        disk = TT.load_nerv(str(root / "armadillo"), 12, split)
        mem = make_nerv_dataset.as_dataset(images, frames, 12)
        for name in ("cam_to_worlds", "focal", "images", "masks", "light_locs"):
            np.testing.assert_array_equal(getattr(mem, name), getattr(disk, name),
                                          err_msg=name)
        assert 0.05 < disk.masks.mean() < 0.95
        assert np.allclose(np.linalg.norm(disk.light_locs, axis=-1), 1.3)
    # the NeRF-synthetic loader reads the train split too
    nerf = TT.load_nerf_synthetic(str(root / "armadillo" / "train_point"), 12, "train")
    np.testing.assert_array_equal(
        nerf.images, TT.load_nerv(str(root / "armadillo"), 12, "train").images)


@pytest.mark.timeout(120)
def test_nerv_device_data_main_runs_on_the_cpu(nerv_run, capsys):
    root, _, (state, results), _ = nerv_run
    assert state.step == 2 and set(results) == {"soft", "hard"}
    assert all(np.isfinite(v) for r in results.values() for v in r.values())
    assert state.scene.lights.location.shape == (2, 3)        # the last step's views
    assert (root / "models" / "nerv_armadillo" / "occ.msgpack").exists()


@pytest.mark.timeout(120)
def test_nerf_synthetic_main_runs_on_the_cpu(nerv_run):
    root, _, _, (state, results) = nerv_run
    assert state.step == 2 and len(results["losses"]) == 2
    assert np.isfinite(results["losses"]).all() and "test" not in results
    assert state.scene.shape.throughput_mode == "full"         # after the warm-up phase
    lines = (root / "out" / "metrics_train_point.jsonl").read_text().splitlines()
    assert sum("valid_psnr" in json.loads(x) for x in lines) == 2
    assert (root / "models" / "train_point" / "train_state.pt").exists()


@pytest.mark.timeout(120)
def test_render_nerf_workload_on_the_cpu(nerv_run, capsys):
    root = nerv_run[0]
    frames = render.main(["--workload", "nerf", "--models", str(root / "models" /
                                                                   "train_point"),
                          "--size", "8", "--frames", "2", "--max-steps", "16",
                          "--device", "cpu", "--outputs", str(root / "orbit")])
    assert frames.shape == (2, 8, 8, 3) and np.isfinite(frames).all()
    assert (root / "orbit" / "orbit_nerf_001.png").exists()


# --data-parallel is ported (tests/test_torch_parallel.py), with or without
# --surface hash; beside --device-data, a single-device path, it is refused
# (scripts/nerf_synthetic.py:227 asserts so)
@pytest.mark.parametrize("argv", [["--data-parallel"], ["--surface", "hash", "--data-parallel"]])
def test_nerf_synthetic_unported_options_raise(argv):
    with pytest.raises(ValueError, match="single-device"):
        nerf_synthetic.main(["--data", "unused", "--device", "cpu", "--device-data", *argv])
