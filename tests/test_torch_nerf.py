"""Port parity: the NeRF-family volume path — the four volumetric shapes,
``NeRFReproduce`` through ``pathtrace`` and ``pathtrace_sample``, one step of
the NeRFLE MSE training of ``scripts/nerfle.py``, ``load_colocate``, and the
twins ``workloads.nerfle`` and ``workloads.render`` on the CPU.

The shapes run at the JAX package's widths (NeRFLE's nets are fixed there:
5 x 128 and 8 x 64) with fewer samples; the weights are JAX's seeded init
carried over by ``load_jax_params``, with the density output's bias raised
by 0.5 so that the volume is not empty.  Rays: two FoV views (a camera axis
of 2, one light location per view), no jitter (``key=None`` on both sides).
Tolerances: rendered values atol 1e-5 (float32 matmuls summed in another
order, through Fourier features of scale up to ~75); the training step's
loss rtol 1e-5 and each gradient leaf within 1e-4 of its largest value;
``load_colocate`` bit-exact.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_raytracing_tpu as J
from neural_raytracing_tpu.cameras import FoVPerspectiveCamera as JFoV
from neural_raytracing_tpu.cameras import look_at_view_transform as j_look_at
from neural_raytracing_tpu.integrators import NeRFReproduce as JNeRFReproduce
from neural_raytracing_tpu.lights import PointLights as JPointLights
from neural_raytracing_tpu.render import pathtrace_sample as j_pathtrace_sample
from neural_raytracing_tpu.shapes import MPI as JMPI
from neural_raytracing_tpu.shapes import NeRFLE as JNeRFLE
from neural_raytracing_tpu.shapes import PartialNeRF as JPartialNeRF
from neural_raytracing_tpu.shapes import PlainNeRF as JPlainNeRF
from neural_raytracing_tpu.training.datasets import load_colocate as j_load_colocate
import neural_raytracing_tpu_torch as T
from neural_raytracing_tpu_torch.cameras import FoVPerspectiveCamera
from neural_raytracing_tpu_torch.integrators import NeRFReproduce
from neural_raytracing_tpu_torch.lights import PointLights
from neural_raytracing_tpu_torch.params import load_jax_params, state_dict_from_jax
from neural_raytracing_tpu_torch.shapes import MPI, NeRFLE, PartialNeRF, PlainNeRF
from neural_raytracing_tpu_torch.training import load_colocate, make_optimizer
from neural_raytracing_tpu_torch.workloads import nerfle, render
from test_torch_training import _flat

torch.set_num_threads(1)
LOCS = np.asarray([[0.3, 0.9, 1.1], [-0.8, 0.5, 0.7]], np.float32)
SHAPES = {   # name -> (JAX class, port class, kwargs)
    "nerfle": (JNeRFLE, NeRFLE, dict(steps=16)),
    "nerfle_envmap": (JNeRFLE, NeRFLE, dict(steps=16, envmap=True)),
    "plain": (JPlainNeRF, PlainNeRF, dict(steps=12)),
    "partial": (JPartialNeRF, PartialNeRF, dict(steps=12)),
    "mpi": (JMPI, MPI, dict(num_planes=6)),
}
ARTIFACTS = "scripts/models_seed_dir/nerv_mesh_gear_mirror200b"


def _pose(n_views=2, dist=1.0):
    r, t = j_look_at(dist=dist, elev=np.asarray([10.0, 35.0])[:n_views],
                     azim=np.asarray([-60.0, 45.0])[:n_views])
    return np.array(r, np.float32), np.array(t, np.float32)


def _rays(size=4):
    """[2, size, size, 1, 6] rays of two FoV views at distance 1."""
    from neural_raytracing_tpu.render import _tile_positions
    r, t = _pose()
    return np.array(JFoV(R=jnp.asarray(r), T=jnp.asarray(t)).sample_positions(
        _tile_positions(0.0, 0.0, size) * (64.0 / size), size=64))


def _scene_pair(name):
    """(JAX scene, JAX params, port scene on the CPU with those params)."""
    jcls, tcls, kw = SHAPES[name]
    jscene = J.Scene(shape=jcls(**kw), lights=JPointLights(scale=100.0))
    tree = jax.tree.map(np.array, jscene.init(jax.random.PRNGKey(0)))   # writable
    if "first" in tree["shape"]:                  # a non-empty volume
        tree["shape"]["first"]["out"]["b"][0] += 0.5
    tree["lights"]["location"] = LOCS
    scene = T.Scene(shape=tcls(**kw), lights=PointLights(scale=100.0))
    return jscene, tree, load_jax_params(scene, tree, device="cpu")


@pytest.mark.parametrize("name,latent", [(name, False) for name in sorted(SHAPES)]
                         + [("plain", True), ("partial", True)])
def test_volume_render_matches_jax(name, latent):
    jscene, tree, scene = _scene_pair(name)
    rays = _rays()
    kw, jkw = {}, {}
    if latent:
        codes = np.random.default_rng(3).normal(size=(2, 32)).astype(np.float32)
        if name == "partial":      # PartialNeRF broadcasts its latent as given
            codes = codes[:1]
        kw, jkw = dict(latent=torch.from_numpy(codes)), dict(latent=jnp.asarray(codes))
    want = np.asarray(jscene.shape.volume_render(
        tree["shape"], jnp.asarray(rays), None, jscene.lights, tree["lights"], **jkw))
    with torch.no_grad():
        got = scene.shape.volume_render(torch.from_numpy(rays), None, scene.lights,
                                        **kw).numpy()
    assert got.shape == rays.shape[:-1] + (3,)
    assert np.abs(want).max() > 0.05 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_parameters_follow_the_pytree_and_init_draws():
    _, tree, scene = _scene_pair("nerfle")
    names = dict(scene.named_parameters())
    assert names["shape.first.init.w"].shape == (35, 128)
    assert names["shape.second.init.w"].shape == (102, 64)
    assert "shape.second.B" in dict(scene.named_buffers())
    # MPI's plane point and normal are constants, not leaves of the tree
    mpi_tree = jax.tree.map(np.asarray, JMPI().init(jax.random.PRNGKey(0)))
    assert set(MPI().state_dict()) == set(state_dict_from_jax(mpi_tree))
    a = nerfle.build_scene().init(torch.Generator().manual_seed(0), device="cpu")
    b = nerfle.build_scene().init(torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    with pytest.raises(ValueError, match="fused"):
        NeRFLE(fused="on")


# ---- NeRFReproduce through the render drivers ------------------------------------

@pytest.mark.parametrize("name", ["nerfle", "nerfle_envmap", "mpi"])
def test_pathtrace_and_sample_match_jax(name):
    jscene, tree, scene = _scene_pair(name)
    r, t = _pose()
    jcam = JFoV(R=jnp.asarray(r), T=jnp.asarray(t))
    cam = FoVPerspectiveCamera(R=torch.from_numpy(r), T=torch.from_numpy(t))
    want, _ = J.pathtrace(jscene, tree, jcam, JNeRFReproduce(), size=8, chunk_size=4,
                          bundle_size=1, background=0.0, key=None)
    got, _ = T.pathtrace(scene, cam, NeRFReproduce(), size=8, chunk_size=4,
                         bundle_size=1, background=0.0, key=None, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    jv, ja, jit_ = j_pathtrace_sample(jscene, JNeRFReproduce(), tree, jcam, (2.0, 3.0),
                                      None, crop_size=4, bundle_size=2, size=8)
    v, a, it = T.pathtrace_sample(scene, NeRFReproduce(), cam, (2, 3), None,
                                  crop_size=4, bundle_size=2, size=8)
    assert v.shape == (2, 4, 4, 2, 3) and a.all() and not it.t.any()
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), atol=1e-5, rtol=0)
    np.testing.assert_allclose(it.p.numpy(), np.asarray(jit_.p), atol=1e-6, rtol=0)


# ---- one NeRFLE training step ----------------------------------------------------

SIZE, CROP, UV = 16, 4, (5, 9)


@functools.lru_cache(maxsize=None)
def _step_case():
    jscene, tree, scene = _scene_pair("nerfle")
    r, t = _pose()
    jcam = JFoV(R=jnp.asarray(r), T=jnp.asarray(t))
    exp = np.random.default_rng(4).uniform(size=(2, CROP, CROP, 3)).astype(np.float32)

    def loss_fn(p):                       # scripts/nerfle.py:67-76, key None
        got, _, _ = j_pathtrace_sample(jscene, JNeRFReproduce(), p, jcam,
                                       tuple(map(jnp.float32, UV)), None,
                                       crop_size=CROP, bundle_size=1, size=SIZE)
        return jnp.mean(jnp.square(jnp.mean(got, axis=-2) - exp))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jax.tree.map(jnp.asarray, tree))
    return scene, r, t, exp, float(loss), _flat(grads)


def test_nerfle_step_matches_jax():
    scene, r, t, exp, jloss, jgrads = _step_case()
    optimizer = make_optimizer({"shape": 5e-4, "lights": 5e-4}).init(scene)
    before = {k: p.detach().clone() for k, p in scene.named_parameters()}
    step = nerfle.build_step(scene, optimizer, size=SIZE, crop_size=CROP)
    cam = FoVPerspectiveCamera(R=torch.from_numpy(r), T=torch.from_numpy(t))
    loss = step(cam, UV, torch.from_numpy(exp))
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    for k, p in scene.named_parameters():
        # a parameter the render does not read (the light's falloff) has no
        # gradient here and a zero one in JAX
        g = p.grad.numpy() if p.grad is not None else np.zeros_like(jgrads[k])
        wg = jgrads[k]
        np.testing.assert_allclose(g, wg, rtol=0, atol=1e-4 * np.abs(wg).max() + 1e-12,
                                   err_msg=k)
    for k in ("shape.first.init.w", "shape.second.out.w", "lights.location"):
        assert np.abs(jgrads[k]).max() > 0
        assert not torch.equal(before[k], scene.get_parameter(k)), k


# ---- the colocated dataset and the twins -----------------------------------------

def _write_colocate(root, kind, n_elev, n_azim, px=20):
    from PIL import Image
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(n_elev * 10 + n_azim)
    for i in range(n_elev):
        for j in range(n_azim):
            img = (rng.uniform(size=(px, px, 4)) * 255).astype(np.uint8)
            img[..., 3] = np.where(rng.uniform(size=(px, px)) > 0.4, 255, 0)
            img[0, 0, 3] = 1                                   # ceil(1/255 - 1e-5) = 1
            Image.fromarray(img).save(root / f"{kind}_{i}_{j}.png")


def test_load_colocate_matches_jax(tmp_path):
    _write_colocate(tmp_path, "bunny", 2, 3)
    got = load_colocate(str(tmp_path), "bunny", 16, n_elev=2, n_azim=3)
    want = j_load_colocate(str(tmp_path), "bunny", 16, n_elev=2, n_azim=3)
    assert got.images.shape == (6, 16, 16, 3) and got.dist == want.dist == 1.0
    for name in ("images", "masks", "elevs", "azims"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert set(np.unique(got.masks)) <= {0.0, 1.0}


def test_nerfle_workload_main_runs_on_the_cpu(tmp_path, capsys):
    data = tmp_path / "cbox"
    _write_colocate(data, "bunny", 2, 2)
    scene, losses, results = nerfle.main([
        "--data", str(data), "--n-elev", "2", "--n-azim", "2", "--size", "16",
        "--iters", "2", "--crop-size", "8", "--n-views", "2", "--log-every", "1",
        "--device", "cpu", "--outputs", str(tmp_path / "out"),
        "--models", str(tmp_path / "models")])
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert np.isfinite(list(results.values())).all()
    assert scene.lights.location.shape == (2, 3)        # the last step's lights
    assert (tmp_path / "models" / "nerfle_bunny" / "shape.msgpack").exists()
    assert (tmp_path / "out" / "nerfle_bunny_03.png").exists()
    assert "step      1 loss" in capsys.readouterr().out


def test_render_workload_main_runs_on_the_cpu(tmp_path, capsys):
    args = ["--workload", "nerv", "--models", ARTIFACTS, "--size", "8", "--frames", "2",
            "--max-steps", "16", "--device", "cpu", "--outputs", str(tmp_path)]
    relaxed = render.main(args + ["--omega", "1.4"])
    plain = render.main(args)
    assert relaxed.shape == plain.shape == (2, 8, 8, 3)
    assert np.isfinite(relaxed).all() and plain.max() > 0
    assert (tmp_path / "orbit_nerv_001.png").exists()
    assert "frame 2/2" in capsys.readouterr().out
    for extra in (["--workload", "nerf"], ["--integrator", "debug"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            render.main(args + extra)
