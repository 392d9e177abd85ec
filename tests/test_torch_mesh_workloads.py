"""Port parity: the mesh ground truth and its users — ``make_mesh_dataset``
(``build_gt_scene``, ``_ZGate``, ``c2w_up``, ``main`` in its three formats),
``path_demo`` and ``seed_shape``.

The ground-truth scenes load the JAX ``PRNGKey(7)`` weights
(``load_jax_params``) and render a 16^2 view of each kind, with and without
the mirror plate, against ``scripts/make_mesh_dataset.py``'s scene; the
multi-bounce ``Path`` on the mirror scene runs on a view's camera rays with
the JAX uniforms replayed (``test_torch_bsdf_sampling``'s ``replay``).
``seed_shape``'s targets and one fit step (Huber loss, Adam) are held
against ``scripts/seed_shape.py``'s formulas with optax on the same points.
The entry points run at toy sizes on the CPU.

Tolerances: a view (no camera jitter) exactly as to its masks and within
1e-4 as to its colours on every pixel whose camera ray and shadow ray pass
no edge within 1e-5 (barycentric) of a face they cross, at least 90% of
the pixels: a ray through a shared edge hits one face, the other or
neither by the last bit of a product, and XLA on the CPU fuses products
into FMAs; the background exactly 0.  ``Path`` as ``test_torch_path``;
targets within 1e-6, the loss rtol 1e-5, gradients and the stepped
parameters within 1e-4 of their largest.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import neural_raytracing_tpu as J
import neural_raytracing_tpu.integrators as JI
import neural_raytracing_tpu.raster as JR
from neural_raytracing_tpu.cameras import NeRFCamera as JNeRF
from neural_raytracing_tpu.shapes import SDF as JSDF
from neural_raytracing_tpu.shapes import SphereSDF as JSphereSDF
import neural_raytracing_tpu_torch.integrators as I
import neural_raytracing_tpu_torch.training as TT
from neural_raytracing_tpu_torch.params import load_jax_params, state_dict_from_jax
from neural_raytracing_tpu_torch.render import _tile_positions
from neural_raytracing_tpu_torch.workloads import make_mesh_dataset as mm
from neural_raytracing_tpu_torch.workloads import nerv, path_demo, seed_shape
from test_torch_bsdf_sampling import GEN, replay  # noqa: F401  (replay: a fixture)
from test_torch_path import _compare, path_draws

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import make_mesh_dataset as jmm  # noqa: E402  (scripts/make_mesh_dataset.py)

torch.set_num_threads(1)
LIGHT = np.asarray([1.0, 0.5, 1.2], np.float32)


def _pair(kind, plate, material="default"):
    """(JAX scene, its PRNGKey(7) params, the port's scene with them)."""
    jscene = jmm.build_gt_scene(kind, 1.0, mirror_plate=plate, material=material)
    tree = jax.tree.map(np.asarray, jscene.init(jax.random.PRNGKey(7)))
    scene = mm.build_gt_scene(kind, 1.0, mirror_plate=plate, material=material)
    return jscene, tree, load_jax_params(scene, tree, device="cpu")


def _view(elev=30.0, azim=40.0, dist=1.2):
    return jmm.c2w_up(elev, azim, dist, up="z")


def _near_edge(mesh, rays, max_t, margin=1e-5):
    """Rays that pass within ``margin`` (barycentric) of an edge of a face
    they cross before ``max_t``: there the last bit of a product decides
    which face, if any, the ray hits."""
    from neural_raytracing_tpu_torch.ops.math import cross
    r_o, r_d = rays[..., :3], rays[..., 3:]
    v0, v1, v2 = mesh.tris[:, 0], mesh.tris[:, 1], mesh.tris[:, 2]
    e1, e2 = v1 - v0, v2 - v0
    pv = cross(r_d[..., None, :], e2)
    inv = 1.0 / torch.sum(e1 * pv, dim=-1)
    tv = r_o[..., None, :] - v0
    qv = cross(tv, e1)
    t = torch.sum(e2 * qv, dim=-1) * inv
    u, v = torch.sum(tv * pv, dim=-1) * inv, torch.sum(r_d[..., None, :] * qv, dim=-1) * inv
    m = torch.minimum(torch.minimum(u, v), 1.0 - u - v)
    return torch.any((t > 0) & (t < max_t[..., None]) & (m.abs() < margin), dim=-1)


def _clean_pixels(scene, camera, size, light):
    """The pixels whose camera ray and shadow ray pass no edge."""
    rays = camera.sample_positions(_tile_positions(0.0, 0.0, size, "cpu"), size=size)[0, ..., 0, :]
    it, hit = scene.shape.intersect(rays)
    to_light = torch.from_numpy(light) - it.p
    dist = torch.linalg.norm(to_light, dim=-1)
    shadow = torch.cat([it.p, to_light / dist[..., None]], dim=-1)
    edge = _near_edge(scene.shape, rays, torch.full(hit.shape, 1e10))
    edge |= hit & _near_edge(scene.shape, shadow, dist)
    return ~edge.numpy()


def _compare_views(got, want, clean):
    """Masks and colours equal (1e-4) on the pixels whose rays pass no edge,
    which are most of them."""
    mask, jmask = got[..., 3], want[..., 3]
    assert 0.05 < jmask.mean() < 0.95 and clean.mean() >= 0.9
    assert (mask == jmask)[clean].all()
    both = (mask == 1) & (jmask == 1) & clean
    diff = np.abs(got[..., :3] - want[..., :3]).max(-1)[both]
    assert (diff <= 1e-4).all() and both.sum() >= 0.8 * (jmask == 1).sum()
    assert want[..., :3][both].max() > 0.05 and not got[..., :3][mask == 0].any()


@pytest.mark.parametrize("plate", [0.0, 0.7])
@pytest.mark.parametrize("kind", sorted(jmm.MESHES))
def test_gt_scene_view_matches_jax(kind, plate):
    jscene, tree, scene = _pair(kind, plate, "variety" if kind == "blocks" else "default")
    c2w = _view()
    p = dict(tree, lights=dict(tree["lights"], location=jnp.asarray(LIGHT[None]),
                               scale=jnp.float32(3.0)))
    img, _ = J.pathtrace(jscene, p, JNeRF(cam_to_world=jnp.asarray(c2w[None, :3, :4]),
                                          focal=mm.focal(16)),
                         JI.Mask(JI.Direct(training=False, horizon_mask=True)), size=16,
                         chunk_size=16, background=0.0, key=None)
    cam = mm.nerf_camera(c2w, 16)
    got = mm.render(scene, cam, LIGHT, 3.0, mm.gt_integrator()[0], 1, size=16, device="cpu",
                    key=None)
    _compare_views(got, np.asarray(img), _clean_pixels(scene, cam, 16, LIGHT))


def test_path_on_the_mirror_scene_matches_jax(replay):
    """Path(max_depth=2) on the gear over its mirror plate: the camera rays
    that see the plate bounce to the object and its light."""
    jscene, tree, scene = _pair("gear", 0.7)
    tree["lights"]["location"] = LIGHT[None]
    tree["lights"]["scale"] = np.float32(3.0)
    scene = load_jax_params(scene, tree, device="cpu")
    cam = mm.nerf_camera(_view(elev=35.0, azim=-20.0, dist=2.0), 16)
    rays = cam.sample_positions(_tile_positions(0.0, 0.0, 16, "cpu"), size=16).numpy()
    key = jax.random.PRNGKey(21)
    outs = {}
    for depth in (1, 2):
        v, a, _ = JI.Path(max_depth=depth, horizon_mask=True).sample(
            jscene, jax.tree.map(jnp.asarray, tree), jnp.asarray(rays), key=key)
        outs[depth] = np.asarray(v), np.asarray(a)
    replay(path_draws(jscene, key, rays.shape[:-1], 2))
    with torch.no_grad():
        got, hit, _ = I.Path(max_depth=2, horizon_mask=True).sample(
            scene, torch.from_numpy(rays), GEN)
    want, jhit = outs[2]
    close = _compare(got, hit.numpy(), want, jhit, "Path depth 2 on the mirror scene")
    bounced = (np.abs(want - outs[1][0]) > 1e-3 * np.abs(outs[1][0]).max()).any(-1)
    assert bounced.sum() >= 5 and close[bounced].mean() >= 0.9


def test_zgate_and_c2w_up_match_jax():
    for up in ("y", "z"):
        for elev, azim in ((8.0, 0.0), (35.0, -120.0), (55.0, 170.0)):
            np.testing.assert_array_equal(mm.c2w_up(elev, azim, 2.0, up=up),
                                          jmm.c2w_up(elev, azim, 2.0, up=up))
    jscene, tree, scene = _pair("ico", 0.7)
    gate, jgate = scene.bsdf.sp_var_fn, jscene.bsdf.sp_var_fn
    assert isinstance(gate, mm._ZGate)
    # the gate's state is the inner net's, as the JAX gate's params are
    assert set(gate.state_dict()) == set(gate.inner.state_dict()) == set(
        state_dict_from_jax(tree["bsdf"]["sp_var_fn"]))
    x = np.random.default_rng(0).normal(scale=0.4, size=(64, 3)).astype(np.float32)
    x[:8, 2] = jgate.z0 - 0.01                         # below the gate: the mirror lobe
    want = np.asarray(jgate(jax.tree.map(jnp.asarray, tree["bsdf"]["sp_var_fn"]),
                            jnp.asarray(x)))
    got = gate(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert (got[:8, -1] > 5).all() and (got[:8, :-1] < -5).all()
    assert gate.z0 == jgate.z0 and gate.sharp == jgate.sharp


# ---- the entry points on the CPU ---------------------------------------------------------

FORMATS = {
    "nerv": ["--kind", "gear", "--mirror-plate", "0.7", "--gt-bounces", "2", "--gt-spp", "2",
             "--cam-dist", "2.0", "--up", "z", "--elev-range", "8", "55"],
    "nerf": ["--kind", "ico", "--n-lights", "3", "--cam-dist", "1.6"],
    "colocate": ["--kind", "knot", "--n-elev", "2", "--n-azim", "2", "--light-scale", "2.5"],
}


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh")
    out = {}
    for fmt, extra in FORMATS.items():
        path = root / fmt
        out[fmt] = path, mm.main(["--out", str(path), "--format", fmt, "--size", "16",
                                  "--train-views", "3", "--test-views", "2", "--device", "cpu",
                                  *extra])
    return out


@pytest.mark.timeout(300)
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_make_mesh_dataset_main_writes_each_format(datasets, fmt):
    path, out = datasets[fmt]
    meta = json.load(open(path / "meta.json"))
    assert meta["format"] == fmt and meta["size"] == 16 and meta["light_scale"] > 0
    assert meta["args"]["device"] == "cpu"
    if fmt == "colocate":
        assert meta["light_scale"] == 2.5
        disk = TT.load_colocate(str(path), "knot", 16, n_elev=2, n_azim=2)
        mem = np.stack([out["grid"][i, j] for i in range(2) for j in range(2)])
        np.testing.assert_array_equal(disk.images, mem[..., :3] / np.float32(255.0))
        assert 0.02 < disk.masks.mean() < 0.95
        return
    for split, n in (("train", 3), ("test", 2)):
        images, frames = out[split]
        assert images.shape == (n, 16, 16, 4) and images.dtype == np.uint8
        if fmt == "nerv":
            disk = TT.load_nerv(str(path), 16, split)
            mem = nerv_dataset(images, frames)
            for name in ("cam_to_worlds", "focal", "images", "masks", "light_locs"):
                np.testing.assert_array_equal(getattr(mem, name), getattr(disk, name),
                                              err_msg=name)
            assert np.allclose(np.linalg.norm(disk.light_locs, axis=-1), 1.3)
        else:
            disk = TT.load_nerf_synthetic(str(path), 16, split)
            np.testing.assert_array_equal(disk.images, images[..., :3] / np.float32(255.0))
            assert all("light_loc" not in f for f in frames)
        assert 0.02 < disk.masks.mean() < 0.95


def nerv_dataset(images, frames):
    from neural_raytracing_tpu_torch.workloads.make_nerv_dataset import as_dataset
    return as_dataset(images, frames, 16)


def test_the_nerv_frames_draw_as_the_jax_script(datasets):
    """The frames' cameras and lights: ``default_rng(seed)``, train then test."""
    _, out = datasets["nerv"]
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        for frame in out[split][1]:
            c2w = jmm.c2w_up(rng.uniform(8.0, 55.0), rng.uniform(-180, 180), 2.0, up="z")
            d = c2w[:3, 3] / np.linalg.norm(c2w[:3, 3]) + 0.6 * rng.normal(size=3)
            np.testing.assert_array_equal(np.asarray(frame["transform_matrix"]), c2w)
            np.testing.assert_allclose(frame["light_loc"], 1.3 * d / np.linalg.norm(d))


@pytest.mark.timeout(300)
def test_path_demo_main_runs_on_the_cpu(datasets, tmp_path):
    path, _ = datasets["nerv"]
    out = path_demo.main(["--data", str(path), "--samples", "2", "--device", "cpu",
                          "--outputs", str(tmp_path)])
    record = json.load(open(tmp_path / "path_demo.json"))
    assert len(out["per_view"]) == len(record["per_view"]) == 2
    for row in record["per_view"]:
        assert np.isfinite(row["psnr_direct"]) and np.isfinite(row["psnr_path"])
    assert record["delta"] == pytest.approx(record["avg_psnr_path"] - record["avg_psnr_direct"])
    assert (tmp_path / "path_demo_gt_direct_path.png").exists()
    assert out["strip"].shape == (32, 48, 3)


# ---- seed_shape ---------------------------------------------------------------------------

def _jax_tris(kind, mirror_plate, obj_scale=1.0):
    """scripts/seed_shape.py's target triangles."""
    verts, faces = jmm.MESHES[kind]()
    verts = np.asarray(verts, np.float32) * np.float32(obj_scale)
    tris = [verts[np.asarray(faces)]]
    if mirror_plate > 0.0:
        plate_top = float(verts[:, 2].min()) - 0.005
        pv, pf = jmm._box_tris((0.0, 0.0, plate_top - 0.03), (mirror_plate, mirror_plate, 0.03))
        tris.append(np.asarray(pv, np.float32)[np.asarray(pf)])
    return np.concatenate(tris, axis=0)


def test_seed_shape_targets_match_jax():
    tris = seed_shape.target_tris("gear", 1.2, 0.7)
    np.testing.assert_array_equal(tris, _jax_tris("gear", 0.7, 1.2))
    assert tris.shape == (84, 3, 3)
    pts = seed_shape.probe_points(torch.from_numpy(tris), 256, 256,
                                  torch.Generator().manual_seed(0))
    assert pts.shape == (512, 3) and (pts[:256].abs() <= 1.25).all()
    got = seed_shape.targets_of(pts, torch.from_numpy(tris), 0.01, 0.26)
    d2, _ = JR.point_face_distance(jnp.asarray(pts.numpy()), jnp.asarray(tris))
    want = np.asarray(jnp.minimum(jnp.sqrt(jnp.maximum(d2, 0.0)) - 0.01, 0.26))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert (want < 0.02).mean() > 0.1 and (want == np.float32(0.26)).any()


def test_seed_shape_fit_step_matches_optax():
    """One step at a pinned batch: the mean Huber loss (delta 0.05) of the
    NeRV twin's SDF, its gradient and Adam's update, against optax."""
    jsdf = JSDF(JSphereSDF(n=128), max_steps=64, throughput_steps=128, dist=3.4)
    jparams = jsdf.init(jax.random.PRNGKey(3))
    jparams = jax.tree.map(jnp.asarray, jparams)
    # a non-zero shift net, so its gradient is not the zero init's
    rng = np.random.default_rng(4)
    jparams = jax.tree.map(lambda x: x + 0.02 * rng.normal(size=x.shape).astype(np.float32),
                           jparams)
    scene = nerv.build_scene(dist=3.4)
    load_jax_params(scene.shape, jax.tree.map(np.asarray, jparams), device="cpu")
    p = rng.uniform(-1.0, 1.0, (512, 3)).astype(np.float32)
    t = rng.uniform(-0.05, 0.26, 512).astype(np.float32)
    t[:64] = np.asarray(jsdf.sdf(jparams, jnp.asarray(p[:64]))) + 0.03    # quadratic zone

    def loss_fn(sp):
        return jnp.mean(optax.huber_loss(jsdf.sdf(sp, jnp.asarray(p)), jnp.asarray(t),
                                         delta=0.05))

    jloss, jgrads = jax.value_and_grad(loss_fn)(jparams)
    opt = optax.adam(1e-2)
    upd, _ = opt.update(jgrads, opt.init(jparams))
    jnew = optax.apply_updates(jparams, upd)

    optimizer = torch.optim.Adam(scene.shape.parameters(), lr=1e-2)
    # the gradient, before the step
    scene.shape.zero_grad()
    torch.mean(seed_shape.huber(scene.shape.sdf(torch.from_numpy(p)),
                                torch.from_numpy(t))).backward()
    grads = {k: v.grad.clone() for k, v in scene.shape.named_parameters()}
    loss = seed_shape.fit_step(scene, optimizer, torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for name, leaves in (("grad", (grads, state_dict_from_jax(jax.tree.map(np.asarray,
                                                                             jgrads)))),
                         ("param", (dict(scene.shape.named_parameters()),
                                    state_dict_from_jax(jax.tree.map(np.asarray, jnew))))):
        got, want = leaves
        # the Fourier basis B: a buffer here, a leaf under stop_gradient in JAX
        assert set(got) == {k for k in want if not k.endswith(".B")}
        for k in got:
            w = want[k].numpy()
            np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=1e-4,
                                       atol=1e-4 * max(np.abs(w).max(), 1e-12),
                                       err_msg=f"{name} {k}")


@pytest.mark.timeout(120)
def test_seed_shape_main_runs_on_the_cpu(tmp_path):
    out = seed_shape.main(["--kind", "gear", "--mirror-plate", "0.7", "--iters", "3",
                           "--batch", "128", "--n-uniform", "256", "--n-surface", "256",
                           "--models", str(tmp_path), "--name", "seed", "--device", "cpu"])
    assert out["losses"].shape == (3,) and torch.isfinite(out["losses"]).all()
    assert out["points"].shape == (512, 3) and set(out["report"]) >= {"p50", "p90", "frac_neg"}
    scene = nerv.build_scene(dist=3.4).init(torch.Generator().manual_seed(5), device="cpu")
    TT.load_scene(str(tmp_path / "seed"), scene)
    for k, v in out["scene"].state_dict().items():
        np.testing.assert_array_equal(scene.state_dict()[k].numpy(), v.numpy(), err_msg=k)
    assert json.load(open(tmp_path / "seed" / "meta.json"))["step"] == 0
