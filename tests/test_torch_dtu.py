"""Port parity: the DTU camera and loader, and the DTU generator twin.

``lift`` and ``DTUCamera.sample_positions`` against the JAX package on
seeded poses (4x4 and 3x4 poses, 4x4 and 3x3 intrinsics, ``src_size`` given
and None, bundles of 1 and 2); ``decompose_projection`` bit for bit;
``load_dtu`` on a 12^2 scan written by ``workloads.make_dtu_dataset``
against the JAX ``load_dtu`` on the same directory, exactly, and
``dtu_dataset`` on the arrays in memory against both; the generator's
cameras against the numpy of ``scripts/make_dtu_dataset.py``; its 16^2
render with the JAX ``PRNGKey(7)`` weights against the JAX render; and the
source-size mismatch between the JAX generator and loader, as a test.

Tolerances: the camera rays atol 1e-6 (float32 products in another order);
the render as ``test_torch_colocate``'s generator: hit masks equal on >=
99% of the pixels, >= 99% of the pixels both hit within 1e-4, the
background exactly 0.
"""

import functools
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import make_dataset as jmake  # noqa: E402  (scripts/make_dataset.py)

import neural_raytracing_tpu as J  # noqa: E402
from neural_raytracing_tpu.bsdf import ComposeSpatialVarying as JCompose  # noqa: E402
from neural_raytracing_tpu.bsdf import Diffuse as JDiffuse  # noqa: E402
from neural_raytracing_tpu.cameras import DTUCamera as JDTUCamera  # noqa: E402
from neural_raytracing_tpu.cameras import lift as jlift  # noqa: E402
from neural_raytracing_tpu.integrators import Direct as JDirect  # noqa: E402
from neural_raytracing_tpu.integrators import Mask as JMask  # noqa: E402
from neural_raytracing_tpu.lights import PointLights as JPointLights  # noqa: E402
from neural_raytracing_tpu.nn import SkipConnMLP as JMLP  # noqa: E402
from neural_raytracing_tpu.training import datasets as jdatasets  # noqa: E402
import neural_raytracing_tpu_torch.training as TT  # noqa: E402
from neural_raytracing_tpu_torch.cameras import DTUCamera, lift  # noqa: E402
from neural_raytracing_tpu_torch.params import load_jax_params  # noqa: E402
from neural_raytracing_tpu_torch.render import _tile_positions  # noqa: E402
from neural_raytracing_tpu_torch.workloads import make_dtu_dataset  # noqa: E402

torch.set_num_threads(1)


def _poses(n, seed):
    """Seeded camera-to-world poses [n, 4, 4] (orthonormal rotations, centres
    at distance ~1-2) and intrinsics [n, 4, 4] with skew."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    pose = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    pose[:, :3, :3] = q
    pose[:, :3, 3] = rng.uniform(-1.5, 1.5, (n, 3))
    intr = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    intr[:, 0, 0] = rng.uniform(800, 1200, n)
    intr[:, 1, 1] = rng.uniform(800, 1200, n)
    intr[:, 0, 2] = rng.uniform(700, 900, n)
    intr[:, 1, 2] = rng.uniform(500, 700, n)
    intr[:, 0, 1] = rng.uniform(-2, 2, n)
    return pose.astype(np.float32), intr


@pytest.mark.parametrize("pose_rows", [4, 3])
@pytest.mark.parametrize("intr_size", [4, 3])
@pytest.mark.parametrize("src_size", [(640.0, 480.0), None])
@pytest.mark.parametrize("bundle", [1, 2])
def test_dtu_camera_matches_jax(pose_rows, intr_size, src_size, bundle):
    pose, intr = _poses(2, 3)
    pose, intr = pose[:, :pose_rows], intr[:, :intr_size, :intr_size]
    size = 16
    pos = _tile_positions(2.0, 5.0, 6, "cpu")
    got = DTUCamera(torch.from_numpy(pose), torch.from_numpy(intr), src_size).sample_positions(
        pos, bundle_size=bundle, size=size)
    jcam = JDTUCamera(pose=jnp.asarray(pose), intrinsic=jnp.asarray(intr),
                      src_size=None if src_size is None else jnp.asarray(src_size, jnp.float32))
    want = np.asarray(jcam.sample_positions(jnp.asarray(pos.numpy()), bundle_size=bundle,
                                            size=size))
    assert got.shape == want.shape == (2, 6, 6, bundle, 6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # no jitter: the generator and with_noise are ignored
    noisy = DTUCamera(torch.from_numpy(pose), torch.from_numpy(intr), src_size).sample_positions(
        pos, generator=torch.Generator().manual_seed(0), bundle_size=bundle, size=size,
        with_noise=0.5)
    assert torch.equal(noisy, got)


@pytest.mark.parametrize("intr_size", [4, 3])
def test_lift_matches_jax(intr_size):
    _, intr = _poses(3, 4)
    intr = intr[:, :intr_size, :intr_size]
    rng = np.random.default_rng(5)
    x, y = rng.uniform(0, 1600, (2, 3, 10)).astype(np.float32)
    z = rng.uniform(0.5, 2, (3, 10)).astype(np.float32)
    got = lift(*map(torch.from_numpy, (x, y, z, intr)))
    want = np.asarray(jlift(*map(jnp.asarray, (x, y, z, intr))))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_decompose_projection_same_bits(seed):
    pose, intr = _poses(1, 10 + seed)
    R = pose[0, :3, :3].T
    t = -R @ pose[0, :3, 3]
    P = intr[0, :3, :3] @ np.concatenate([R, t[:, None]], axis=1)
    for a, b in zip(TT.decompose_projection(P), jdatasets.decompose_projection(P)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    K, R2, c = TT.decompose_projection(P)
    np.testing.assert_allclose(K, intr[0, :3, :3] / intr[0, 2, 2], rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(R2, R, atol=1e-5)
    np.testing.assert_allclose(c, pose[0, :3, 3], atol=1e-5)


# ---- the generator twin and the loader ----------------------------------------------

@pytest.fixture(scope="module")
def scan(tmp_path_factory):
    """make_dtu_dataset.main: 3 views at 12x12 on the CPU."""
    out = tmp_path_factory.mktemp("dtu")
    images, masks, cams = make_dtu_dataset.main(["--out", str(out), "--views", "3",
                                                 "--size", "12", "--device", "cpu"])
    return out, images, masks, cams


@pytest.mark.parametrize("normalize_dist", [True, False])
def test_load_dtu_matches_jax_on_the_generated_scan(scan, normalize_dist):
    out, images, masks, cams = scan
    assert sorted(os.listdir(out)) == ["cameras.npz", "image", "mask"]
    got = TT.load_dtu(str(out), 12, normalize_dist=normalize_dist)
    want = jdatasets.load_dtu(str(out), 12, normalize_dist=normalize_dist)
    for name in ("poses", "intrinsics", "images", "masks"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.src_size == want.src_size == (1600, 1200)
    assert 0.1 < got.masks.mean() < 0.9
    # the arrays in memory give the same dataset
    imgs, msks = make_dtu_dataset.as_arrays(images, masks)
    mem = TT.dtu_dataset(cams, imgs, msks, 12, normalize_dist=normalize_dist)
    for name in ("poses", "intrinsics", "images", "masks"):
        np.testing.assert_array_equal(getattr(mem, name), getattr(got, name), err_msg=name)


def _script_cameras(views, size):
    """The camera loop of scripts/make_dtu_dataset.py:81-115, as it computes."""
    src_w = src_h = float(size)
    K = np.eye(3, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.5 * src_w / math.tan(math.radians(30.0))
    K[0, 2] = src_w / 2.0
    K[1, 2] = src_h / 2.0
    rng = np.random.default_rng(0)
    cams, poses = {}, []
    for i in range(views):
        elev = math.radians(rng.uniform(5, 45))
        azim = math.radians(rng.uniform(-180, 180))
        dist = 1.0
        c = np.asarray([dist * math.cos(elev) * math.sin(azim), dist * math.sin(elev),
                        dist * math.cos(elev) * math.cos(azim)], np.float32)
        forward = -c / np.linalg.norm(c)
        right = np.cross(np.asarray([0.0, 1.0, 0.0]), forward)
        right /= max(np.linalg.norm(right), 1e-9)
        up = np.cross(forward, right)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 0] = right
        pose[:3, 1] = up
        pose[:3, 2] = forward
        pose[:3, 3] = c
        R = pose[:3, :3].T
        t = -R @ c
        P = np.eye(4, dtype=np.float32)
        P[:3, :4] = K @ np.concatenate([R, t[:, None]], axis=1)
        cams[f"world_mat_{i}"] = P
        cams[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
        poses.append(pose)
    intr = np.pad(K, ((0, 1), (0, 1)))[None] + np.diag([0.0, 0, 0, 1.0])[None]
    return cams, np.stack(poses), intr


def test_generator_cameras_match_the_jax_script(scan):
    want, want_poses, want_intr = _script_cameras(16, 200)
    poses, cams = make_dtu_dataset.scan_cameras(16, 200)
    assert sorted(cams) == sorted(want)
    for k in want:
        assert cams[k].dtype == want[k].dtype
        np.testing.assert_array_equal(cams[k], want[k], err_msg=k)
    np.testing.assert_array_equal(poses, want_poses)
    cam = make_dtu_dataset.render_camera(poses[3], 200)
    np.testing.assert_array_equal(cam.intrinsic.numpy(), want_intr.astype(np.float32))
    assert cam.src_size == (200.0, 200.0)
    # the scan on disk holds the script's cameras for its size
    on_disk = np.load(os.path.join(scan[0], "cameras.npz"))
    small, _, _ = _script_cameras(3, 12)
    for k in small:
        np.testing.assert_array_equal(on_disk[k], small[k], err_msg=k)


def _jax_generator_scene():
    """The scene of scripts/make_dtu_dataset.py:68-76."""
    return J.Scene(
        shape=jmake.procedural_shape("bunny"),
        bsdf=JCompose([JDiffuse((0.8, 0.3, 0.2)), JDiffuse((0.2, 0.3, 0.8))],
                      sp_var_fn=JMLP(in_size=3, out=2, num_layers=2, hidden_size=32,
                                     freqs=8, sigma=8.0)),
        lights=JPointLights(location=(0.3, 0.6, 0.6), scale=3.0), occlusion="hard")


@functools.lru_cache(maxsize=None)
def _generator_case():
    jscene = _jax_generator_scene()
    tree = jax.tree.map(np.asarray, jscene.init(jax.random.PRNGKey(7)))
    scene = load_jax_params(make_dtu_dataset.build_scene("bunny", 3.0), tree, device="cpu")
    _, poses, intr = _script_cameras(max(GEN_VIEWS) + 1, 16)
    wants = {}
    for i in GEN_VIEWS:
        pose = poses[i]
        cam = JDTUCamera(pose=jnp.asarray(pose[None]), intrinsic=jnp.asarray(intr),
                         src_size=jnp.asarray([16.0, 16.0]))
        img, _ = J.pathtrace(jscene, tree, cam, JMask(JDirect(training=False,
                                                              horizon_mask=True)),
                             size=16, chunk_size=16, background=0.0,
                             key=jax.random.PRNGKey(i))
        wants[i] = np.clip(np.asarray(img), 0, 1)
    return scene, poses, wants


# views of the 16^2 scan with lit pixels (the fixed light leaves most of the
# scan's views dark on the side they see)
GEN_VIEWS = (0, 3)


@pytest.mark.parametrize("view", GEN_VIEWS)
def test_generator_render_matches_jax(view):
    scene, poses, wants = _generator_case()
    want = wants[view]
    got = make_dtu_dataset.render_view(scene, poses[view], size=16, key=view, device="cpu")
    assert got.shape == want.shape == (16, 16, 4)
    mask, jmask = got[..., 3], want[..., 3]
    assert set(np.unique(jmask)) <= {0.0, 1.0} and 0.1 < jmask.mean() < 0.9
    assert (mask == jmask).mean() >= 0.99
    both = (mask == 1) & (jmask == 1)
    diff = np.abs(got[..., :3] - want[..., :3])[both]
    assert (diff.max(-1) <= 1e-4).mean() >= 0.99
    assert want[..., :3][both].max() > 0.05                 # lit
    assert not got[..., :3][mask == 0].any()                # background 0


def _jax_mesh_scan(views, size, kind="knot", obj_scale=1.0):
    """scripts/make_dtu_dataset.py --mesh: (its PRNGKey(7) weights, the 8-bit
    images of the first ``views`` views under its 3-light ring)."""
    import make_mesh_dataset as jmm                   # scripts/make_mesh_dataset.py
    jscene = jmm.build_gt_scene(kind, light_scale=3.0, occlusion="hard",
                                obj_scale=obj_scale, material="variety")
    tree = jax.tree.map(np.asarray, jscene.init(jax.random.PRNGKey(7)))
    el = math.radians(35.0)
    rig = [1.6 * np.asarray([math.cos(el) * math.sin(a), math.sin(el),
                             math.cos(el) * math.cos(a)], np.float32)
           for a in np.linspace(0.0, 2.0 * math.pi, 3, endpoint=False)]
    _, poses, intr = _script_cameras(views, size)
    images = []
    for i in range(views):
        cam = JDTUCamera(pose=jnp.asarray(poses[i][None]), intrinsic=jnp.asarray(intr),
                         src_size=jnp.asarray([float(size), float(size)]))
        arr = None
        for loc in rig:
            p = dict(tree, lights=dict(tree["lights"], location=jnp.atleast_2d(loc)))
            img, _ = J.pathtrace(jscene, p, cam, JMask(JDirect(training=False,
                                                                horizon_mask=True)),
                                 size=size, chunk_size=size, background=0.0,
                                 key=jax.random.PRNGKey(i))
            img = np.array(img)
            if arr is None:
                arr = img
            else:
                arr[..., :3] += img[..., :3]
        images.append((np.clip(arr, 0, 1) * 255).astype(np.uint8))
    return tree, np.stack(images)


def test_mesh_option_generates(tmp_path):
    """``--mesh knot`` (with ``--obj-scale``): the scan of the triangle-mesh
    ground truth under the 3-light ring, with the JAX PRNGKey(7) weights
    equal to scripts/make_dtu_dataset.py's 8-bit images (masks equal on >=
    99% of the pixels, colours within one level on >= 99% of the pixels
    both hit: a ray through a shared edge hits by the last bit of a
    product); ``main`` writes the script's cameras and the layout
    ``load_dtu`` reads."""
    tree, want = _jax_mesh_scan(3, 16, obj_scale=1.4)
    scene = load_jax_params(make_dtu_dataset.build_scene("bunny", 3.0, mesh="knot",
                                                         obj_scale=1.4), tree, device="cpu")
    images, masks, _ = make_dtu_dataset.render_scan(scene, 3, 16, device="cpu",
                                                    rig=make_dtu_dataset.mesh_rig(),
                                                    log_fn=lambda s: None)
    jmask = want[..., 3] > 127
    mask = masks[..., 0] > 127
    assert 0.05 < jmask.mean() < 0.95 and (mask == jmask).mean() >= 0.99
    both = mask & jmask
    diff = np.abs(images.astype(int) - want[..., :3].astype(int)).max(-1)[both]
    assert (diff <= 1).mean() >= 0.99 and want[..., :3][both].max() > 20
    assert not images[~mask].any()
    out = tmp_path / "scan"
    make_dtu_dataset.main(["--out", str(out), "--mesh", "knot", "--obj-scale", "1.4",
                           "--views", "2", "--size", "12", "--device", "cpu"])
    on_disk = np.load(out / "cameras.npz")
    small, _, _ = _script_cameras(2, 12)
    assert sorted(on_disk.files) == sorted(small)
    for k in small:
        np.testing.assert_array_equal(on_disk[k], small[k], err_msg=k)
    data = TT.load_dtu(str(out), 12)
    assert data.images.shape == (2, 12, 12, 3) and 0.05 < data.masks.mean() < 0.95


def _centre_rays(cam, size):
    """(the generator's ray direction through the centre pixel of view 0,
    ``cam``'s)."""
    gen = make_dtu_dataset.render_camera(make_dtu_dataset.scan_cameras(1, size)[0][0], size)
    pos = torch.tensor([[size / 2.0, size / 2.0]])
    return (gen.sample_positions(pos, size=size)[0, 0, 0, 3:],
            cam.sample_positions(pos, size=size)[0, 0, 0, 3:])


def _degrees(a, b) -> float:
    return math.degrees(math.acos(min(1.0, float(np.dot(a, b)))))


def test_the_loaders_default_source_size_mismatches_the_generator():
    """The JAX generator writes intrinsics in units of ``size`` pixels and
    renders with ``src_size=(size, size)``; its loader scales the pixels by
    the DTU scans' 1600 x 1200 by default, so the loaded camera's rays miss
    the rendered pixels (ROADMAP.md, Queue 3).  With ``src_size=(size,
    size)`` the rays are the generator's, camera distance normalised or
    not."""
    size = 200
    _, cams = make_dtu_dataset.scan_cameras(1, size)
    imgs, masks = np.zeros((1, size, size, 3), np.float32), np.zeros((1, size, size))
    for normalize_dist in (True, False):
        default = TT.dtu_dataset(cams, imgs, masks, size, normalize_dist=normalize_dist)
        matched = TT.dtu_dataset(cams, imgs, masks, size, src_size=(size, size),
                                 normalize_dist=normalize_dist)
        cam = lambda d: DTUCamera(torch.from_numpy(d.poses), torch.from_numpy(d.intrinsics),
                                  d.src_size)
        want, got = _centre_rays(cam(default), size)
        assert _degrees(want.numpy(), got.numpy()) > 45.0
        want, got = _centre_rays(cam(matched), size)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5, rtol=0)
    # the same in the JAX package
    pos = jnp.asarray([[size / 2.0, size / 2.0]])
    ray = lambda src: np.asarray(JDTUCamera(
        pose=jnp.asarray(matched.poses), intrinsic=jnp.asarray(matched.intrinsics),
        src_size=jnp.asarray(src, jnp.float32)).sample_positions(pos, size=size))[0, 0, 0, 3:]
    want = want.numpy()
    assert _degrees(ray((1600, 1200)), want) > 45.0
    np.testing.assert_allclose(ray((size, size)), want, atol=1e-5, rtol=0)
