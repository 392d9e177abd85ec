"""Port parity: triangle meshes (``load_obj``, ``TriangleMesh`` on both
backends), the native host ops and ``ops.geometry``.

The meshes are the unit right tetrahedron of ``tests/test_mesh_native.py``
(chunk 4, and 256: one chunk of padding) and the ico mesh of
``scripts/make_mesh_dataset.py`` (1,280 faces, 5 chunks of 256), hit by
seeded rays aimed at the mesh (most hit) and rays aimed away (all miss).
Seeded numpy arrays go through both packages.  Tolerances: t, p, n, wi
within 1e-5 (float32 sums in another order), hit flags and the shadow
test's flags equal; the native ops the same bits as the JAX package's
(the same source, flags and compiler), where the JAX package's library
loads.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neural_raytracing_tpu.ops import geometry as jgeo
from neural_raytracing_tpu.shapes.mesh import TriangleMesh as JMesh
from neural_raytracing_tpu.shapes.mesh import load_obj as jload_obj
import neural_raytracing_tpu_torch as T
from neural_raytracing_tpu_torch import native
from neural_raytracing_tpu_torch.ops import geometry
from neural_raytracing_tpu_torch.shapes import TriangleMesh, load_obj
from neural_raytracing_tpu_torch.workloads import make_mesh_dataset

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import make_mesh_dataset as jmm  # noqa: E402  (scripts/make_mesh_dataset.py)

torch.set_num_threads(1)
TETRA = (np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32),
         np.asarray([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int32))


def _ico():
    return jmm.MESHES["ico"]()


def _rays(verts, n=384, seed=0):
    """``n`` rays from a shell of radius 3 around the mesh: the first two
    thirds aimed near its centre (most hit), the rest aimed away (miss)."""
    rng = np.random.default_rng(seed)
    centre = verts.mean(0)
    o = rng.normal(size=(n, 3))
    o = centre + 3.0 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    target = centre + 0.3 * rng.normal(size=(n, 3))
    d = target - o
    d[2 * n // 3:] = -d[2 * n // 3:]
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.concatenate([o, d], -1).astype(np.float32).reshape(n // 16, 16, 6)


MESHES = {"tetra4": (TETRA, 4), "tetra256": (TETRA, 256), "ico": (None, 256)}


def _mesh_pair(name, backend="torch"):
    (verts, faces), chunk = MESHES[name] if MESHES[name][0] else (_ico(), 256)
    jbackend = "jax" if backend == "torch" else backend
    return (JMesh(verts, faces, chunk=chunk, backend=jbackend),
            TriangleMesh(verts, faces, chunk=chunk, backend=backend), verts)


def _close(got, want, atol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("backend", ["torch", "native"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_intersect_matches_jax(name, backend):
    if backend == "native" and not native.available():
        pytest.skip("the host compiler did not build the native library")
    jmesh, mesh, verts = _mesh_pair(name, backend)
    rays = _rays(verts)
    jit, jhit = jmesh.intersect({}, jnp.asarray(rays))
    it, hit = mesh.intersect(torch.from_numpy(rays), primary=False, generator=None)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    assert 0.3 < hit.float().mean().item() < 0.7
    for field in ("t", "p", "n", "wi"):
        _close(getattr(it, field), getattr(jit, field))
    _close(it.frame, jit.frame)


@pytest.mark.parametrize("backend", ["torch", "native"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_intersect_test_matches_jax(name, backend):
    if backend == "native" and not native.available():
        pytest.skip("the host compiler did not build the native library")
    jmesh, mesh, verts = _mesh_pair(name, backend)
    rays = _rays(verts, seed=1)
    max_t = np.random.default_rng(2).uniform(1.0, 5.0, rays.shape[:-1]).astype(np.float32)
    for mt in (10.0, max_t):
        want = np.asarray(jmesh.intersect_test({}, jnp.asarray(rays), max_t=jnp.asarray(mt)))
        got = mesh.intersect_test(torch.from_numpy(rays), max_t=torch.as_tensor(mt),
                                  active=None)
        np.testing.assert_array_equal(got.numpy(), want)
    assert 0.05 < (~got).float().mean().item() < 0.95     # some blocked, some free


def test_first_face_wins_a_tie():
    """A face listed twice: the hit reports the first, as ``jnp.argmin``."""
    verts, faces = TETRA
    twice = np.concatenate([faces, faces[::-1]])
    jmesh, mesh = JMesh(verts, twice, chunk=3), TriangleMesh(verts, twice, chunk=3)
    rays = _rays(verts, n=96, seed=3)
    _, i, _ = mesh._scan_min(torch.from_numpy(rays[..., :3]), torch.from_numpy(rays[..., 3:]),
                             1e10)
    _, ji, _ = jmesh._scan_min(jnp.asarray(rays[..., :3]), jnp.asarray(rays[..., 3:]), 1e10)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    assert (i.numpy() < 4).all()


def test_the_mesh_has_no_state():
    """No parameters and an empty state dict (JAX's ``init`` is ``{}``), so
    the scene artifacts and ``load_jax_params`` see an empty shape tree."""
    scene = T.Scene(shape=TriangleMesh(*TETRA), occlusion="hard")
    assert scene.state_dict() == {} and not list(scene.parameters())
    T.load_jax_params(scene, {"shape": {}}, device="cpu")
    assert {n for n, _ in scene.named_buffers()} == {"shape.verts", "shape.faces",
                                                      "shape.tris"}
    with pytest.raises(ValueError, match="backend"):
        TriangleMesh(*TETRA, backend="jax")


def test_load_obj_matches_jax(tmp_path):
    """Fans, ``v/vt/vn`` and ``v//vn`` tokens, negative indices, comments."""
    path = tmp_path / "m.obj"
    path.write_text(
        "# a quad, a pentagon and a triangle by negative index\n"
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvn 0 0 1\n"
        "f 1/1/1 2/1/1 3/1/1 4/1/1\n\n"
        "v 0 0 1\nv 1 0 1.5\nv 1 1 1\n"
        "f 5//1 6//1 7//1 3 2\n"
        "f -1 -2 -3\n")
    got, want = load_obj(str(path)), jload_obj(str(path))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[1].shape == (6, 3)
    mesh = TriangleMesh.from_obj(str(path), chunk=4)
    np.testing.assert_array_equal(mesh.verts.numpy(), want[0])


# ---- the native host ops --------------------------------------------------------------

def _jax_native():
    from neural_raytracing_tpu import native as jnative
    if not jnative.available():
        pytest.skip("the JAX package's native library does not load here")
    return jnative


def test_native_ops_give_the_jax_packages_bits():
    jnative = _jax_native()
    verts, faces = _ico()
    rays = _rays(verts).reshape(-1, 6)
    rng = np.random.default_rng(4)
    max_t = rng.uniform(1.0, 5.0, len(rays)).astype(np.float32)
    pairs = [
        (jnative.mesh_intersect(rays, verts, faces, 1e10),
         native.mesh_intersect(torch.from_numpy(rays), verts, faces, 1e10)),
        (jnative.mesh_intersect(rays, verts, faces, 2.5),
         native.mesh_intersect(rays, torch.from_numpy(verts), faces, 2.5)),
        ((jnative.mesh_intersect_test(rays, verts, faces, max_t),),
         (native.mesh_intersect_test(rays, verts, torch.from_numpy(faces), max_t),)),
        ((jnative.mesh_intersect_test(rays, verts, faces, 3.0),),
         (native.mesh_intersect_test(rays, verts, faces, 3.0),)),
        (jnative.knn(verts, rays[:, :3], 5), native.knn(verts, rays[:, :3], 5)),
        ((jnative.ray_point_min_dist(rays, verts),),
         (native.ray_point_min_dist(rays, verts),)),
    ]
    for want, got in pairs:
        for w, g in zip(want, got):
            assert g.dtype == torch.from_numpy(np.asarray(w)).dtype
            np.testing.assert_array_equal(g.numpy(), w)
    hit = pairs[0][1][4]
    assert 0.3 < hit.float().mean().item() < 0.7


def test_native_build_is_named_by_its_source_and_flags():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR and path.name.startswith("libnrt_native-")
    assert native.SRC.parent.name == "csrc" and native.SRC.parent.parent.name == (
        "neural_raytracing_tpu_torch")
    assert native.available() and native.build() == path and path.exists()


# ---- ops.geometry -----------------------------------------------------------------------

def _geometry_inputs(seed=5):
    rng = np.random.default_rng(seed)
    r_o = rng.normal(size=(6, 7, 3)).astype(np.float32)
    r_d = rng.normal(size=(6, 7, 3)).astype(np.float32)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    seg_a = rng.normal(size=(30, 3)).astype(np.float32)
    seg_b = seg_a + rng.normal(size=(30, 3)).astype(np.float32)
    seg_b[3] = seg_a[3]                      # a degenerate segment
    seg_b[4] = seg_a[4] + 0.5 * r_d[0, 0]    # one parallel to a ray
    return r_o, r_d, pts, seg_a, seg_b


def test_geometry_matches_jax():
    r_o, r_d, pts, seg_a, seg_b = _geometry_inputs()
    t = lambda a: torch.from_numpy(a)
    _close(geometry.ray_point_dist(t(r_o), t(r_d), t(pts)),
           jgeo.ray_point_dist(r_o, r_d, pts))
    _close(geometry.distance_between_rays_and_segments(t(r_o), t(r_d), t(seg_a), t(seg_b)),
           jgeo.distance_between_rays_and_segments(r_o, r_d, seg_a, seg_b))
    verts, faces = _ico()
    for chunk in (256, 1000):
        _close(geometry.mesh_level_surfaces(t(r_o), t(r_d), t(verts), t(faces), chunk=chunk),
               jgeo.mesh_level_surfaces(jnp.asarray(r_o), jnp.asarray(r_d),
                                        jnp.asarray(verts), jnp.asarray(faces), chunk=chunk))


def test_the_ray_point_distance_agrees_with_the_native_op():
    verts, _ = _ico()
    rays = _rays(verts, n=64).reshape(-1, 6)
    got = geometry.ray_point_dist(torch.from_numpy(rays[:, :3]), torch.from_numpy(rays[:, 3:]),
                                  torch.from_numpy(verts)).amin(-1)
    np.testing.assert_allclose(got.numpy(), native.ray_point_min_dist(rays, verts).numpy(),
                               rtol=1e-5, atol=1e-5)


def test_the_twins_meshes_are_the_scripts():
    for kind in sorted(jmm.MESHES):
        for g, w in zip(make_mesh_dataset.MESHES[kind](), jmm.MESHES[kind]()):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert _ico()[1].shape == (1280, 3)
