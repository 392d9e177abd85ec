"""Port parity: the rasterizers, blends, compositors, renderers, the
pulsar-style renderer and the mesh utility ops (``raster``).

Seeded numpy arrays go through both packages; gradients are of a seeded
weighted sum of the outputs.  The meshes are the ico mesh of
``scripts/make_mesh_dataset.py`` projected by a ``FoVPerspectiveCamera``,
with some faces listed twice in the same vertex order (exact depth ties:
the lower face index must come first, as ``lax.top_k`` orders them) and a
degenerate face; the point clouds hold repeated depths.  (A face repeated
with its vertices in another order is a tie only in exact arithmetic: XLA
on the CPU fuses some products into FMAs, so such depths differ in the
last bit between the packages, and no test builds one.)

Tolerances: ``idx`` equal, ties included; zbuf, dists, bary and the other
forward values within 1e-5 of the largest (float32 sums in another order,
FMAs in XLA); gradients within 1e-4 relative L2.  Where JAX's gradient is
not finite and torch's is (a norm at zero, ``ROADMAP.md`` Queue 3), they
are compared where JAX's is finite.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import neural_raytracing_tpu.raster as JR
from neural_raytracing_tpu.cameras import FoVPerspectiveCamera as JFoV
from neural_raytracing_tpu.cameras import look_at_view_transform as jlook_at
from neural_raytracing_tpu.raster.pulsar import _axis_angle_rotation as jrodrigues
import neural_raytracing_tpu_torch.raster as R
from neural_raytracing_tpu_torch.cameras import FoVPerspectiveCamera, look_at_view_transform
from neural_raytracing_tpu_torch.raster.pulsar import _axis_angle_rotation

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import make_mesh_dataset as jmm  # noqa: E402  (scripts/make_mesh_dataset.py)

torch.set_num_threads(1)


def _t(a, grad=False):
    return torch.tensor(np.asarray(a), requires_grad=grad)


def _close(got, want, what, scale=1e-5):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=scale * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _rel_l2(got, want, what, tol=1e-4):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    finite = np.isfinite(want)
    assert np.isfinite(got).all(), what
    err = np.linalg.norm((got - want)[finite]) / max(np.linalg.norm(want[finite]), 1e-30)
    assert err <= tol, (what, err)


def _weights(shapes, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32) for s in shapes]


def _grads(jfn, tfn, inputs, seed=0, argnums=None):
    """Forward values of both packages and the gradients of a seeded
    weighted sum of the outputs with respect to ``inputs[argnums]``."""
    argnums = tuple(range(len(inputs))) if argnums is None else argnums
    jout = jfn(*[jnp.asarray(x) for x in inputs])
    leaves = [np.asarray(o) for o in jax.tree.leaves(jout)
              if np.issubdtype(np.asarray(o).dtype, np.floating)]
    ws = _weights([x.shape for x in leaves], seed)

    def jloss(*xs):
        outs = [o for o in jax.tree.leaves(jfn(*xs)) if jnp.issubdtype(o.dtype, jnp.floating)]
        return sum(jnp.sum(o * w) for o, w in zip(outs, ws))

    jg = jax.grad(jloss, argnums=argnums)(*[jnp.asarray(x) for x in inputs])
    tin = [_t(x, grad=i in argnums and np.issubdtype(np.asarray(x).dtype, np.floating))
           for i, x in enumerate(inputs)]
    tout = tfn(*tin)
    touts = [o for o in (tout if isinstance(tout, tuple) else (tout,))
             if o is not None and o.dtype.is_floating_point]
    sum(torch.sum(o * torch.from_numpy(w)) for o, w in zip(touts, ws)).backward()
    tg = [tin[i].grad if tin[i].grad is not None else torch.zeros_like(tin[i])
          for i in argnums]
    return jout, tout, jg, tg


# ---- the mesh utility ops --------------------------------------------------------------

def _mesh_inputs(seed=0):
    rng = np.random.default_rng(seed)
    verts = rng.normal(size=(12, 3)).astype(np.float32)
    faces = rng.choice(12, size=(16, 3), replace=True).astype(np.int32)
    faces[0] = [3, 3, 4]                               # a repeated vertex
    verts[11] = 0.5 * (verts[9] + verts[10])
    faces[1] = [9, 10, 11]                             # collinear
    return verts, faces


def test_face_areas_normals_match_jax_with_degenerate_faces():
    verts, faces = _mesh_inputs()
    jout, tout, jg, tg = _grads(lambda v: JR.face_areas_normals(v, jnp.asarray(faces)),
                                lambda v: R.face_areas_normals(v, torch.from_numpy(faces)),
                                [verts])
    for g, w, what in zip(tout, jout, ("areas", "normals")):
        _close(g, w, what)
    assert float(tout[0][0].detach()) == 0.0 and float(tout[0][1].detach()) < 1e-6
    assert np.isfinite(np.asarray(jg[0])).all()          # the double where: finite in JAX
    _rel_l2(tg[0], jg[0], "d verts")


def test_interp_face_attrs_matches_jax():
    rng = np.random.default_rng(1)
    p2f = rng.integers(-1, 6, size=(5, 7, 2)).astype(np.int32)
    bary = rng.uniform(size=(5, 7, 2, 3)).astype(np.float32)
    attrs = rng.normal(size=(6, 3, 4)).astype(np.float32)
    jout, tout, jg, tg = _grads(lambda b, a: JR.interp_face_attrs(jnp.asarray(p2f), b, a),
                                lambda b, a: R.interp_face_attrs(torch.from_numpy(p2f), b, a),
                                [bary, attrs])
    _close(tout, jout, "interp")
    for g, w in zip(tg, jg):
        _rel_l2(g, w, "interp grads")


def test_packed_padded_round_trip_matches_jax():
    rng = np.random.default_rng(2)
    packed = rng.normal(size=(12, 3)).astype(np.float32)
    first = np.asarray([0, 3, 7], np.int64)            # lengths 3, 4, 5
    jout, tout, jg, tg = _grads(lambda x: JR.packed_to_padded(x, jnp.asarray(first), 4),
                                lambda x: R.packed_to_padded(x, torch.from_numpy(first), 4),
                                [packed])
    _close(tout, jout, "packed_to_padded")             # the last element cut to 4
    _rel_l2(tg[0], jg[0], "d packed")
    padded = np.asarray(JR.packed_to_padded(jnp.asarray(packed), jnp.asarray(first), 6))
    jout, tout, jg, tg = _grads(lambda x: JR.padded_to_packed(x, jnp.asarray(first), 12),
                                lambda x: R.padded_to_packed(x, torch.from_numpy(first), 12),
                                [padded])
    _close(tout, jout, "padded_to_packed")
    _close(tout, packed, "the round trip")
    _rel_l2(tg[0], jg[0], "d padded")


@pytest.mark.parametrize("directed", [False, True])
def test_gather_scatter_matches_jax(directed):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(9, 4)).astype(np.float32)
    edges = rng.integers(0, 9, size=(20, 2)).astype(np.int64)
    jout, tout, jg, tg = _grads(
        lambda v: JR.gather_scatter(v, jnp.asarray(edges), directed),
        lambda v: R.gather_scatter(v, torch.from_numpy(edges), directed), [x])
    _close(tout, jout, "gather_scatter")
    _rel_l2(tg[0], jg[0], "d inputs")


def _distance_inputs(seed=4):
    verts, faces = _mesh_inputs(seed)
    rng = np.random.default_rng(seed + 100)
    points = rng.normal(size=(30, 3)).astype(np.float32)
    points[0] = verts[faces[5, 0]]                     # on a vertex
    tris = verts[faces]
    seg_a, seg_b = tris[:, 0].copy(), tris[:, 1].copy()
    seg_b[2] = seg_a[2]                                # a degenerate segment
    seg = (np.arange(30) // 10).astype(np.int64)       # 3 meshes of a ragged batch
    tseg = (np.arange(16) * 3 // 16).astype(np.int64)
    return points, tris, seg_a, seg_b, seg, tseg


DISTANCES = [("point_triangle_dists", False), ("point_line_seg_dists", False)] + [
    (name, segmented) for name in ("point_face_distance", "face_point_distance",
                                   "point_edge_distance", "edge_point_distance")
    for segmented in (False, True)]


@pytest.mark.parametrize("name,segmented", DISTANCES)
def test_point_mesh_distances_match_jax(name, segmented):
    points, tris, seg_a, seg_b, seg, tseg = _distance_inputs()
    jf, tf = getattr(JR, name), getattr(R, name)
    prims = [tris] if "face" in name or "triangle" in name else [seg_a, seg_b]
    extra = (seg, tseg) if segmented else ()
    jout, tout, jg, tg = _grads(
        lambda *xs: jf(*xs, *[jnp.asarray(e) for e in extra]),
        lambda *xs: tf(*xs, *[torch.from_numpy(e) for e in extra]), [points, *prims])
    if isinstance(jout, tuple):
        _close(tout[0], jout[0], name)
        np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
    else:
        _close(tout, jout, name)
    for g, w in zip(tg, jg):
        _rel_l2(g, w, f"{name} grads")


# ---- the rasterizers ------------------------------------------------------------------

def _camera_pair(dist=1.0, elev=20.0, azim=30.0):
    jr, jt = jlook_at(dist=dist, elev=elev, azim=azim)
    r, t = look_at_view_transform(dist=dist, elev=elev, azim=azim)
    return JFoV(R=jr, T=jt), FoVPerspectiveCamera(R=r, T=t)


def _screen_mesh():
    """The ico mesh in (x_ndc, y_ndc, z_view), faces 0-19 repeated at the end
    (exact ties) and a degenerate face."""
    verts, faces = jmm.MESHES["ico"]()
    _, cam = _camera_pair()
    screen = R.transform_points_screen(cam, torch.from_numpy(verts)).numpy()
    faces = np.concatenate([faces, faces[:20], [[5, 5, 7]]]).astype(np.int32)
    return screen, faces


MESH_CASES = {
    "naive": {}, "binned": dict(bin_size=8), "blur": dict(blur_radius=2e-3),
    "cull": dict(cull_backfaces=True), "binned_blur": dict(bin_size=8, blur_radius=2e-3),
}


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_rasterize_meshes_matches_jax(case):
    verts, faces = _screen_mesh()
    kw = dict(image_size=(20, 28), faces_per_pixel=4, chunk=256, **MESH_CASES[case])
    jout, tout, jg, tg = _grads(
        lambda v: JR.rasterize_meshes(v, jnp.asarray(faces), **kw),
        lambda v: R.rasterize_meshes(v, torch.from_numpy(faces), **kw), [verts], seed=5)
    np.testing.assert_array_equal(tout.idx.numpy(), np.asarray(jout.idx))
    idx = tout.idx.numpy()
    assert 0.3 < (idx[..., 0] >= 0).mean() < 0.9 and (idx[..., 1] >= 0).any()
    # a repeated face ties with its first copy, which comes first
    copies = np.argwhere((idx >= 1280) & (idx < 1300))
    for y, x, k in copies:
        assert idx[y, x, k] - 1280 in idx[y, x, :k], (y, x, idx[y, x])
    assert len(copies) or case in ("blur", "binned_blur", "cull")
    for field in ("zbuf", "dists", "bary"):
        _close(getattr(tout, field), getattr(jout, field), f"{case}: {field}")
    _rel_l2(tg[0], jg[0], f"{case}: d verts")


def test_binned_matches_naive_and_drops_past_the_capacity():
    """1,500 small faces in one corner: the default capacity max(1024, F // 5)
    keeps the first 1,024 a tile and drops the rest, in both packages; with
    room for all, the binned pass is the naive one."""
    rng = np.random.default_rng(6)
    n = 1500
    centre = np.concatenate([rng.uniform(0.3, 0.9, (n, 2)), rng.uniform(1.0, 3.0, (n, 1))], -1)
    verts = (centre[:, None, :] + np.concatenate(
        [rng.uniform(-0.15, 0.15, (n, 3, 2)), np.zeros((n, 3, 1))], -1)).reshape(-1, 3)
    verts = verts.astype(np.float32)
    faces = np.arange(3 * n, dtype=np.int32).reshape(n, 3)
    kw = dict(image_size=16, faces_per_pixel=3)
    want = {}
    for name, extra in (("default", dict(bin_size=8)), ("small", dict(bin_size=8,
                                                                       max_faces_per_bin=40)),
                        ("all", dict(bin_size=8, max_faces_per_bin=n)), ("naive", {})):
        j = JR.rasterize_meshes(jnp.asarray(verts), jnp.asarray(faces), **kw, **extra)
        t = R.rasterize_meshes(torch.from_numpy(verts), torch.from_numpy(faces), **kw, **extra)
        np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx), err_msg=name)
        _close(t.zbuf, j.zbuf, name)
        want[name] = t.idx.numpy()
    np.testing.assert_array_equal(want["all"], want["naive"])
    for name, cap in (("default", 1024), ("small", 40)):
        assert not np.array_equal(want[name], want["naive"]), name
        assert want[name].max() < cap, name            # only the first faces a tile


@pytest.mark.parametrize("radius", ["scalar", "array"])
def test_rasterize_points_and_spheres_match_jax(radius):
    rng = np.random.default_rng(7)
    pts = np.concatenate([rng.uniform(-1, 1, (300, 2)), rng.uniform(-0.2, 2, (300, 1))], -1)
    pts[100:140, 2] = pts[60:100, 2]                   # repeated depths: ties
    pts = pts.astype(np.float32)
    rad = (np.float32(0.2) if radius == "scalar"
           else rng.uniform(0.0, 0.3, 300).astype(np.float32))
    kw = dict(image_size=(12, 20), points_per_pixel=6, chunk=64)
    jout, tout, jg, tg = _grads(lambda p: JR.rasterize_points(p, radius=jnp.asarray(rad), **kw),
                                lambda p: R.rasterize_points(p, radius=torch.tensor(rad), **kw),
                                [pts], seed=8)
    np.testing.assert_array_equal(tout.idx.numpy(), np.asarray(jout.idx))
    assert (tout.idx.numpy()[..., -1] >= 0).any() and tout.bary is None
    for field in ("zbuf", "dists"):
        _close(getattr(tout, field), getattr(jout, field), field)
    _rel_l2(tg[0], jg[0], "d points")
    spheres = np.concatenate([pts, np.broadcast_to(rad, (300,))[:, None]], -1)
    jout, tout, jg, tg = _grads(lambda s: JR.rasterize_spheres(s, **kw),
                                lambda s: R.rasterize_spheres(s, **kw), [spheres], seed=9)
    np.testing.assert_array_equal(tout.idx.numpy(), np.asarray(jout.idx))
    _close(tout.dists, jout.dists, "spheres")
    _rel_l2(tg[0], jg[0], "d spheres")


def test_pix_to_ndc_is_the_reference_convention():
    got = R.pix_to_ndc(torch.arange(4.0), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JR.rasterize.pix_to_ndc(
        jnp.arange(4.0), 4)))
    assert got[0] == 0.75 and got[-1] == -0.75


# ---- blends, compositors, renderers -----------------------------------------------------

def _fragments(seed=10):
    rng = np.random.default_rng(seed)
    idx = rng.integers(-1, 6, size=(6, 7, 4)).astype(np.int64)
    idx[0, 0] = -1                                     # an empty pixel
    zbuf = np.sort(rng.uniform(1.0, 10.0, (6, 7, 4)), -1).astype(np.float32)
    dists = rng.normal(scale=2e-4, size=(6, 7, 4)).astype(np.float32)
    return idx, zbuf, dists


@pytest.mark.parametrize("blend", ["hard_rgb_blend", "sigmoid_alpha_blend",
                                   "softmax_rgb_blend"])
def test_blends_match_jax(blend):
    idx, zbuf, dists = _fragments()
    colors = np.random.default_rng(11).uniform(size=(6, 7, 4, 3)).astype(np.float32)

    def call(mod, frag, c, z, d, i):
        f = frag(idx=i, zbuf=z, dists=d)
        if blend == "sigmoid_alpha_blend":
            return getattr(mod, blend)(f, sigma=1e-4)
        kw = dict(background=(0.2, 0.3, 0.4))
        if blend == "softmax_rgb_blend":
            kw.update(sigma=1e-4, gamma=0.05)
        return getattr(mod, blend)(c, f, **kw)

    jout, tout, jg, tg = _grads(
        lambda c, z, d: call(JR, JR.Fragments, c, z, d, jnp.asarray(idx)),
        lambda c, z, d: call(R, R.Fragments, c, z, d, torch.from_numpy(idx)),
        [colors, zbuf, dists], seed=12)
    _close(tout, jout, blend)
    for g, w, what in zip(tg, jg, ("colors", "zbuf", "dists")):
        _rel_l2(g, w, f"{blend}: d {what}")


@pytest.mark.parametrize("name", ["alpha_composite", "weighted_sum", "norm_weighted_sum"])
def test_compositors_match_jax(name):
    idx, _, _ = _fragments(13)
    rng = np.random.default_rng(14)
    feats = rng.normal(size=(6, 5)).astype(np.float32)
    alphas = rng.uniform(size=idx.shape).astype(np.float32)
    jout, tout, jg, tg = _grads(
        lambda f, a: getattr(JR, name)(f, a, jnp.asarray(idx)),
        lambda f, a: getattr(R, name)(f, a, torch.from_numpy(idx)), [feats, alphas], seed=15)
    _close(tout, jout, name)
    for g, w in zip(tg, jg):
        _rel_l2(g, w, f"{name} grads")


def test_renderers_match_jax():
    jcam, cam = _camera_pair(dist=2.0, elev=10.0, azim=-40.0)
    verts, faces = jmm.MESHES["gear"]()
    settings = dict(image_size=24, faces_per_pixel=3, points_per_pixel=3, blur_radius=1e-4)
    for extra in ({}, dict(bin_size=8)):
        jras = JR.MeshRasterizer(cameras=jcam, raster_settings=JR.RasterizationSettings(
            **settings, **extra))
        ras = R.MeshRasterizer(raster_settings=R.RasterizationSettings(**settings, **extra))
        j = jras(jnp.asarray(verts), jnp.asarray(faces))
        t = ras(torch.from_numpy(verts), torch.from_numpy(faces), cameras=cam)
        np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
        for field in ("zbuf", "dists", "bary"):
            _close(getattr(t, field), getattr(j, field), f"mesh {extra}: {field}")
        assert 0.1 < (t.idx.numpy()[..., 0] >= 0).mean() < 0.9
    radii = np.random.default_rng(16).uniform(0.05, 0.2, len(verts)).astype(np.float32)
    j = JR.PointsRasterizer(jcam, JR.RasterizationSettings(**settings))(jnp.asarray(verts),
                                                                        radius=0.1)
    t = R.PointsRasterizer(cam, R.RasterizationSettings(**settings))(torch.from_numpy(verts),
                                                                     radius=0.1)
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
    _close(t.zbuf, j.zbuf, "points")
    j = JR.SpheresRasterizer(jcam, JR.RasterizationSettings(**settings))(
        jnp.asarray(verts), jnp.asarray(radii))
    t = R.SpheresRasterizer(cam, R.RasterizationSettings(**settings))(
        torch.from_numpy(verts), torch.from_numpy(radii))
    assert isinstance(t, R.SphereFragments)
    np.testing.assert_array_equal(t.idx.numpy(), np.asarray(j.idx))
    _close(t.dists, j.dists, "spheres")
    with pytest.raises(ValueError, match="Cameras"):
        R.PointsRasterizer()(torch.from_numpy(verts))


# ---- the pulsar-style renderer -----------------------------------------------------------

@pytest.mark.parametrize("rvec", [(0.0, 0.0, 0.0), (0.1, -0.2, 0.05), (3e-7, 0.0, -2e-7)])
def test_axis_angle_rotation_matches_jax(rvec):
    r = np.asarray(rvec, np.float32)
    jout, tout, jg, tg = _grads(jrodrigues, _axis_angle_rotation, [r], seed=17)
    _close(tout, jout, "rotation", scale=1e-6)
    assert np.isfinite(np.asarray(jg[0])).all()
    _rel_l2(tg[0], jg[0], "d rvec")


@pytest.mark.parametrize("ortho", [False, True])
@pytest.mark.parametrize("rvec", [(0.0, 0.0, 0.0), (0.05, 0.1, -0.03)])
def test_pulsar_matches_jax(ortho, rvec):
    rng = np.random.default_rng(18)
    pos = np.concatenate([rng.uniform(-0.6, 0.6, (40, 2)), rng.uniform(2.0, 5.0, (40, 1))],
                         -1).astype(np.float32)
    col = rng.uniform(size=(40, 3)).astype(np.float32)
    rad = rng.uniform(0.05, 0.25, 40).astype(np.float32)
    op = rng.uniform(0.3, 1.0, 40).astype(np.float32)
    cam = np.asarray([0.0, 0.0, 0.0, *rvec, 1.5, 2.0], np.float32)
    kw = dict(gamma=0.1, max_depth=4.5, min_depth=0.0)
    bg = np.asarray([0.1, 0.2, 0.3], np.float32)
    jr = JR.PulsarRenderer(16, 12, orthogonal_projection=ortho)
    tr = R.PulsarRenderer(16, 12, orthogonal_projection=ortho)
    jout, tout, jg, tg = _grads(
        lambda p, c, r, cp, o: jr(p, c, r, cp, bg_col=jnp.asarray(bg), opacity=o, **kw),
        lambda p, c, r, cp, o: tr(p, c, r, cp, bg_col=torch.from_numpy(bg), opacity=o, **kw),
        [pos, col, rad, cam, op], seed=19)
    _close(tout, jout, "pulsar")
    assert tout.shape == (12, 16, 3) and tout.std() > 0.01
    for g, w, what in zip(tg, jg, ("pos", "col", "rad", "cam_params", "opacity")):
        _rel_l2(g, w, f"pulsar d {what}")
    assert tg[3][3:6].abs().sum() > 0                  # the rotation's gradient, at 0 too
