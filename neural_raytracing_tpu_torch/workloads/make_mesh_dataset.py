"""Dataset generation: ground truth whose geometry is a triangle mesh.

The twin of ``scripts/make_mesh_dataset.py`` of the JAX package.  The
procedural meshes (nothing is downloaded) are rendered through
``TriangleMesh``:
  * ``knot``: a trefoil-knot tube (genus 1, a thin curved tube);
  * ``ico``: a displaced icosphere (lumpy, faceted creases);
  * ``gear``: an extruded star prism (flat faces, sharp edges);
  * ``blocks``: stacked boxes (ledges that shadow themselves).
``build_gt_scene`` puts a mesh under ``ComposeSpatialVarying`` (two
``Diffuse`` lobes and a ``Conductor``, or the five-lobe ``variety``
palette) mixed by a small plain weight net, ``PointLights`` and hard
shadows; ``--mirror-plate R`` adds a conductor plate of half-extent R under
the object, which ``_ZGate`` makes a mirror.  The ground truth renders with
``Mask(Direct(training=False, horizon_mask=True))``, or with ``--gt-bounces
N >= 2`` with ``Mask(Path(max_depth=N, ...))`` averaged over ``--gt-spp``
passes (pass ``s`` seeded ``1 + s``).  ``--light-scale 0`` sets the light
so the 99.5th percentile of the lit pixels of two probe views lands at 0.85.

Formats: ``nerf`` (``transforms_{train,test}.json`` and RGBA frames under
a static rig of ``--n-lights`` point lights), ``nerv`` (the
``{split}_point/`` layout of ``make_nerv_dataset``, a light a frame near
the camera's direction) and ``colocate`` (the ``{kind}_{i}_{j}.png`` grid
with the light at the camera, and with ``--relight`` the relight grid).

    python -m neural_raytracing_tpu_torch.workloads.make_mesh_dataset \
        --out outputs/gear_mirror --kind gear --format nerv --size 200 \
        --cam-dist 2.0 --up z --elev-range 8 55 --mirror-plate 0.7 --gt-bounces 2

``run`` returns the images as numpy arrays (uint8, what the PNGs hold), so
a caller on the card needs no PIL; ``main`` writes them and ``meta.json``.
The weight net is drawn from a seeded ``torch.Generator`` (the JAX script
draws it from ``PRNGKey(7)``); ``build_gt_scene`` followed by
``load_jax_params`` renders with the JAX draw.  ``--device`` picks the card
(default) or the CPU.
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Optional

import numpy as np
import torch
from torch import nn

from ._common import base_parser, chunk_for, device_of

SEED = 7                       # the weight net's draw (the JAX script's PRNGKey(7))
CAMERA_ANGLE_X = math.radians(60.0)
NERF_LIGHT = np.asarray([1.6, 2.2, 1.4], np.float32)


def trefoil_knot(rings: int = 160, segments: int = 20, tube_radius: float = 0.10,
                 scale: float = 0.12):
    """A trefoil-knot tube by Frenet frames -> (verts, faces)."""
    t = np.linspace(0.0, 2.0 * np.pi, rings, endpoint=False)
    c = np.stack([np.sin(t) + 2.0 * np.sin(2.0 * t),
                  np.cos(t) - 2.0 * np.cos(2.0 * t),
                  -np.sin(3.0 * t)], axis=-1) * scale
    dc = np.stack([np.cos(t) + 4.0 * np.cos(2.0 * t),
                   -np.sin(t) + 4.0 * np.sin(2.0 * t),
                   -3.0 * np.cos(3.0 * t)], axis=-1)
    ddc = np.stack([-np.sin(t) - 8.0 * np.sin(2.0 * t),
                    -np.cos(t) + 8.0 * np.cos(2.0 * t),
                    9.0 * np.sin(3.0 * t)], axis=-1)
    tang = dc / np.linalg.norm(dc, axis=-1, keepdims=True)
    nrm = ddc - np.sum(ddc * tang, -1, keepdims=True) * tang
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    binrm = np.cross(tang, nrm)

    phi = np.linspace(0.0, 2.0 * np.pi, segments, endpoint=False)
    ring = (np.cos(phi)[None, :, None] * nrm[:, None, :]
            + np.sin(phi)[None, :, None] * binrm[:, None, :])
    verts = (c[:, None, :] + tube_radius * ring).reshape(-1, 3)
    faces = []
    for i in range(rings):
        for j in range(segments):
            a = i * segments + j
            b = i * segments + (j + 1) % segments
            c2 = ((i + 1) % rings) * segments + j
            d = ((i + 1) % rings) * segments + (j + 1) % segments
            faces.append([a, b, d])
            faces.append([a, d, c2])
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def icosphere(subdiv: int = 3):
    """The unit icosphere -> (verts, faces)."""
    p = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.asarray([
        [-1, p, 0], [1, p, 0], [-1, -p, 0], [1, -p, 0],
        [0, -1, p], [0, 1, p], [0, -1, -p], [0, 1, -p],
        [p, 0, -1], [p, 0, 1], [-p, 0, -1], [-p, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=-1, keepdims=True)
    faces = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        cache, new_faces = {}, []
        verts = list(verts)

        def midpoint(a, b):
            k = (min(a, b), max(a, b))
            if k not in cache:
                m = (np.asarray(verts[a]) + np.asarray(verts[b])) / 2.0
                verts.append(m / np.linalg.norm(m))
                cache[k] = len(verts) - 1
            return cache[k]

        for f in faces:
            a, b, c = int(f[0]), int(f[1]), int(f[2])
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(verts)
        faces = np.asarray(new_faces, np.int64)
    return verts, faces


def displaced_icosphere(subdiv: int = 3, base_r: float = 0.38, amp: float = 0.18):
    """A lumpy icosphere: radial displacement by angular waves."""
    v, f = icosphere(subdiv)
    x, y, z = v[:, 0], v[:, 1], v[:, 2]
    disp = (np.sin(4.0 * np.arctan2(y, x)) * np.sin(3.0 * np.arccos(np.clip(z, -1, 1)))
            + 0.5 * np.cos(7.0 * x) * np.sin(6.0 * y))
    r = base_r * (1.0 + amp * disp)
    return (v * r[:, None]).astype(np.float32), f.astype(np.int32)


def star_prism(teeth: int = 9, r_outer: float = 0.50, r_inner: float = 0.28,
               half_height: float = 0.18):
    """An extruded star polygon: flat faces and sharp edges."""
    n = 2 * teeth
    ang = np.arange(n) * (2.0 * np.pi / n)
    rad = np.where(np.arange(n) % 2 == 0, r_outer, r_inner)
    ring = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=-1)
    top = np.concatenate([ring, np.full((n, 1), half_height)], axis=-1)
    bot = np.concatenate([ring, np.full((n, 1), -half_height)], axis=-1)
    verts = np.concatenate([top, bot, [[0, 0, half_height]], [[0, 0, -half_height]]], axis=0)
    ci_t, ci_b = 2 * n, 2 * n + 1
    faces = []
    for i in range(n):
        j = (i + 1) % n
        faces.append([ci_t, i, j])                       # the top cap
        faces.append([ci_b, n + j, n + i])               # the bottom cap
        faces.append([i, n + i, n + j])                  # a side
        faces.append([i, n + j, j])
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def _box_tris(center, half):
    """An axis-aligned box -> 12 triangles wound outwards."""
    cx, cy, cz = center
    hx, hy, hz = half
    v = np.asarray([[cx + sx * hx, cy + sy * hy, cz + sz * hz]
                    for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)], np.float32)
    # vertex index 4 sx + 2 sy + sz, s in {0, 1}; quads counter-clockwise
    # seen from outside: -x, +x, -y, +y, -z, +z
    quads = [(0, 1, 3, 2), (4, 6, 7, 5), (0, 4, 5, 1), (2, 3, 7, 6), (0, 2, 6, 4),
             (1, 5, 7, 3)]
    f = []
    for a, b, c, d in quads:
        f += [[a, b, c], [a, c, d]]
    return v, np.asarray(f, np.int32)


def blocks(scale: float = 1.0):
    """A blocky multi-part structure: slabs, a cabin with a roof, a chimney,
    four corner posts and a crate."""
    parts = [
        ((0.00, 0.00, -0.28), (0.50, 0.34, 0.10)),   # the base slab
        ((0.00, 0.00, -0.08), (0.36, 0.26, 0.12)),   # the mid deck
        ((-0.10, 0.00, 0.16), (0.22, 0.20, 0.14)),   # the cabin
        ((-0.10, 0.00, 0.36), (0.26, 0.24, 0.045)),  # the roof's overhang
        ((0.30, 0.12, 0.10), (0.055, 0.055, 0.30)),  # the chimney
        ((0.44, 0.28, -0.10), (0.06, 0.06, 0.22)),   # the corner posts
        ((0.44, -0.28, -0.10), (0.06, 0.06, 0.22)),
        ((-0.44, 0.28, -0.10), (0.06, 0.06, 0.22)),
        ((-0.44, -0.28, -0.10), (0.06, 0.06, 0.22)),
        ((0.16, -0.16, 0.14), (0.09, 0.09, 0.09)),   # a crate on the deck
    ]
    verts, faces, off = [], [], 0
    for center, half in parts:
        v, f = _box_tris(center, half)
        verts.append(v * scale)
        faces.append(f + off)
        off += len(v)
    return np.concatenate(verts, axis=0), np.concatenate(faces, axis=0).astype(np.int32)


MESHES = {"knot": trefoil_knot, "ico": displaced_icosphere, "gear": star_prism,
          "blocks": blocks}


def c2w_up(elev_deg, azim_deg, dist, up="y"):
    """Camera-to-world ``[4, 4]`` at (elev, azim, dist) with the world's up
    axis ``up``: ``"y"`` is ``cameras.nerf_c2w``'s orbit, ``"z"`` orbits the
    upper hemisphere of the z-up meshes and light rig."""
    from ..cameras import nerf_c2w
    if up == "y":
        return nerf_c2w(elev_deg, azim_deg, dist)
    e, a = math.radians(elev_deg), math.radians(azim_deg)
    pos = np.asarray([dist * math.cos(e) * math.cos(a), dist * math.cos(e) * math.sin(a),
                      dist * math.sin(e)])
    forward = pos / np.linalg.norm(pos)              # the camera's +z (it looks down -z)
    right = np.cross([0.0, 0.0, 1.0], forward)
    right = right / max(np.linalg.norm(right), 1e-9)
    upv = np.cross(forward, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = upv
    m[:3, 2] = forward
    m[:3, 3] = pos
    return m


class _ZGate(nn.Module):
    """The weight net under a gate: below ``z0`` the LAST lobe (the
    Conductor) is forced on and the others off, so the plate under the
    object is a mirror.

    The gate owns no parameter: it shares the inner net's registries, so
    its state dict is the net's, as the JAX ``_ZGate.init`` returns the
    inner net's params.
    """

    def __init__(self, inner: nn.Module, z0: float, sharp: float = 400.0):
        super().__init__()
        object.__setattr__(self, "inner", inner)     # not a child: its registries below
        self._parameters = inner._parameters
        self._buffers = inner._buffers
        self._non_persistent_buffers_set = inner._non_persistent_buffers_set
        self._modules = inner._modules
        self.z0 = float(z0)
        self.sharp = float(sharp)

    def reset_parameters(self, generator: torch.Generator):
        self.inner.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        logits = self.inner(x)
        below = torch.sigmoid((self.z0 - x[..., 2:3]) * self.sharp)
        k = logits.shape[-1]
        push = torch.tensor([-12.0] * (k - 1) + [12.0], dtype=logits.dtype,
                            device=logits.device)
        return logits * (1.0 - below) + push * below


def gt_mesh(kind: str, obj_scale: float = 1.0, mirror_plate: float = 0.0):
    """-> (verts, faces, the plate's top z or None): the ``kind`` mesh scaled
    by ``obj_scale``, with the plate's box appended under it when
    ``mirror_plate > 0``."""
    verts, faces = MESHES[kind]()
    verts = verts * np.float32(obj_scale)
    plate_top = None
    if mirror_plate > 0.0:
        plate_top = float(verts[:, 2].min()) - 0.005
        pv, pf = _box_tris((0.0, 0.0, plate_top - 0.03), (mirror_plate, mirror_plate, 0.03))
        faces = np.concatenate([faces, pf + len(verts)], axis=0).astype(np.int32)
        verts = np.concatenate([verts, pv], axis=0)
    return verts, faces, plate_top


def build_gt_scene(kind: str, light_scale: float, occlusion: str = "hard",
                   obj_scale: float = 1.0, material: str = "default",
                   mirror_plate: float = 0.0):
    """The ground-truth scene (the weight net random until initialised or
    loaded).  ``mirror_plate > 0`` appends a square conductor plate of that
    half-extent just under the object: with a delta light the mirror adds
    light only through secondary bounces, which ``Direct`` cannot carry."""
    from .. import Scene
    from ..bsdf import ComposeSpatialVarying, Conductor, Diffuse
    from ..lights import PointLights
    from ..nn import SkipConnMLP
    from ..shapes import TriangleMesh

    verts, faces, plate_top = gt_mesh(kind, obj_scale, mirror_plate)
    if material == "variety":
        # a bright multi-hue palette with a sharper assignment net
        bsdfs = [Diffuse((0.85, 0.72, 0.25)), Diffuse((0.78, 0.22, 0.18)),
                 Diffuse((0.25, 0.55, 0.85)), Diffuse((0.45, 0.78, 0.35)), Conductor()]
        sp_var = SkipConnMLP(in_size=3, out=len(bsdfs), num_layers=2, hidden_size=32,
                             freqs=16, sigma=16.0)
    else:
        bsdfs = [Diffuse((0.7, 0.3, 0.2)), Diffuse((0.2, 0.4, 0.7)), Conductor()]
        sp_var = SkipConnMLP(in_size=3, out=len(bsdfs), num_layers=2, hidden_size=32,
                             freqs=8, sigma=8.0)
    if plate_top is not None:
        # the gate forces the last lobe, the Conductor in both palettes
        assert isinstance(bsdfs[-1], Conductor)
        sp_var = _ZGate(sp_var, z0=plate_top + 0.002)
    return Scene(shape=TriangleMesh(verts, faces),
                 bsdf=ComposeSpatialVarying(bsdfs, sp_var_fn=sp_var),
                 lights=PointLights(scale=light_scale), occlusion=occlusion)


def gt_integrator(gt_bounces: int = 1, gt_spp: int = 16):
    """-> (the ground truth's integrator, its passes a frame)."""
    from ..integrators import Direct, Mask, Path
    if gt_bounces >= 2:
        return Mask(Path(max_depth=gt_bounces, training=False, horizon_mask=True)), max(1, gt_spp)
    return Mask(Direct(training=False, horizon_mask=True)), 1


def focal(size: int) -> float:
    return 0.5 * size / math.tan(0.5 * CAMERA_ANGLE_X)


def nerf_camera(c2w: np.ndarray, size: int):
    from ..cameras import NeRFCamera
    return NeRFCamera(torch.as_tensor(c2w[None, :3, :4], dtype=torch.float32), focal(size))


def fov_camera(elev: float, azim: float, dist: float = 1.0):
    from ..cameras import FoVPerspectiveCamera, look_at_view_transform
    r, t = look_at_view_transform(dist=dist, elev=elev, azim=azim)
    return FoVPerspectiveCamera(R=r, T=t)


def render(scene, camera, light_loc, scale: float, integrator, spp: int, *, size: int,
           device="cuda", key: Optional[int] = 1) -> np.ndarray:
    """One RGBA frame ``[size, size, 4]`` (not clipped) lit by one point light
    at ``light_loc`` of scale ``scale``: the mean of ``spp`` passes, pass
    ``s`` seeded ``key + s`` (``key`` None: no camera jitter and no draws,
    which ``Direct`` allows)."""
    from ..render import pathtrace
    with torch.no_grad():
        scene.lights.set_location(np.atleast_2d(np.asarray(light_loc, np.float32)))
        scene.lights.scale.fill_(float(scale))
    acc = None
    for s in range(spp):
        img, _ = pathtrace(scene, camera, integrator, size=size, chunk_size=chunk_for(size),
                           background=0.0, key=None if key is None else key + s,
                           device=device)
        acc = img if acc is None else acc + img
    return acc.cpu().numpy() / spp


def render_rig(scene, camera, locs, scale, integrator, spp, *, size, device="cuda"):
    """The frame under several lights: one render a light, colours summed,
    the first light's alpha."""
    out = np.array(render(scene, camera, locs[0], scale, integrator, spp, size=size,
                          device=device))
    for loc in locs[1:]:
        out[..., :3] += render(scene, camera, loc, scale, integrator, spp, size=size,
                               device=device)[..., :3]
    return out


def light_rig(n_lights: int) -> list:
    """The nerf format's static lights: ``n_lights`` on a ring at elevation
    35 of radius |NERF_LIGHT| (one: NERF_LIGHT itself)."""
    if n_lights <= 1:
        return [NERF_LIGHT]
    r = float(np.linalg.norm(NERF_LIGHT))
    el = math.radians(35.0)
    return [r * np.asarray([math.cos(el) * math.cos(a), math.cos(el) * math.sin(a),
                            math.sin(el)], np.float32)
            for a in np.linspace(0.0, 2.0 * np.pi, n_lights, endpoint=False)]


def quantise(img: np.ndarray) -> np.ndarray:
    """The 8-bit values a PNG of ``img`` holds."""
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def auto_exposure(scene, args, integrator, spp, rig, device) -> float:
    """The light scale that puts the 99.5th percentile of the lit pixels of
    two probe views, rendered under the format's own lights, at 0.85."""
    probes = []
    for elev, azim in [(15.0, 30.0), (35.0, -120.0)]:
        if args.format in ("nerf", "nerv"):
            cam = nerf_camera(c2w_up(elev, azim, args.cam_dist, up=args.up), args.size)
            if args.format == "nerf":
                probes.append(render_rig(scene, cam, rig, 1.0, integrator, spp,
                                         size=args.size, device=device))
                continue
            # the nerv lights sit on a shell of radius 1.3
            loc = NERF_LIGHT * (1.3 / np.linalg.norm(NERF_LIGHT))
        else:
            cam = fov_camera(elev, azim)
            loc = cam.camera_center()[0].numpy() * 1.05
        probes.append(render(scene, cam, loc, 1.0, integrator, spp, size=args.size,
                             device=device))
    lit = np.concatenate([p[..., :3][p[..., 3] > 0.5] for p in probes])
    return 0.85 / max(float(np.percentile(lit, 99.5)), 1e-6)


def parser():
    ap = base_parser(__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--kind", type=str, default="knot", choices=sorted(MESHES))
    ap.add_argument("--format", type=str, default="nerf", choices=["nerf", "colocate", "nerv"])
    ap.add_argument("--train-views", type=int, default=100)
    ap.add_argument("--test-views", type=int, default=16)
    ap.add_argument("--n-elev", type=int, default=8)
    ap.add_argument("--n-azim", type=int, default=8)
    ap.add_argument("--relight", action="store_true")
    ap.add_argument("--light-scale", type=float, default=0.0,
                    help="the point light's scale; 0: auto-exposure")
    ap.add_argument("--occlusion", type=str, default="hard", choices=["hard", "none"])
    ap.add_argument("--obj-scale", type=float, default=1.0)
    ap.add_argument("--cam-dist", type=float, default=1.2,
                    help="camera distance from the origin (nerf and nerv)")
    ap.add_argument("--material", type=str, default="default", choices=["default", "variety"])
    ap.add_argument("--up", type=str, default="y", choices=["y", "z"],
                    help="the world's up axis of the camera orbit")
    ap.add_argument("--elev-range", type=float, nargs=2, default=(-10.0, 55.0))
    ap.add_argument("--light-noise", type=float, default=0.6,
                    help="nerv: the spread of a frame's light around the camera's direction")
    ap.add_argument("--n-lights", type=int, default=1,
                    help="nerf: point lights on a ring at elevation 35")
    ap.add_argument("--mirror-plate", type=float, default=0.0,
                    help="a conductor plate of this half-extent under the object")
    ap.add_argument("--gt-bounces", type=int, default=1,
                    help=">= 2: the ground truth by Path(max_depth=N)")
    ap.add_argument("--gt-spp", type=int, default=16,
                    help="Path passes averaged a frame (with --gt-bounces >= 2)")
    return ap


def _orbit_frames(scene, args, split, n, rng, draw_light, rig, integrator, spp, scale, device,
                  log_fn):
    """A nerf or nerv split: the frames' RGBA ``[n, S, S, 4]`` uint8 and dicts;
    a frame's light from ``draw_light`` (nerv), else the static ``rig``."""
    images, frames = [], []
    for i in range(n):
        c2w = c2w_up(rng.uniform(*args.elev_range), rng.uniform(-180, 180), args.cam_dist,
                     up=args.up)
        cam = nerf_camera(c2w, args.size)
        frame = {"file_path": f"{split}/r_{i}", "transform_matrix": c2w.tolist()}
        if draw_light is None:
            img = render_rig(scene, cam, rig, scale, integrator, spp, size=args.size,
                             device=device)
        else:
            light = draw_light(c2w, rng)
            frame["light_loc"] = light.tolist()
            img = render(scene, cam, light, scale, integrator, spp, size=args.size,
                         device=device)
        images.append(quantise(img))
        frames.append(frame)
        if (i + 1) % 10 == 0:
            log_fn(f"{split} {i + 1} / {n}")
    return np.stack(images), frames


def run(args, log_fn=print) -> dict:
    """Render the dataset of ``args`` -> ``{"meta", "scale"}`` and, for nerf
    and nerv, ``{split: (images, frames)}`` for ``train`` and ``test``; for
    colocate ``"grid"`` ``{(i, j): image}`` and ``"relight"`` ``{(i, j, k,
    l): image}``.  The images are RGBA uint8."""
    device = device_of(args)
    scene = build_gt_scene(args.kind, light_scale=1.0, occlusion=args.occlusion,
                           obj_scale=args.obj_scale, material=args.material,
                           mirror_plate=args.mirror_plate)
    scene.init(torch.Generator().manual_seed(SEED), device=device)
    integrator, spp = gt_integrator(args.gt_bounces, args.gt_spp)
    rig = light_rig(args.n_lights)
    scale = args.light_scale
    if scale <= 0:
        scale = auto_exposure(scene, args, integrator, spp, rig, device)
        log_fn(f"auto light scale: {scale:.3f}")
    meta = {"kind": args.kind, "format": args.format, "size": args.size, "light_scale": scale,
            "material": args.material, "mirror_plate": args.mirror_plate, "args": vars(args)}
    out = {"meta": meta, "scale": scale}
    if args.format in ("nerf", "nerv"):
        draw_light = None
        if args.format == "nerv":
            def draw_light(c2w, rng):
                # a frame's light in the camera's hemisphere, as a hand-held flash
                d = (c2w[:3, 3] / np.linalg.norm(c2w[:3, 3])
                     + args.light_noise * rng.normal(size=3))
                return 1.3 * d / np.linalg.norm(d)
        rng = np.random.default_rng(args.seed)
        for split, n in [("train", args.train_views), ("test", args.test_views)]:
            out[split] = _orbit_frames(scene, args, split, n, rng, draw_light, rig,
                                       integrator, spp, scale, device, log_fn)
        return out
    out["grid"], out["relight"] = {}, {}
    for i, elev in enumerate(np.linspace(0.0, 45.0, args.n_elev)):
        for j, azim in enumerate(np.linspace(-135.0, 135.0, args.n_azim)):
            cam = fov_camera(elev, azim)
            loc = cam.camera_center()[0].numpy() * 1.05
            out["grid"][i, j] = quantise(render(scene, cam, loc, scale, integrator, spp,
                                                size=args.size, device=device))
        log_fn(f"row {i + 1}/{args.n_elev} done")
    if args.relight:
        for i, ce in enumerate(np.linspace(0.0, 45.0, 4)):
            for j, ca in enumerate(np.linspace(-135.0, 135.0, 4)):
                cam = fov_camera(ce, ca)
                for k, le in enumerate(np.linspace(10.0, 60.0, 3)):
                    for m, la in enumerate(np.linspace(-90.0, 90.0, 3)):
                        loc = fov_camera(le, la, dist=1.05).camera_center()[0].numpy()
                        out["relight"][i, j, k, m] = quantise(render(
                            scene, cam, loc, scale, integrator, spp, size=args.size,
                            device=device))
            log_fn(f"relight row {i + 1}/4 done")
    return out


def write(args, out: dict) -> None:
    """Write ``run``'s images, frames and ``meta.json`` under ``args.out``."""
    from PIL import Image   # only the writer needs PIL
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "meta.json"), "w") as f:
        json.dump(out["meta"], f)
    if args.format in ("nerf", "nerv"):
        for split in ("train", "test"):
            images, frames = out[split]
            base = args.out if args.format == "nerf" else os.path.join(args.out,
                                                                       f"{split}_point")
            os.makedirs(os.path.join(base, split), exist_ok=True)
            for img, frame in zip(images, frames):
                Image.fromarray(img, "RGBA").save(os.path.join(base, frame["file_path"] + ".png"))
            with open(os.path.join(base, f"transforms_{split}.json"), "w") as f:
                json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
        return
    for (i, j), img in out["grid"].items():
        Image.fromarray(img, "RGBA").save(os.path.join(args.out, f"{args.kind}_{i}_{j}.png"))
    for (i, j, k, m), img in out["relight"].items():
        Image.fromarray(img, "RGBA").save(
            os.path.join(args.out, f"gt_{args.kind}_{i}_{j}_{k}_{m}.png"))


def main(argv=None) -> dict:
    """Render and write the dataset; returns ``run``'s dict."""
    args = parser().parse_args(argv)
    out = run(args)
    write(args, out)
    print("wrote", args.out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
