"""Dataset generation: a DTU / IDR-format scan rendered by the port itself.

The twin of ``scripts/make_dtu_dataset.py`` of the JAX package: the layout
``workloads.dtu`` reads (``cameras.npz`` with ``world_mat_i = K [R | t]``
and identity ``scale_mat_i``, ``image/`` and ``mask/``), so the DTU path
(projection decomposition, ``DTUCamera`` rays, masked training) runs
without the real scans.  The scene is a procedural SDF (``make_dataset``'s
kinds) under ``ComposeSpatialVarying`` over two ``Diffuse`` lobes mixed by a
2 x 32 plain weight net, a ``PointLights(location=(0.3, 0.6, 0.6),
scale=light_scale)`` light and hard shadows, rendered by
``Mask(Direct(training=False, horizon_mask=True))``.  The views sit at
distance 1, elevation U(5, 45) and azimuth U(-180, 180) degrees from
``numpy.random.default_rng(0)``, looking at the origin along +z (the
OpenCV convention), with a 60-degree field of view; the intrinsics are in
units of ``size`` pixels, and the render's ``DTUCamera`` takes
``src_size = (size, size)``.  (``workloads.dtu``, like ``scripts/dtu.py``,
loads with the DTU scans' 1600 x 1200, so its rays are not the ones that
rendered the pixels: see ``ROADMAP.md``, Queue 3.)

    python -m neural_raytracing_tpu_torch.workloads.make_dtu_dataset \
        --out outputs/dtu_ds --views 16 --size 64

``render_scan`` returns the images, RGB masks and camera matrices as
arrays, so a caller on the card needs no PIL; ``main`` writes them.  The
weight net is drawn from a seeded ``torch.Generator`` (the JAX script draws
it from ``PRNGKey(7)``); ``build_scene`` followed by ``load_jax_params``
renders with the JAX draw.  A ``DTUCamera`` gives each ray of a bundle the
same direction, so a view renders with a bundle of 1, which the JAX
script's bundle of 4 only repeats.  ``--mesh KIND`` (``make_mesh_dataset``'s
kinds) renders a triangle-mesh ground truth instead, scaled by
``--obj-scale``, with the bright ``variety`` material, lit by a ring of 3
point lights at elevation 35 about the y axis (radius 1.6), each view the
sum of one render a light.  ``--device`` picks the card (default) or the
CPU.
"""

from __future__ import annotations

import argparse
import math
import os
import sys
from typing import Optional

import numpy as np
import torch

SEED = 7                       # the weight net's draw (the JAX script's PRNGKey(7))


def build_scene(kind: str = "bunny", light_scale: float = 3.0, mesh: Optional[str] = None,
                obj_scale: float = 1.0):
    """The generator's scene (the weight net random until initialised or
    loaded): the procedural ``kind``, or with ``mesh`` that triangle mesh
    under the ``variety`` material."""
    if mesh:
        from .make_mesh_dataset import build_gt_scene
        return build_gt_scene(mesh, light_scale=light_scale, occlusion="hard",
                              obj_scale=obj_scale, material="variety")
    from .. import Scene
    from ..bsdf import ComposeSpatialVarying, Diffuse
    from ..lights import PointLights
    from ..nn import SkipConnMLP
    from .make_dataset import procedural_shape
    return Scene(
        shape=procedural_shape(kind),
        bsdf=ComposeSpatialVarying(
            [Diffuse((0.8, 0.3, 0.2)), Diffuse((0.2, 0.3, 0.8))],
            sp_var_fn=SkipConnMLP(in_size=3, out=2, num_layers=2, hidden_size=32,
                                  freqs=8, sigma=8.0)),
        lights=PointLights(location=(0.3, 0.6, 0.6), scale=light_scale),
        occlusion="hard")


def mesh_rig() -> list:
    """The 3 static lights of a mesh scan: a ring about the y axis at
    elevation 35, radius 1.6."""
    el = math.radians(35.0)
    return [1.6 * np.asarray([math.cos(el) * math.sin(a), math.sin(el),
                              math.cos(el) * math.cos(a)], np.float32)
            for a in np.linspace(0.0, 2.0 * math.pi, 3, endpoint=False)]


def intrinsic(size: int) -> np.ndarray:
    """K ``[3, 3]`` in units of ``size`` pixels, a 60-degree field of view."""
    K = np.eye(3, dtype=np.float32)
    K[0, 0] = K[1, 1] = 0.5 * float(size) / math.tan(math.radians(30.0))
    K[0, 2] = float(size) / 2.0
    K[1, 2] = float(size) / 2.0
    return K


def scan_cameras(n_views: int, size: int):
    """-> (camera-to-world poses ``[V, 4, 4]``, the ``cameras.npz`` dict):
    the views of ``numpy.random.default_rng(0)``, as the JAX script draws
    and writes them."""
    K = intrinsic(size)
    rng = np.random.default_rng(0)
    poses, cams = [], {}
    for i in range(n_views):
        elev = math.radians(rng.uniform(5, 45))
        azim = math.radians(rng.uniform(-180, 180))
        c = np.asarray([math.cos(elev) * math.sin(azim), math.sin(elev),
                        math.cos(elev) * math.cos(azim)], np.float32)
        # camera-to-world: +z looks at the origin
        forward = -c / np.linalg.norm(c)
        right = np.cross(np.asarray([0.0, 1.0, 0.0]), forward)
        right /= max(np.linalg.norm(right), 1e-9)
        up = np.cross(forward, right)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 0] = right
        pose[:3, 1] = up
        pose[:3, 2] = forward
        pose[:3, 3] = c
        # world_mat = K [R | t], [R | t] world-to-camera
        R = pose[:3, :3].T
        t = -R @ c
        P = np.eye(4, dtype=np.float32)
        P[:3, :4] = K @ np.concatenate([R, t[:, None]], axis=1)
        cams[f"world_mat_{i}"] = P
        cams[f"scale_mat_{i}"] = np.eye(4, dtype=np.float32)
        poses.append(pose)
    return np.stack(poses), cams


def render_camera(pose: np.ndarray, size: int):
    """The ``DTUCamera`` that renders a view of ``pose`` ``[4, 4]``."""
    from ..cameras import DTUCamera
    intr = np.pad(intrinsic(size), ((0, 1), (0, 1))) + np.diag([0.0, 0.0, 0.0, 1.0])
    return DTUCamera(pose=torch.as_tensor(pose[None], dtype=torch.float32),
                     intrinsic=torch.as_tensor(intr[None], dtype=torch.float32),
                     src_size=(float(size), float(size)))


def render_view(scene, pose: np.ndarray, *, size: int, key: Optional[int] = 0,
                chunk_size: Optional[int] = None, device="cuda", rig=None) -> np.ndarray:
    """One RGBA view ``[size, size, 4]`` in [0, 1] (alpha: the hit mask);
    with ``rig`` (light locations) the colours of one render a light,
    summed, then clipped."""
    from ..integrators import Direct, Mask
    from ..render import pathtrace

    def one():
        img, _ = pathtrace(scene, render_camera(pose, size),
                           Mask(Direct(training=False, horizon_mask=True)), size=size,
                           chunk_size=chunk_size or size, bundle_size=1, background=0.0,
                           key=key, device=device)
        return img.cpu().numpy()

    if rig is None:
        return np.clip(one(), 0.0, 1.0)
    scene.lights.set_location(rig[0][None])
    arr = one()
    for loc in rig[1:]:
        scene.lights.set_location(loc[None])
        arr[..., :3] += one()[..., :3]
    return np.clip(arr, 0.0, 1.0)


def quantise(x: np.ndarray) -> np.ndarray:
    """The 8-bit values a PNG of ``x`` in [0, 1] holds."""
    return (np.clip(x, 0.0, 1.0) * 255).astype(np.uint8)


def render_scan(scene, n_views: int, size: int, chunk_size: Optional[int] = None,
                device="cuda", log_fn=print, rig=None):
    """-> (images ``[V, S, S, 3]`` uint8, RGB masks ``[V, S, S, 3]`` uint8,
    the ``cameras.npz`` dict): what ``main`` writes.  View ``i`` renders
    with key ``i``; ``rig`` as ``render_view``."""
    poses, cams = scan_cameras(n_views, size)
    images, masks = [], []
    for i, pose in enumerate(poses):
        rgba = render_view(scene, pose, size=size, key=i, chunk_size=chunk_size,
                           device=device, rig=rig)
        images.append(quantise(rgba[..., :3]))
        # RGB masks, as the DTU / IDR layout has them
        masks.append(np.repeat(quantise(rgba[..., 3:]), 3, axis=-1))
        log_fn(f"view {i + 1}/{n_views}")
    return np.stack(images), np.stack(masks), cams


def as_arrays(images: np.ndarray, masks: np.ndarray):
    """The float images and {0, 1} masks ``load_dtu`` reads back from the
    PNGs of ``render_scan``'s arrays, in memory."""
    imgs = images.astype(np.float64).astype(np.float32) / 255.0
    m = masks[..., 0].astype(np.float64).astype(np.float32) / 255.0
    return imgs, (m > 0.5).astype(np.float32)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--views", type=int, default=16)
    ap.add_argument("--kind", type=str, default="bunny")
    ap.add_argument("--mesh", type=str, default=None,
                    choices=[None, "knot", "ico", "gear", "blocks"],
                    help="a triangle-mesh ground truth (make_mesh_dataset's kinds) "
                         "with the bright variety material and a 3-light ring")
    ap.add_argument("--obj-scale", type=float, default=1.0)
    ap.add_argument("--light-scale", type=float, default=3.0)
    ap.add_argument("--size", type=int, default=64, help="image size")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def main(argv=None):
    """Render and write the scan; returns ``render_scan``'s arrays."""
    args = parser().parse_args(argv)
    from PIL import Image   # only the writer needs PIL

    scene = build_scene(args.kind, args.light_scale, args.mesh, args.obj_scale)
    scene.init(torch.Generator().manual_seed(SEED), device=args.device)
    images, masks, cams = render_scan(scene, args.views, args.size, device=args.device,
                                      rig=mesh_rig() if args.mesh else None)
    for sub, arrs in (("image", images), ("mask", masks)):
        os.makedirs(os.path.join(args.out, sub), exist_ok=True)
        for i, arr in enumerate(arrs):
            Image.fromarray(arr).save(os.path.join(args.out, sub, f"{i:06}.png"))
    np.savez(os.path.join(args.out, "cameras.npz"), **cams)
    print("wrote", args.out)
    return images, masks, cams


if __name__ == "__main__":
    main(sys.argv[1:])
