"""Dataset generation: colocated-light grids rendered by the port itself.

The twin of ``scripts/make_dataset.py`` of the JAX package: a procedural SDF
per kind (bunny, buddha, teapot, armadillo) under a fixed spatially-varying
material (two ``Diffuse`` lobes and a ``Conductor`` mixed by a small plain
weight net), a ``PointLights(scale=light_scale)`` light, hard shadows, and
``Mask(Direct(training=False, horizon_mask=True))``, whose fourth channel is
the hit mask.  It renders the ``n_elev x n_azim`` colocated grid
``{kind}_{i}_{j}.png`` (camera at distance 1, light at 1.05 x the camera
centre) and, with ``--relight``, the 4 x 4 camera x 3 x 3 light grid
``gt_{kind}_{i}_{j}_{k}_{l}.png``, RGBA.  The cameras are PyTorch3D's Y-up
``look_at_view_transform``, as the JAX generator's.

    python -m neural_raytracing_tpu_torch.workloads.make_dataset \
        --out outputs/cbox --kind bunny

``render_grid`` and ``render_relight_grid`` return the images as numpy
arrays, so a caller on the card needs no PIL; ``main`` writes them as PNGs.
The scene's weight net is drawn from a seeded ``torch.Generator`` (the JAX
script draws it from ``PRNGKey(7)``), so the two packages' datasets differ
by that draw, and by the camera jitter, alone; ``build_scene`` followed by
``load_jax_params`` renders with the JAX draw.  The procedural shapes take
the plain march loops (the kernels take only a SphereSDF), as in the JAX
package.  ``--device`` picks the card (default) or the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Iterable, Optional

import numpy as np
import torch

from ..ops.math import device_constant
from ._common import chunk_for

KINDS = ("bunny", "buddha", "teapot", "armadillo")
SEED = 7                       # the weight net's draw (the JAX script's PRNGKey(7))
# the relight grid: camera elevations x azimuths at distance 1, light
# elevations x azimuths at distance 1.05
CAM_ELEVS = np.linspace(0.0, 45.0, 4)
CAM_AZIMS = np.linspace(-135.0, 135.0, 4)
LIGHT_ELEVS = np.linspace(10.0, 60.0, 3)
LIGHT_AZIMS = np.linspace(-90.0, 90.0, 3)


def _smin(a, b, k=8.0):
    return -torch.log(torch.exp(-k * a) + torch.exp(-k * b)) / k


def _v(p, *xs):
    return device_constant(xs, p.dtype, p.device)


def _bunny(p):
    from ..shapes import capsule_sdf, sphere_sdf
    body = sphere_sdf(p * _v(p, 1.0, 1.2, 1.0), 0.42)
    head = sphere_sdf(p - _v(p, 0.0, 0.45, 0.1), 0.25)
    ear1 = capsule_sdf(p, _v(p, -0.12, 0.6, 0.05), _v(p, -0.16, 0.95, 0.0), 0.07)
    ear2 = capsule_sdf(p, _v(p, 0.12, 0.6, 0.05), _v(p, 0.16, 0.95, 0.0), 0.07)
    return _smin(_smin(body, head), torch.minimum(ear1, ear2))


def _teapot(p):
    from ..shapes import capsule_sdf, sphere_sdf
    body = sphere_sdf(p * _v(p, 1.0, 1.4, 1.0), 0.45)
    spout = capsule_sdf(p, _v(p, 0.35, 0.0, 0.0), _v(p, 0.62, 0.25, 0.0), 0.08)
    handle = capsule_sdf(p, _v(p, -0.4, 0.2, 0.0), _v(p, -0.4, -0.2, 0.0), 0.06)
    lid = sphere_sdf(p - _v(p, 0.0, 0.38, 0.0), 0.12)
    return _smin(_smin(body, spout), torch.minimum(handle, lid))


def _buddha(p):
    from ..shapes import box_sdf, sphere_sdf
    base = box_sdf(p + _v(p, 0.0, 0.45, 0.0), _v(p, 0.35, 0.1, 0.25))
    torso = sphere_sdf((p + _v(p, 0.0, 0.1, 0.0)) * _v(p, 1.2, 1.0, 1.4), 0.35)
    head = sphere_sdf(p - _v(p, 0.0, 0.38, 0.0), 0.18)
    return _smin(_smin(base, torso), head)


def _armadillo(p):
    from ..shapes import capsule_sdf, sphere_sdf
    body = sphere_sdf(p * _v(p, 1.1, 1.0, 1.3), 0.4)
    tail = capsule_sdf(p, _v(p, 0.0, -0.2, 0.35), _v(p, 0.0, -0.45, 0.75), 0.08)
    l1 = capsule_sdf(p, _v(p, -0.2, -0.3, 0.0), _v(p, -0.25, -0.6, 0.0), 0.09)
    l2 = capsule_sdf(p, _v(p, 0.2, -0.3, 0.0), _v(p, 0.25, -0.6, 0.0), 0.09)
    return _smin(_smin(body, tail), torch.minimum(l1, l2))


_SHAPES = {"bunny": _bunny, "teapot": _teapot, "buddha": _buddha,
           "armadillo": _armadillo}


def procedural_shape(kind: str):
    """A procedural SDF stand-in for the dataset kind (any kind but bunny,
    teapot and buddha is the armadillo, as in the JAX script)."""
    from ..shapes import SDF, FunctionalSDF
    return SDF(FunctionalSDF(_SHAPES.get(kind, _armadillo)), max_steps=64, dist=4.0)


def build_scene(kind: str = "bunny", light_scale: float = 1.5):
    """The generator's scene (the weight net random until initialised or
    loaded)."""
    from .. import Scene
    from ..bsdf import ComposeSpatialVarying, Conductor, Diffuse
    from ..lights import PointLights
    from ..nn import SkipConnMLP
    # a fixed spatially-varying material, so relighting is not trivial
    bsdf = ComposeSpatialVarying(
        [Diffuse((0.7, 0.3, 0.2)), Diffuse((0.2, 0.4, 0.7)), Conductor()],
        sp_var_fn=SkipConnMLP(in_size=3, out=3, num_layers=2, hidden_size=32,
                              freqs=8, sigma=8.0))
    return Scene(shape=procedural_shape(kind), bsdf=bsdf,
                 lights=PointLights(scale=light_scale), occlusion="hard")


def integrator():
    from ..integrators import Direct, Mask
    return Mask(Direct(training=False, horizon_mask=True))


def camera_at(dist: float, elev: float, azim: float):
    from ..cameras import FoVPerspectiveCamera, look_at_view_transform
    r, t = look_at_view_transform(dist=dist, elev=elev, azim=azim)
    return FoVPerspectiveCamera(R=r, T=t)


def render_view(scene, elev: float, azim: float, light_loc, *, size: int,
                chunk_size: Optional[int] = None, key: Optional[int] = 0,
                device="cuda") -> np.ndarray:
    """One RGBA view ``[size, size, 4]`` in [0, 1] of the camera at distance
    1, lit from ``light_loc`` ``[1, 3]``."""
    from ..render import pathtrace
    scene.lights.set_location(light_loc)
    img, _ = pathtrace(scene, camera_at(1.0, elev, azim), integrator(), size=size,
                       chunk_size=chunk_size or chunk_for(size), background=0.0,
                       key=key, device=device)
    return np.clip(img.cpu().numpy(), 0.0, 1.0)


def render_grid(scene, *, size: int, n_elev: int = 8, n_azim: int = 8,
                chunk_size: Optional[int] = None, device="cuda",
                log_fn=print) -> dict:
    """The colocated grid -> ``{(i, j): RGBA [size, size, 4]}``: elevation
    ``i`` of ``linspace(0, 45, n_elev)``, azimuth ``j`` of
    ``linspace(-135, 135, n_azim)``, the light at 1.05 x the camera centre."""
    out = {}
    for i, elev in enumerate(np.linspace(0.0, 45.0, n_elev)):
        for j, azim in enumerate(np.linspace(-135.0, 135.0, n_azim)):
            center = camera_at(1.0, elev, azim).camera_center()
            out[(i, j)] = render_view(scene, elev, azim, center * 1.05, size=size,
                                      chunk_size=chunk_size, device=device)
        log_fn(f"row {i + 1}/{n_elev} done")
    return out


def relight_light(k: int, l: int) -> torch.Tensor:
    """The relight grid's light ``(k, l)`` -> its location ``[1, 3]``."""
    return camera_at(1.05, LIGHT_ELEVS[k], LIGHT_AZIMS[l]).camera_center()


def render_relight_grid(scene, *, size: int, cam_rows: Iterable[int] = range(4),
                        chunk_size: Optional[int] = None, device="cuda",
                        log_fn=print) -> dict:
    """The relight grid's camera rows ``cam_rows`` -> ``{(i, j, k, l): RGBA}``
    (camera ``i, j``, light ``k, l``)."""
    out = {}
    for i in cam_rows:
        for j, azim in enumerate(CAM_AZIMS):
            for k in range(len(LIGHT_ELEVS)):
                for l in range(len(LIGHT_AZIMS)):
                    out[(i, j, k, l)] = render_view(
                        scene, CAM_ELEVS[i], azim, relight_light(k, l), size=size,
                        chunk_size=chunk_size, device=device)
        log_fn(f"relight row {i + 1}/{len(CAM_ELEVS)} done")
    return out


def quantise(rgba: np.ndarray) -> np.ndarray:
    """The 8-bit image a PNG of ``rgba`` holds."""
    return (np.clip(rgba, 0.0, 1.0) * 255).astype(np.uint8)


def as_dataset(grid: dict, n_elev: int, n_azim: int):
    """The ``ColocateDataset`` that ``load_colocate`` reads back from the
    grid's PNGs (8-bit images, masks ``ceil(alpha - 1e-5)``), in memory."""
    from ..training import ColocateDataset
    imgs = np.stack([quantise(grid[(i, j)]) for i in range(n_elev)
                     for j in range(n_azim)]).astype(np.float64).astype(np.float32) / 255.0
    elevs = np.repeat(np.linspace(0.0, 45.0, n_elev), n_azim).astype(np.float32)
    azims = np.tile(np.linspace(-135.0, 135.0, n_azim), n_elev).astype(np.float32)
    return ColocateDataset(imgs[..., :3], np.ceil(imgs[..., 3] - 1e-5), elevs, azims, 1.0)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--kind", type=str, default="bunny", choices=list(KINDS))
    ap.add_argument("--size", type=int, default=200, help="image size")
    ap.add_argument("--n-elev", type=int, default=8)
    ap.add_argument("--n-azim", type=int, default=8)
    ap.add_argument("--relight", action="store_true",
                    help="also render the 4x4 camera x 3x3 light grid")
    ap.add_argument("--light-scale", type=float, default=1.5,
                    help="point-light scale; low enough that the ground truth "
                         "is not clipped at 1")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def main(argv=None) -> tuple:
    """Render and write the PNGs; returns ``(grid, relight grid)``."""
    args = parser().parse_args(argv)
    from PIL import Image   # only the writer needs PIL

    scene = build_scene(args.kind, args.light_scale)
    scene.init(torch.Generator().manual_seed(SEED), device=args.device)
    os.makedirs(args.out, exist_ok=True)

    def write(name, rgba):
        Image.fromarray(quantise(rgba), "RGBA").save(os.path.join(args.out, name))

    grid = render_grid(scene, size=args.size, n_elev=args.n_elev, n_azim=args.n_azim,
                       device=args.device)
    for (i, j), rgba in grid.items():
        write(f"{args.kind}_{i}_{j}.png", rgba)
    relight = {}
    if args.relight:
        relight = render_relight_grid(scene, size=args.size, device=args.device)
        for (i, j, k, l), rgba in relight.items():
            write(f"gt_{args.kind}_{i}_{j}_{k}_{l}.png", rgba)
    return grid, relight


if __name__ == "__main__":
    main(sys.argv[1:])
