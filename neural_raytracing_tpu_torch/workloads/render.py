"""Standalone renderer: load a trained scene and render an orbit of frames.

The twin of ``scripts/render.py`` of the JAX package (a serving-style
utility with no reference equivalent): frame ``f`` of ``--frames`` looks at
the origin from distance ``--dist``, elevation ``--elev`` and azimuth
``-180 + 360 f / frames``, through a ``FoVPerspectiveCamera``; for the
point-light workloads the light sits at 1.05 x the camera centre.  The
primary march can be over-relaxed with ``--omega`` (1: off).

    python -m neural_raytracing_tpu_torch.workloads.render --workload nerv \
        --models scripts/models_seed_dir/nerv_mesh_gear_mirror200b --omega 1.4

Ported: ``--workload nerv`` and ``--workload colocate`` (each its twin's
``build_scene``, learned occlusion included, as ``scripts/render.py``
rebuilds it) with ``--integrator direct``.  The other workloads and
integrators raise ``NotImplementedError``.  ``--device``
picks the card (default) or the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ._common import chunk_for, save_image

# what the port lacks, and the ROADMAP.md queue it comes with
_NOT_PORTED = {
    "nerf": "the twin of scripts/nerf_synthetic.py (Queue 1, the deferred training items)",
    "dtu": "the DTU loader and cameras (Queue 1, the deferred training items)",
    "debug": "the debug integrators (Queue 1, the rest of the scene set)",
    "depth": "the debug integrators (Queue 1, the rest of the scene set)",
    "silhouette": "the debug integrators (Queue 1, the rest of the scene set)",
    "path": "the Path integrator (Queue 1, the rest of the scene set)",
}


def _not_ported(option: str, value: str):
    raise NotImplementedError(f"{option} {value} is not ported yet: it comes with "
                              f"{_NOT_PORTED[value]} (ROADMAP.md)")


def build_scene(workload: str, max_steps: int):
    """The named workload's scene (random weights until loaded)."""
    if workload == "colocate":
        from .colocate import build_scene as colocate_scene
        return colocate_scene(max_steps=max_steps)
    if workload != "nerv":
        _not_ported("--workload", workload)
    from .nerv import build_scene as nerv_scene
    return nerv_scene(max_steps=max_steps)


def frame_camera(f: int, frames: int, dist: float, elev: float):
    """The ``FoVPerspectiveCamera`` of orbit frame ``f``."""
    from ..cameras import FoVPerspectiveCamera, look_at_view_transform
    r, t = look_at_view_transform(dist=dist, elev=elev,
                                  azim=-180.0 + 360.0 * f / frames)
    return FoVPerspectiveCamera(R=r, T=t)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", type=str, default="nerf",
                    choices=["nerf", "colocate", "dtu", "nerv"],
                    help="which workload's scene to rebuild")
    ap.add_argument("--models", type=str, default="models",
                    help="directory of the trained scene artifacts")
    ap.add_argument("--outputs", type=str, default="outputs")
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--size", type=int, default=128, help="image size")
    ap.add_argument("--dist", type=float, default=1.0)
    ap.add_argument("--elev", type=float, default=20.0)
    ap.add_argument("--integrator", type=str, default="direct",
                    choices=["direct", "debug", "depth", "silhouette", "path"])
    ap.add_argument("--max-steps", type=int, default=128)
    ap.add_argument("--omega", type=float, default=1.0,
                    help="sphere-trace over-relaxation (1.0 = off)")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def main(argv=None) -> np.ndarray:
    """Render and save the orbit; returns the frames ``[F, S, S, 3]``."""
    args = parser().parse_args(argv)
    from ..integrators import Direct
    from ..render import pathtrace
    from ..training import load_scene

    scene = build_scene(args.workload, args.max_steps)
    if args.integrator != "direct":
        _not_ported("--integrator", args.integrator)
    if args.omega != 1.0:
        scene.shape.omega = args.omega
    scene.init(torch.Generator().manual_seed(0), device=args.device)
    load_scene(args.models, scene)
    integrator = Direct(training=False)
    images = []
    for f in range(args.frames):
        cam = frame_camera(f, args.frames, args.dist, args.elev)
        scene.lights.set_location(cam.camera_center() * 1.05)
        img, _ = pathtrace(scene, cam, integrator, size=args.size,
                           chunk_size=chunk_for(args.size), background=0.0,
                           key=f, device=args.device)
        img = img.cpu().numpy()
        save_image(f"{args.outputs}/orbit_{args.workload}_{f:03}.png", img)
        print(f"frame {f + 1}/{args.frames}")
        images.append(img)
    return np.stack(images)


if __name__ == "__main__":
    main(sys.argv[1:])
