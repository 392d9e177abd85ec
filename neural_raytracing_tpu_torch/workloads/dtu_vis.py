"""Visualize a trained DTU model.

The twin of ``scripts/dtu_vis.py`` of the JAX package: each basis of the
BSDF rendered on a sphere (``utils.sphere_examples``), then for the first
``--views`` views the per-basis weight maps (``BasisBRDF``), the normal map
(``Debug``) and the render (``Direct``).  The scene is
``dtu.build_scene(max_steps=128)`` with seed-0 weights, then
``{models}/dtu_{name}``; the cameras are the scan's, at its source size.

    python -m neural_raytracing_tpu_torch.workloads.dtu_vis --data DTU/scan97

``run`` takes the scan in memory (a ``DTUDataset``) and returns the
images.  ``--device`` picks the card (default) or the CPU.
"""

from __future__ import annotations

import sys

from ._common import base_parser, device_of, load_trained, render_view, save_image


def parser():
    ap = base_parser(__doc__.split("\n\n")[0], size=128)
    ap.add_argument("--data", type=str, required=True)
    ap.add_argument("--views", type=int, default=4)
    return ap


def run(args, data, name: str, scene=None, save: bool = True) -> dict:
    """-> ``{"spheres": [image], "weights": {i: [weight map]}, "normals":
    {i: image}, "render": {i: image}}`` (numpy)."""
    from ..integrators import BasisBRDF, Debug, Direct
    from ..utils import sphere_examples
    from .dtu import build_scene, camera_maker
    device = device_of(args)
    if scene is None:
        scene = load_trained(build_scene(max_steps=128), f"{args.models}/dtu_{name}", device)

    def put(path, img):
        if save:
            save_image(f"{args.outputs}/{path}.png", img)

    out = {"spheres": [img.cpu().numpy() for img in sphere_examples(scene.bsdf, size=args.size)],
           "weights": {}, "normals": {}, "render": {}}
    for b, img in enumerate(out["spheres"]):
        put(f"dtu_{name}_sphere_basis_{b}", img)
    make_camera = camera_maker(data)
    for i in range(min(args.views, len(data.images))):
        cam = make_camera([i])
        weights = render_view(scene, cam, BasisBRDF(scene.bsdf), args.size, i, device)
        out["weights"][i] = [weights[..., b:b + 1] for b in range(weights.shape[-1])]
        for b, w in enumerate(out["weights"][i]):
            put(f"dtu_{name}_w{b}_view{i}", w)
        out["normals"][i] = render_view(scene, cam, Debug(), args.size, i, device)
        put(f"dtu_{name}_normals_{i}", out["normals"][i])
        out["render"][i] = render_view(scene, cam, Direct(training=False), args.size, i, device)
        put(f"dtu_{name}_render_{i}", out["render"][i])
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    from ..training import load_dtu
    name = args.data.rstrip("/").split("/")[-1]
    return run(args, load_dtu(args.data, args.size), name)


if __name__ == "__main__":
    main(sys.argv[1:])
