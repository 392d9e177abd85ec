"""Visualize a trained NeRV model.

The twin of ``scripts/nerv_vis.py`` of the JAX package: each basis of the
BSDF rendered on a sphere (``utils.sphere_examples``), then for the first
``--views`` training views the per-basis weight maps (``BasisBRDF``), the
normal map (``Debug``) and the silhouette (``Silhouette``).  The scene is
``nerv.build_scene(max_steps=128, dist=--dist)`` with seed-0 weights, then
``{models}/nerv_{name}``.  Like the JAX script it renders no depth.

    python -m neural_raytracing_tpu_torch.workloads.nerv_vis --data nerv/armadillo

``run`` takes the split in memory (a ``NeRVDataset``) and returns the
images.  ``--device`` picks the card (default) or the CPU.
"""

from __future__ import annotations

import sys

import torch

from ._common import base_parser, device_of, load_trained, render_view, save_image


def parser():
    ap = base_parser(__doc__.split("\n\n")[0], size=128)
    ap.add_argument("--data", type=str, required=True)
    ap.add_argument("--dist", type=float, default=2.2)
    ap.add_argument("--views", type=int, default=4)
    return ap


def run(args, data, name: str, scene=None, save: bool = True) -> dict:
    """-> ``{"spheres": [image], "weights": {i: [weight map]}, "normals":
    {i: image}, "sil": {i: image}}`` (numpy)."""
    from ..cameras import NeRFCamera
    from ..integrators import BasisBRDF, Debug, Silhouette
    from ..utils import sphere_examples
    from .nerv import build_scene
    device = device_of(args)
    if scene is None:
        scene = load_trained(build_scene(max_steps=128, dist=args.dist),
                             f"{args.models}/nerv_{name}", device)

    def put(path, img):
        if save:
            save_image(f"{args.outputs}/{path}.png", img)

    out = {"spheres": [img.cpu().numpy() for img in sphere_examples(scene.bsdf, size=args.size)],
           "weights": {}, "normals": {}, "sil": {}}
    for b, img in enumerate(out["spheres"]):
        put(f"nerv_{name}_sphere_basis_{b}", img)
    for i in range(min(args.views, len(data.images))):
        cam = NeRFCamera(torch.from_numpy(data.cam_to_worlds[i:i + 1]), data.focal)
        weights = render_view(scene, cam, BasisBRDF(scene.bsdf), args.size, i, device)
        out["weights"][i] = [weights[..., b:b + 1] for b in range(weights.shape[-1])]
        for b, w in enumerate(out["weights"][i]):
            put(f"nerv_{name}_w{b}_view{i}", w)
        for integ, tag in ((Debug(), "normals"), (Silhouette(), "sil")):
            out[tag][i] = render_view(scene, cam, integ, args.size, i, device)
            put(f"nerv_{name}_{tag}_{i}", out[tag][i])
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    from ..training import load_nerv
    name = args.data.rstrip("/").split("/")[-1]
    return run(args, load_nerv(args.data, args.size, "train"), name)


if __name__ == "__main__":
    main(sys.argv[1:])
