"""Visualize a trained NeRF-synthetic model.

The twin of ``scripts/visualize.py`` of the JAX package: the parameter
counts of the shape, BSDF and lights; up to 9 orbit views
(``Direct``) and their normal maps (``Debug``) at ``--size``; the per-basis
weight maps of view 0 (``BasisBRDF``); each basis rendered on a sphere
(``utils.sphere_examples``).  The scene is ``nerf_synthetic.build_scene
(max_steps=128)`` with seed-0 weights, then ``{models}/{name}``.

    python -m neural_raytracing_tpu_torch.workloads.visualize --data nerf_synthetic/lego

``run`` takes the test split in memory (a ``NeRFDataset``) and returns the
images.  ``--device`` picks the card (default) or the CPU.
"""

from __future__ import annotations

import sys

import torch

from ._common import base_parser, device_of, load_trained, render_view, save_image


def parser():
    ap = base_parser(__doc__.split("\n\n")[0], size=128)
    ap.add_argument("--data", type=str, required=True)
    ap.add_argument("--dataset-name", type=str, default=None)
    ap.add_argument("--n-orbit", type=int, default=9)
    return ap


def run(args, data, name: str, scene=None, save: bool = True, log_fn=print) -> dict:
    """-> ``{"counts": {component: entries}, "orbit": {i: image}, "normals":
    {i: image}, "basis": [weight map], "spheres": [image]}`` (numpy)."""
    from ..cameras import NeRFCamera
    from ..integrators import BasisBRDF, Debug, Direct
    from ..utils import count_parameters, sphere_examples
    from .nerf_synthetic import build_scene
    device = device_of(args)
    if scene is None:
        scene = load_trained(build_scene(max_steps=128), f"{args.models}/{name}", device)
    out = {"counts": {}, "orbit": {}, "normals": {}}
    for comp in ("shape", "bsdf", "lights"):
        part = getattr(scene, comp, None)
        out["counts"][comp] = count_parameters(part) if part is not None else 0
        log_fn(f"{comp} params: {out['counts'][comp]:,}")

    def cam(i):
        return NeRFCamera(torch.from_numpy(data.cam_to_worlds[i:i + 1]), data.focal)

    def put(path, img):
        if save:
            save_image(f"{args.outputs}/{path}.png", img)

    n = min(args.n_orbit * args.n_orbit, len(data.images))
    for i in range(0, n, max(n // 9, 1)):
        out["orbit"][i] = render_view(scene, cam(i), Direct(training=False), args.size, i,
                                      device)
        put(f"vis_{name}_orbit_{i:03}", out["orbit"][i])
        out["normals"][i] = render_view(scene, cam(i), Debug(), args.size, i, device)
        put(f"vis_{name}_normals_{i:03}", out["normals"][i])
    weights = render_view(scene, cam(0), BasisBRDF(scene.bsdf), args.size, 0, device)
    out["basis"] = [weights[..., b:b + 1] for b in range(weights.shape[-1])]
    for b, w in enumerate(out["basis"]):
        put(f"vis_{name}_basis_{b}", w)
    out["spheres"] = [img.cpu().numpy() for img in sphere_examples(scene.bsdf, size=args.size)]
    for b, img in enumerate(out["spheres"]):
        put(f"vis_{name}_sphere_basis_{b}", img)
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    from ..training import load_nerf_synthetic
    name = args.dataset_name or args.data.rstrip("/").split("/")[-1]
    return run(args, load_nerf_synthetic(args.data, args.size, "test"), name)


if __name__ == "__main__":
    main(sys.argv[1:])
