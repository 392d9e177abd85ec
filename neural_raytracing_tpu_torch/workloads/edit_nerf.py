"""Test-split evaluation of a trained flagship scene, optionally edited.

The twin of ``scripts/test_nerf.py`` of the JAX package: rebuild the scene
of ``nerf_synthetic.build_scene`` with ``--test-max-steps`` march steps,
load its artifacts from ``{models}/{name}``, apply ``--edit`` to the
surface, then run ``training.evaluate`` with ``Direct(training=False)`` on
the NeRF-layout test split.  The edits (``edits.py``):
  * ``bend``, ``trans``, ``scale_z``: a point warp (``SDF.with_warp``) over
    the same SDF, its other settings kept;
  * ``hole``, ``disp``: a value edit, the surface rebuilt as
    ``SDF(EditedModule(...))`` with only ``epsilon``, ``max_steps``,
    ``dist`` and ``throughput_steps`` carried over, as the JAX script does;
  * ``none``: the loaded scene as it is.
An edited surface marches by the plain loops (no K2), its shift net and the
shading nets still through K1.

    python -m neural_raytracing_tpu_torch.workloads.edit_nerf \
        --data nerf_synthetic/lego --edit bend

``run`` takes the test split in memory (a ``NeRFDataset``).  ``--device``
picks the card (default) or the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ._common import chunk_for, save_image

EDITS = ("none", "bend", "trans", "hole", "scale_z", "disp")


def apply_edit(sdf, edit: str, bend_k: float = 2.5):
    """The SDF ``edit`` makes of ``sdf`` (``scripts/test_nerf.py:46-63``)."""
    from .. import edits
    if edit == "bend":
        return sdf.with_warp(edits.bend(k=bend_k))
    if edit == "trans":
        return sdf.with_warp(edits.translate_above(a=0.1))
    if edit == "scale_z":
        return sdf.with_warp(edits.scale_axis(s=0.2))
    if edit in ("hole", "disp"):
        return edits.value_edited(sdf, edits.add_hole if edit == "hole" else edits.displace)
    if edit != "none":
        raise ValueError(f"unknown edit {edit!r}")
    return sdf


def edited_scene(args, name: str):
    """The flagship scene with ``--test-max-steps`` steps, loaded from
    ``{models}/{name}`` on ``--device``, under ``--edit``."""
    from ..training import load_scene
    from . import nerf_synthetic
    scene = nerf_synthetic.build_scene(max_steps=args.test_max_steps)
    scene.init(torch.Generator().manual_seed(0), device=args.device)
    load_scene(f"{args.models}/{name}", scene)
    return scene.replace(shape=apply_edit(scene.shape, args.edit, args.bend_k))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", type=str, required=True,
                    help="dataset dir with transforms_test.json")
    ap.add_argument("--dataset-name", type=str, default=None)
    ap.add_argument("--size", type=int, default=256, help="image size")
    ap.add_argument("--outputs", type=str, default="outputs")
    ap.add_argument("--models", type=str, default="models")
    ap.add_argument("--edit", type=str, default="none", choices=list(EDITS))
    ap.add_argument("--bend-k", type=float, default=2.5)
    ap.add_argument("--test-max-steps", type=int, default=256)
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def run(args, test, name: str, save: bool = True) -> dict:
    """Evaluate the edited scene on ``test`` (a ``NeRFDataset``).  Returns
    ``evaluate``'s metrics with the renders under ``"images"``."""
    from ..cameras import NeRFCamera
    from ..integrators import Direct
    from ..training import evaluate

    scene = edited_scene(args, name)
    images = []

    def save_fn(i, im):
        images.append(im)
        if save:
            save_image(f"{args.outputs}/edit_{args.edit}_{name}_{i:03}.png", im)

    out = evaluate(
        scene, lambda i: NeRFCamera(torch.from_numpy(test.cam_to_worlds[i:i + 1]), test.focal),
        test.images, Direct(training=False), size=args.size,
        chunk_size=chunk_for(args.size), save_fn=save_fn)
    out["images"] = np.stack(images)
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    from ..training import load_nerf_synthetic
    name = args.dataset_name or args.data.rstrip("/").split("/")[-1]
    return run(args, load_nerf_synthetic(args.data, args.size, "test"), name)


if __name__ == "__main__":
    main(sys.argv[1:])
