"""Scene editing on a trained DTU scene: SDF warps and a BSDF swap.

The twin of ``scripts/edit_dtu.py`` of the JAX package: rebuild the scene
of ``dtu.build_scene(max_steps=128)``, load it from ``{models}/dtu_{name}``,
then
  * ``--edit bend``: bend the surface about axis 2 by ``--bend-k``
    (``SDF.with_warp``); ``--edit disp``: displace it
    (``SDF(EditedModule(...))`` with only ``epsilon``, ``max_steps``,
    ``dist`` and ``throughput_steps`` carried over); ``--edit none``;
  * ``--recolor i``: swap basis ``i`` of the ``ComposeSpatialVarying``
    mixture for a flat ``Diffuse((1.0, 0.3, 0.1))``, the other bases and
    the weight net kept;
and render the first ``--views`` views with ``Direct(training=False)`` and
with ``Debug`` (the normals), each view's generators seeded by its index.
The scan loads with ``load_dtu``'s default source size, as the JAX script
does (ROADMAP.md, Queue 3's watch item).

    python -m neural_raytracing_tpu_torch.workloads.edit_dtu --data DTU/scan97 --edit bend

``run`` takes the scan in memory (a ``DTUDataset``).  ``--device`` picks
the card (default) or the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ._common import save_image


def apply_edit(sdf, edit: str, bend_k: float = -10.0):
    """The SDF ``edit`` makes of ``sdf`` (``scripts/edit_dtu.py:55-61``)."""
    from .. import edits
    if edit == "bend":
        return sdf.with_warp(edits.bend(k=bend_k, axis=2))
    if edit == "disp":
        return edits.value_edited(sdf, edits.displace)
    if edit != "none":
        raise ValueError(f"unknown edit {edit!r}")
    return sdf


def recolor(scene, i: int):
    """``scene`` with basis ``i`` of its mixture swapped for a flat
    ``Diffuse((1.0, 0.3, 0.1))`` on the scene's device."""
    from ..bsdf import ComposeSpatialVarying, Diffuse
    device = next(scene.parameters()).device
    bases = list(scene.bsdf.bsdfs)
    bases[i] = Diffuse((1.0, 0.3, 0.1)).to(device)
    return scene.replace(bsdf=ComposeSpatialVarying(bases, sp_var_fn=scene.bsdf.sp_var_fn))


def edited_scene(args, name: str):
    """The DTU scene with 128 march steps, loaded from ``{models}/dtu_{name}``
    on ``--device``, under ``--edit`` and ``--recolor``."""
    from ..training import load_scene
    from . import dtu
    scene = dtu.build_scene(max_steps=128)
    scene.init(torch.Generator().manual_seed(0), device=args.device)
    load_scene(f"{args.models}/dtu_{name}", scene)
    scene = scene.replace(shape=apply_edit(scene.shape, args.edit, args.bend_k))
    return recolor(scene, args.recolor) if args.recolor >= 0 else scene


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", type=str, required=True)
    ap.add_argument("--size", type=int, default=128, help="image size")
    ap.add_argument("--outputs", type=str, default="outputs")
    ap.add_argument("--models", type=str, default="models")
    ap.add_argument("--edit", type=str, default="bend", choices=["none", "bend", "disp"])
    ap.add_argument("--bend-k", type=float, default=-10.0)
    ap.add_argument("--recolor", type=int, default=-1,
                    help="swap basis i for a flat diffuse colour")
    ap.add_argument("--views", type=int, default=4)
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def run(args, data, name: str, save: bool = True) -> dict:
    """Render the edited scene's first ``--views`` views of ``data``.
    Returns ``{"render": [V, S, S, 3], "normals": [V, S, S, 3]}``."""
    from ..cameras import DTUCamera
    from ..integrators import Debug, Direct
    from ..render import pathtrace

    scene = edited_scene(args, name)
    out = {"render": [], "normals": []}
    for i in range(min(args.views, len(data.images))):
        cam = DTUCamera(torch.from_numpy(data.poses[i:i + 1]),
                        torch.from_numpy(data.intrinsics[i:i + 1]), data.src_size)
        for integrator, tag in ((Direct(training=False), "render"), (Debug(), "normals")):
            img, _ = pathtrace(scene, cam, integrator, size=args.size, chunk_size=args.size,
                               background=0.0, key=i, device=args.device)
            img = img.cpu().numpy()
            out[tag].append(img)
            if save:
                save_image(f"{args.outputs}/edit_dtu_{name}_{args.edit}_{tag}_{i}.png", img)
    return {tag: np.stack(v) for tag, v in out.items()}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    from ..training import load_dtu
    name = args.data.rstrip("/").split("/")[-1]
    return run(args, load_dtu(args.data, args.size), name)


if __name__ == "__main__":
    main(sys.argv[1:])
