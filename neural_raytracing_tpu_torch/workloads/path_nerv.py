"""Path-traced NeRV relighting: the test views of a trained NeRV scene
rendered by the multi-bounce ``Path`` integrator, each the mean of
``--samples`` independent passes.

The twin of ``scripts/path_nerv.py`` of the JAX package: the NeRV twin's
scene (``workloads.nerv.build_scene``, 128 march steps, bounded by
``--eval-march-bound``, the ``--shadows`` occlusion mode) loaded from
``{models}/nerv_{name}``; each view lit by its own point light; ``Path(
max_depth=--max-depth)``, a bundle of one ray a pixel, background 0; pass
``s`` of view ``i`` seeded ``1000 * i + s``.  Prints each view's L1 and
PSNR and their means; ``--out-json`` writes them.

    python -m neural_raytracing_tpu_torch.workloads.path_nerv --data nerv/armadillo \
        --samples 32

``run`` takes the test split in memory (a ``NeRVDataset``) and a built
scene, so a caller with no PNGs can drive the same path.  ``--device``
picks the card (default) or the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ._common import chunk_for, save_image


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", type=str, required=True)
    ap.add_argument("--size", type=int, default=200, help="image size")
    ap.add_argument("--models", type=str, default="models")
    ap.add_argument("--outputs", type=str, default="outputs")
    ap.add_argument("--samples", type=int, default=32)
    ap.add_argument("--max-depth", type=int, default=2)
    ap.add_argument("--dist", type=float, default=2.2)
    ap.add_argument("--shadows", type=str, default="hard",
                    choices=["hard", "learned", "none"],
                    help="the eval scene's occlusion: marched shadow rays, the "
                         "trained occlusion net, or none")
    ap.add_argument("--stable-min", action="store_true",
                    help="the logsumexp smooth-min (for a model trained with it)")
    ap.add_argument("--eval-march-bound", type=float, default=1.2,
                    help="bounding-sphere clip of the march (0: none)")
    ap.add_argument("--out-json", type=str, default=None,
                    help="write the per-view metrics to this JSON file")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def build_scene(args):
    """The eval scene of the NeRV twin (random weights until loaded)."""
    from .nerv import build_scene as nerv_scene
    bound = args.eval_march_bound if args.eval_march_bound > 0 else None
    return nerv_scene(max_steps=128, dist=args.dist, occlusion=args.shadows,
                      stable_min=args.stable_min, march_bound=bound)


def run(args, test, scene, name: str = "nerv", save: bool = True) -> dict:
    """Render every view of ``test`` (a ``NeRVDataset``) through ``scene``
    on ``args.device``.  ``save`` writes the renders.  Returns ``{"images"
    [V, S, S, 3] (clipped to [0, 1]), "l1", "l2", "psnr" (per view),
    "avg_l1", "avg_l2", "avg_psnr"}``; the scene's parameters are as they
    were."""
    from ..cameras import NeRFCamera
    from ..integrators import Path
    from ..ops.math import mse2psnr
    from ..render import pathtrace
    from ..training.eval import restored_parameters

    integrator = Path(max_depth=args.max_depth, training=False)
    out = {"images": [], "l1": [], "l2": [], "psnr": []}
    for i in range(len(test.images)):
        cam = NeRFCamera(torch.from_numpy(test.cam_to_worlds[i:i + 1]), test.focal)
        with restored_parameters(scene):
            scene.lights.set_location(test.light_locs[i:i + 1])
            acc = None
            for s in range(args.samples):
                img, _ = pathtrace(scene, cam, integrator, size=args.size,
                                   chunk_size=chunk_for(args.size), bundle_size=1,
                                   background=0.0, key=1000 * i + s, device=args.device)
                acc = img if acc is None else acc + img
        got = np.clip(acc.cpu().numpy() / args.samples, 0, 1)[..., :3]
        exp = test.images[i][..., :3]
        l2 = float(np.mean((got - exp) ** 2))
        out["images"].append(got)
        out["l1"].append(float(np.mean(np.abs(got - exp))))
        out["l2"].append(l2)
        out["psnr"].append(float(mse2psnr(l2)))
        if save:
            save_image(f"{args.outputs}/path_nerv_{name}_d{args.max_depth}_{i:03}.png", got)
        print(f"view {i:3d} L1 {out['l1'][-1]:.5f} PSNR {out['psnr'][-1]:.3f}")
    out["images"] = np.stack(out["images"])
    for k in ("l1", "l2", "psnr"):
        out["avg_" + k] = float(np.mean(out[k]))
    print(f"avg L1 {out['avg_l1']:.5f} L2 {out['avg_l2']:.6f} PSNR {out['avg_psnr']:.3f}")
    if args.out_json:
        with open(args.out_json, "w") as f:
            json.dump({"data": args.data, "samples": args.samples,
                       "max_depth": args.max_depth, "shadows": args.shadows,
                       "avg_l1": out["avg_l1"], "avg_psnr": out["avg_psnr"],
                       "per_view_psnr": out["psnr"]}, f, indent=1)
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    from ..training import load_nerv, load_scene
    name = args.data.rstrip("/").split("/")[-1]
    test = load_nerv(args.data, args.size, "test")
    scene = build_scene(args)
    scene.init(torch.Generator().manual_seed(0), device=args.device)
    load_scene(f"{args.models}/nerv_{name}", scene)
    return run(args, test, scene, name)


if __name__ == "__main__":
    main(sys.argv[1:])
