"""NeRV test with multi-light frames: one render a light, summed by weight.

The twin of ``scripts/test_nerv.py`` of the JAX package: load the test
split (``load_nerv(..., "test")``) and the trained scene from
``{models}/nerv_{name}`` (``nerv.build_scene`` under ``nerv.eval_scene``:
128 march steps, ``--shadows`` hard, learned or none, bounded by
``--eval-march-bound``).  A frame's lights are its ``light_loc`` rows; each
light gets one ``pathtrace`` pass with ``Direct(training=False)``,
``PointLights`` set to that location and the generators seeded by the
frame's index, and the passes are summed weighted by the frame's
``light_weights`` (uniformly where the split has none).  Per view: the
L1 and PSNR of the tone-mapped (``x / (1 + x)``) image, clipped to [0, 1]
first, against the tone-mapped ground truth; then their means and the
SSIM over the stack.

    python -m neural_raytracing_tpu_torch.workloads.eval_nerv --data nerv/armadillo

``run`` takes the test split in memory (a ``NeRVDataset``) and a scene
(``build_test_scene`` builds it).  ``--device`` picks the card (default) or the
CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ._common import chunk_for, save_image


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", type=str, required=True)
    ap.add_argument("--size", type=int, default=200, help="image size")
    ap.add_argument("--outputs", type=str, default="outputs")
    ap.add_argument("--models", type=str, default="models")
    ap.add_argument("--dist", type=float, default=2.2)
    ap.add_argument("--shadows", type=str, default="hard", choices=["hard", "learned", "none"])
    ap.add_argument("--eval-march-bound", type=float, default=1.2,
                    help="bounding-sphere clip of the test renders' march (0: none)")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def build_test_scene(args, directory: str):
    """The NeRV test scene of ``--shadows`` and ``--eval-march-bound``,
    loaded from ``directory`` on ``--device``."""
    from .. import training
    from . import nerv
    scene = nerv.build_scene(dist=args.dist)
    scene.init(torch.Generator().manual_seed(0), device=args.device)
    training.load_scene(directory, scene)
    bound = args.eval_march_bound if args.eval_march_bound > 0 else None
    return nerv.eval_scene(scene, args.shadows, bound)


def frame_lights(test, i: int):
    """-> (the frame's light locations ``[L, 3]``, their weights ``[L]``)."""
    locs = np.asarray(test.light_locs[i], np.float32)
    if locs.ndim == 1:
        locs = locs[None]
    if test.light_weights is not None:
        weights = np.atleast_1d(np.asarray(test.light_weights[i], np.float32))
    else:
        weights = np.ones(len(locs)) / len(locs)
    return locs, weights


def render_frame(scene, test, i: int, size: int, device) -> torch.Tensor:
    """The weighted sum of frame ``i``'s single-light renders ``[S, S, 3]``
    (unclipped, on ``device``)."""
    from ..cameras import NeRFCamera
    from ..integrators import Direct
    from ..render import pathtrace
    cam = NeRFCamera(torch.from_numpy(test.cam_to_worlds[i:i + 1]), test.focal)
    acc = None
    for loc, w in zip(*frame_lights(test, i)):
        scene.lights.set_location(loc[None])
        img, _ = pathtrace(scene, cam, Direct(training=False), size=size,
                           chunk_size=chunk_for(size), background=0.0, key=i, device=device)
        contrib = float(w) * img[..., :3]
        acc = contrib if acc is None else acc + contrib
    return acc


@torch.no_grad()
def run(args, test, scene, name: str = "nerv", save: bool = True) -> dict:
    """Render and score every frame of ``test``; the scene's lights are as
    they were on return.  Returns ``{"l1": [V], "psnr": [V], "avg_l1",
    "avg_psnr", "ssim", "images": [V, S, S, 3]}`` (the clipped renders)."""
    from ..ops.math import mse2psnr
    from ..ops.ssim import ssim
    from ..training.eval import restored_parameters

    l1s, psnrs, images, gots, exps = [], [], [], [], []
    with restored_parameters(scene):
        for i in range(len(test.images)):
            got = np.clip(render_frame(scene, test, i, args.size, args.device).cpu().numpy(),
                          0.0, 1.0)
            exp = np.asarray(test.images[i], np.float32)[..., :3]
            images.append(got)
            got_tm, exp_tm = got / (1 + got), exp / (1 + exp)
            l2 = float(np.mean((got_tm - exp_tm) ** 2))
            l1s.append(float(np.mean(np.abs(got_tm - exp_tm))))
            psnrs.append(float(mse2psnr(l2)))
            gots.append(got_tm)
            exps.append(exp_tm)
            if save:
                save_image(f"{args.outputs}/test_nerv_{name}_{i:03}.png", got)
            print(f"view {i:3d} L1 {l1s[-1]:.5f} PSNR {psnrs[-1]:.3f}")
    g = torch.from_numpy(np.stack(gots)).permute(0, 3, 1, 2)
    e = torch.from_numpy(np.stack(exps)).permute(0, 3, 1, 2)
    out = {"l1": l1s, "psnr": psnrs, "avg_l1": float(np.mean(l1s)),
           "avg_psnr": float(np.mean(psnrs)), "ssim": float(ssim(g, e)),
           "images": np.stack(images)}
    print(f"avg L1 {out['avg_l1']:.5f} PSNR {out['avg_psnr']:.3f} SSIM {out['ssim']:.4f}")
    return out


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    from ..training import load_nerv
    name = args.data.rstrip("/").split("/")[-1]
    test = load_nerv(args.data, args.size, "test")
    return run(args, test, build_test_scene(args, f"{args.models}/nerv_{name}"), name)


if __name__ == "__main__":
    main(sys.argv[1:])
