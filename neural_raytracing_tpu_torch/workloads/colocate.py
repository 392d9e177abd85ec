"""Colocated camera + light reconstruction.

The twin of ``scripts/colocate.py`` of the JAX package: the 8 x 8
elevation x azimuth grid ``{kind}_{i}_{j}.png`` at distance 1 (as
``workloads.make_dataset`` writes it); ``SDF(SphereSDF(128))`` +
``ComposeSpatialVarying([NeuralBSDF x 2, Diffuse, Conductor])`` + a
learnable ``PointLights(scale=light_scale)`` moved to 1.05 x each view's
camera centre before every step; learned-occlusion emitter sampling (the
occlusion MLP takes 5 inputs); the eikonal term plus a weight-diversity
term; mask-centred crops.  Then the test renders the first 8 views with
hard shadows at 128 march steps, and with ``--relight-data`` the 4 x 4
camera x 3 x 3 light grid ``gt_{kind}_{i}_{j}_{k}_{l}.png`` with its PSNR.

    python -m neural_raytracing_tpu_torch.workloads.colocate --data outputs/cbox \
        --kind bunny --size 200

``--device`` picks the card (default) or the CPU.  ``run`` takes the data in
memory (a ``ColocateDataset`` and a relight dict), so a caller with no PNGs,
or no PIL, can drive the same path.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np
import torch

from ._common import chunk_for, save_image


def build_scene(max_steps: int = 64, stable_init: bool = False,
                light_scale: float = 5.0):
    """The scene of ``scripts/colocate.py`` (random weights until loaded).
    ``stable_init`` zeroes the weight net's output layer, so the mixture
    weights start at 0.5 everywhere."""
    from .. import Scene
    from ..bsdf import ComposeSpatialVarying, Conductor, Diffuse, NeuralBSDF
    from ..kernels import FusedSkipConnMLP
    from ..lights import PointLights
    from ..shapes import SDF, SphereSDF

    bases = [NeuralBSDF(activation="softplus"), NeuralBSDF(activation="softplus"),
             Diffuse(), Conductor()]
    sp_var_fn = None
    if stable_init:
        sp_var_fn = FusedSkipConnMLP(
            in_size=3, out=len(bases), num_layers=16, hidden_size=256,
            freqs=128, sigma=128.0, init="xavier", zero_out=True)
    return Scene(
        shape=SDF(SphereSDF(n=128), max_steps=max_steps, throughput_steps=128,
                  dist=2.2),
        bsdf=ComposeSpatialVarying(bases, sp_var_fn=sp_var_fn),
        lights=PointLights(scale=light_scale),
        occlusion="learned")


def eval_scene(scene):
    """The test scene over ``scene``'s parameters: hard shadows, 128 march
    steps."""
    return scene.replace(occlusion="hard", shape=scene.shape.replace(max_steps=128))


def make_light_update(centers: np.ndarray):
    """``light_update(scene, camera, idxs)``: the light at 1.05 x the camera
    centre of each view in ``idxs``."""
    def light_update(scene, camera, idxs):
        scene.lights.set_location(centers[np.asarray(idxs)] * 1.05)
    return light_update


def extra_loss(it, got, exp, mask):
    """The eikonal term plus ``1e-2 * mean(std)`` of the mixture weights
    over the lobes.  The standard deviation is a clamped square root of the
    population variance: at a zero-out init the variance is exactly 0, where
    a plain square root's gradient would be NaN."""
    from ..ops.math import eikonal_loss, maximum
    loss = eikonal_loss(it.raw_normals)
    if it.normalized_weights is not None:
        var = torch.var(it.normalized_weights, dim=-1, correction=0)
        loss = loss + 1e-2 * torch.mean(torch.sqrt(maximum(var, 1e-12)))
    return loss


def relight_psnrs(scene, grid: dict, *, size: int, device="cuda",
                  save_fn=None) -> list:
    """Render each view of the relight ground truth ``grid`` (``{(i, j, k,
    l): image}``) with ``scene`` and return their PSNRs, in sorted order.
    The light's location is restored afterwards."""
    from ..integrators import Direct
    from ..ops.math import mse2psnr
    from ..render import pathtrace
    from ..training.eval import restored_parameters
    from .make_dataset import CAM_AZIMS, CAM_ELEVS, camera_at, relight_light

    psnrs = []
    with restored_parameters(scene.lights):
        for (i, j, k, l), gt in sorted(grid.items()):
            scene.lights.set_location(relight_light(k, l))
            img, _ = pathtrace(scene, camera_at(1.0, CAM_ELEVS[i], CAM_AZIMS[j]),
                               Direct(training=False), size=size,
                               chunk_size=chunk_for(size), background=0.0,
                               key=i * 64 + j, device=device)
            got = np.clip(img.cpu().numpy()[..., :3], 0.0, 1.0)
            l2 = max(float(np.mean((got - np.asarray(gt)[..., :3]) ** 2)), 1e-10)
            psnrs.append(float(mse2psnr(l2)))
            if save_fn is not None:
                save_fn((i, j, k, l), got)
    return psnrs


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", type=str, required=True)
    ap.add_argument("--kind", type=str, default="bunny",
                    help="dataset object name ({kind}_{i}_{j}.png files)")
    ap.add_argument("--size", type=int, default=200, help="image size")
    ap.add_argument("--iters", type=int, default=25_000)
    ap.add_argument("--crop-size", type=int, default=64)
    ap.add_argument("--n-views", type=int, default=4)
    ap.add_argument("--n-elev", type=int, default=8)
    ap.add_argument("--n-azim", type=int, default=8)
    ap.add_argument("--outputs", type=str, default="outputs")
    ap.add_argument("--models", type=str, default="models")
    ap.add_argument("--load", action="store_true",
                    help="resume from saved scene artifacts")
    ap.add_argument("--clip-norm", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--skip-test", action="store_true")
    ap.add_argument("--nan-skip", action="store_true",
                    help="skip, not raise on, non-finite-loss steps")
    ap.add_argument("--data-parallel", action="store_true",
                    help="accepted and ignored, as the JAX script does")
    ap.add_argument("--stable-init", action="store_true",
                    help="zero-out weight-net head (collapse-resistant)")
    ap.add_argument("--light-scale", type=float, default=5.0,
                    help="initial learnable light scale")
    ap.add_argument("--relight-data", type=str, default=None,
                    help="directory of the gt_{kind}_{i}_{j}_{k}_{l}.png relight grid")
    ap.add_argument("--no-ssim", action="store_true",
                    help="drop the -log SSIM colour-loss term")
    ap.add_argument("--surface-lr", type=float, default=8e-5)
    ap.add_argument("--bsdf-lr", type=float, default=8e-5)
    ap.add_argument("--light-lr", type=float, default=8e-5)
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def run(args, data, relight: Optional[dict] = None, save: bool = True):
    """Train on ``data`` (a ``ColocateDataset``), then the hard-shadow test
    and, given ``relight`` (``{(i, j, k, l): image}``), the relight grid.
    ``save`` writes the scene artifacts and the renders.  Returns ``(state,
    results)``: ``results["test"]`` the test metrics and ``results
    ["test_images"]`` its renders, ``results["relight_psnrs"]`` the grid's
    PSNRs."""
    from ..cameras import FoVPerspectiveCamera
    from ..integrators import Direct
    from ..training import (
        evaluate, init_train_state, load_scene, make_optimizer, rand_uv_mask,
        save_scene, train,
    )
    from .nerfle import colocate_cameras

    cams = colocate_cameras(data)
    centers = cams.camera_center().numpy()
    scene = build_scene(stable_init=args.stable_init, light_scale=args.light_scale)
    opt = make_optimizer({"shape": args.surface_lr, "bsdf": args.bsdf_lr,
                          "lights": args.light_lr, "occ": args.bsdf_lr},
                         clip_norm=args.clip_norm)
    state = init_train_state(scene, opt, torch.Generator().manual_seed(args.seed),
                             device=args.device)
    model_dir = f"{args.models}/colocate_{args.kind}"
    if args.load:
        load_scene(model_dir, scene)

    def make_camera(idxs):
        idxs = torch.as_tensor(np.asarray(idxs))
        return FoVPerspectiveCamera(R=cams.R[idxs], T=cams.T[idxs])

    light_update = make_light_update(centers)
    results: dict = {}
    if args.iters > 0:
        generator = torch.Generator(device=args.device).manual_seed(args.seed + 1)
        state, losses = train(
            scene, Direct(training=True), opt, state, make_camera, data.images,
            data.masks, generator, size=args.size, crop_size=args.crop_size,
            iters=args.iters, n_views=args.n_views,
            nan_policy="skip" if args.nan_skip else "raise",
            with_ssim=not args.no_ssim, uv_select=rand_uv_mask,
            light_update=light_update, extra_loss=extra_loss,
            log_every=args.log_every,
            save_fn=(lambda st, i: save_scene(model_dir, st.scene, step=st.step))
            if save else None,
            ckpt_freq=max(args.iters // 5 - 1, 1))
        results["losses"] = losses
        if save:
            save_scene(model_dir, scene, step=state.step)

    if not args.skip_test:
        images = []

        def save_test(i, im):
            images.append(im)
            if save:
                save_image(f"{args.outputs}/colocate_{args.kind}_test_{i:02}.png", im)

        results["test"] = evaluate(
            eval_scene(scene), lambda i: make_camera([i]), data.images[:8],
            Direct(training=False), size=args.size, chunk_size=chunk_for(args.size),
            light_update=lambda sc, cam, i: light_update(sc, cam, [i]),
            save_fn=save_test)
        results["test_images"] = np.stack(images)

    if relight:
        def save_relight(ijkl, got):
            save_image(f"{args.outputs}/relight_{args.kind}_"
                       f"{'_'.join(map(str, ijkl))}.png", got)

        psnrs = relight_psnrs(eval_scene(scene), relight, size=args.size,
                              device=args.device, save_fn=save_relight if save else None)
        results["relight_psnrs"] = psnrs
        print(f"relight grid: {len(psnrs)} renders, avg PSNR {np.mean(psnrs):.3f}")
    return state, results


def main(argv=None):
    args = parser().parse_args(argv)
    from ..training import load_colocate, load_colocate_relight_grid
    data = load_colocate(args.data, args.kind, args.size, n_elev=args.n_elev,
                         n_azim=args.n_azim)
    relight = None
    if args.relight_data is not None:
        relight = load_colocate_relight_grid(args.relight_data, args.kind, args.size)
    return run(args, data, relight)


if __name__ == "__main__":
    main(sys.argv[1:])
