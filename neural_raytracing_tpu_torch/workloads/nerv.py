"""NeRV relighting: training with per-frame point lights and learned
occlusion, then a test with soft (learned) and hard shadows.

The twin of ``scripts/nerv.py`` of the JAX package: ``transforms_train.json``
with a ``light_loc`` per frame; ``SDF(SphereSDF)`` (or ``FusedSphereSDF``
with ``--fused-sdf``) + ``ComposeSpatialVarying`` over 7 ``NeuralBSDF``
lobes + ``PointLights(scale=100)`` whose location is set per step from the
frames' lights; learned-occlusion emitter sampling; a tone-mapped loss on
mask-centred crops; the test renders every test view twice, with the
occlusion MLP and with hard shadows.

    python -m neural_raytracing_tpu_torch.workloads.nerv --data nerv/armadillo

``--device-data`` trains on the on-device data path: the views, crops,
cameras and each frame's light drawn on the device.  ``run`` takes the
train and test splits in memory (``NeRVDataset``s), so a caller with no
PNGs, or no PIL, can drive the same path.  Not carried over from the JAX
script: ``--train-integrator path`` (the ``Path`` integrator is not ported,
Queue 1 item 4) and ``--data-parallel`` (item 8).  ``--device`` picks the
card (default) or the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ._common import chunk_for, save_image


def build_scene(max_steps: int = 64, dist: float = 2.2,
                occlusion: str = "learned", stable_min: bool = False,
                march_bound=None, fused_sdf: bool = False):
    """The NeRV scene of ``scripts/nerv.py`` (random weights until loaded)."""
    from .. import Scene
    from ..bsdf import ComposeSpatialVarying, NeuralBSDF
    from ..kernels import FusedSphereSDF
    from ..lights import PointLights
    from ..shapes import SDF, SphereSDF

    surface = (FusedSphereSDF(n=128, stable_min=stable_min) if fused_sdf
               else SphereSDF(n=128, stable_min=stable_min))
    return Scene(
        shape=SDF(surface, max_steps=max_steps, throughput_steps=128, dist=dist,
                  march_bound=march_bound),
        bsdf=ComposeSpatialVarying(
            [NeuralBSDF(activation="softplus") for _ in range(7)]),
        lights=PointLights(scale=100.0),
        occlusion=occlusion)


def eval_scene(scene, occlusion: str, march_bound=None):
    """The test scene over the trained scene's parameters: 128 march steps,
    the given occlusion mode and march bound."""
    return scene.replace(occlusion=occlusion,
                         shape=scene.shape.replace(max_steps=128,
                                                   march_bound=march_bound))


def make_space_reg(eikonal: float, repulsion: float, alpha: float):
    """A full-space regularizer at 1024 fresh uniform points in
    [-1.25, 1.25]^3 per step: ``eikonal * (|grad f| - 1)^2`` and
    ``repulsion * exp(-alpha |f|)``, both means."""
    from ..ops.math import absolute, eikonal_loss

    def space_reg(scene, generator):
        device = scene.lights.location.device
        if generator is None:
            u = torch.rand(1024, 3, device=device)
        else:
            u = torch.rand(1024, 3, generator=generator, device=generator.device)
        pts = (2.5 * u - 1.25).to(device).requires_grad_()
        vals = scene.shape.sdf(pts)
        (grads,) = torch.autograd.grad(vals.sum(), pts, create_graph=True)
        reg = 0.0
        if eikonal > 0:
            reg = reg + eikonal * eikonal_loss(grads)
        if repulsion > 0:
            reg = reg + repulsion * torch.mean(torch.exp(-alpha * absolute(vals)))
        return reg

    return space_reg


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", type=str, required=True)
    ap.add_argument("--size", type=int, default=200, help="image size")
    ap.add_argument("--iters", type=int, default=25_000)
    ap.add_argument("--crop-size", type=int, default=64)
    ap.add_argument("--n-views", type=int, default=3)
    ap.add_argument("--outputs", type=str, default="outputs")
    ap.add_argument("--models", type=str, default="models")
    ap.add_argument("--load", action="store_true",
                    help="resume from saved scene artifacts")
    ap.add_argument("--clip-norm", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--skip-test", action="store_true")
    ap.add_argument("--eval-march-bound", type=float, default=1.2,
                    help="bounding-sphere clip of the test renders' march "
                         "(0: none)")
    ap.add_argument("--nan-skip", action="store_true",
                    help="skip, not raise on, non-finite-loss steps")
    ap.add_argument("--no-ssim", action="store_true")
    ap.add_argument("--surface-lr", type=float, default=4e-5)
    ap.add_argument("--bsdf-lr", type=float, default=4e-5)
    ap.add_argument("--light-lr", type=float, default=4e-5)
    ap.add_argument("--dist", type=float, default=2.2)
    ap.add_argument("--stable-min", action="store_true",
                    help="exact logsumexp smooth-min")
    ap.add_argument("--fused-sdf", action="store_true",
                    help="the surface as FusedSphereSDF (K5)")
    ap.add_argument("--space-eikonal", type=float, default=0.0,
                    help="weight of a full-space eikonal term (0: off)")
    ap.add_argument("--space-repulsion", type=float, default=0.0,
                    help="weight of an off-surface repulsion term (0: off)")
    ap.add_argument("--repulsion-alpha", type=float, default=100.0)
    ap.add_argument("--calibrate-exposure", action="store_true",
                    help="calibrate the light scale even with --load")
    ap.add_argument("--no-calibrate-exposure", action="store_true")
    ap.add_argument("--device-data", action="store_true",
                    help="the on-device data path: views, crops, cameras and each "
                         "frame's light drawn on the device")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def run(args, data, test=None, name: str = "nerv", save: bool = True):
    """Train on ``data`` (a ``NeRVDataset``), then, given ``test``, test in
    both shadow modes.  ``save`` writes the scene artifacts, the metrics and
    the renders.  Returns ``(state, results)``: ``results["losses"]``, a
    metrics dict per shadow mode (``"soft"``, ``"hard"``) and its renders
    (``"soft_images"``, ``"hard_images"``)."""
    from ..cameras import NeRFCamera
    from ..integrators import Direct
    from ..training import (
        calibrate_exposure, device_dataset, evaluate, init_train_state, load_scene,
        make_optimizer, rand_uv_mask, save_scene, train,
    )

    scene = build_scene(dist=args.dist, stable_min=args.stable_min,
                        fused_sdf=args.fused_sdf)
    opt = make_optimizer({"shape": args.surface_lr, "bsdf": args.bsdf_lr,
                          "lights": args.light_lr, "occ": args.bsdf_lr},
                         clip_norm=args.clip_norm)
    state = init_train_state(scene, opt, torch.Generator().manual_seed(args.seed),
                             device=args.device)
    model_dir = f"{args.models}/nerv_{name}"
    if args.load:
        load_scene(model_dir, scene)

    def make_camera(idxs):
        return NeRFCamera(torch.from_numpy(data.cam_to_worlds[np.asarray(idxs)]),
                          data.focal)

    def light_update(scene_, camera, idxs):
        # the per-frame point light of each view in the batch
        scene_.lights.set_location(data.light_locs[np.asarray(idxs)])

    if (args.iters > 0 and not args.no_calibrate_exposure
            and (args.calibrate_exposure or not args.load)):
        state, _ = calibrate_exposure(
            scene, state, make_camera, data.images, data.masks, size=args.size,
            chunk_size=chunk_for(args.size), light_update=light_update)

    metrics: list = []

    def flush_metrics():
        if save:
            os.makedirs(args.outputs, exist_ok=True)
            with open(os.path.join(args.outputs, f"metrics_nerv_{name}.jsonl"), "w") as f:
                f.writelines(json.dumps(m) + "\n" for m in metrics)

    device_data = camera_builder = None
    if args.device_data:
        device_data = device_dataset(data.images, data.masks, data.cam_to_worlds,
                                     args.crop_size, light_locs=data.light_locs,
                                     device=args.device)
        camera_builder = lambda c: NeRFCamera(c, data.focal)

    results: dict = {}
    if args.iters > 0:
        space_reg = None
        if args.space_eikonal > 0 or args.space_repulsion > 0:
            space_reg = make_space_reg(args.space_eikonal, args.space_repulsion,
                                       args.repulsion_alpha)
        generator = torch.Generator(device=args.device).manual_seed(args.seed + 1)
        state, results["losses"] = train(
            scene, Direct(training=True), opt, state, make_camera, data.images,
            data.masks, generator, size=args.size, crop_size=args.crop_size,
            iters=args.iters, n_views=args.n_views,
            nan_policy="skip" if args.nan_skip else "raise",
            with_ssim=not args.no_ssim, uv_select=rand_uv_mask,
            space_reg=space_reg, tone_mapping=True, light_update=light_update,
            log_every=args.log_every, metrics=metrics, device_data=device_data,
            camera_builder=camera_builder,
            save_fn=(lambda st, i: (save_scene(model_dir, st.scene, step=st.step),
                                    flush_metrics())) if save else None,
            ckpt_freq=max(args.iters // 5 - 1, 1))
        if save:
            save_scene(model_dir, scene, step=state.step)
        flush_metrics()

    if test is None:
        return state, results

    def eval_light_update(scene_, camera, i):
        scene_.lights.set_location(test.light_locs[i:i + 1])

    bound = args.eval_march_bound if args.eval_march_bound > 0 else None
    for shadows, tag in (("learned", "soft"), ("hard", "hard")):
        print(f"NeRV test with {tag} shadows")
        images = results[tag + "_images"] = []

        def save_test(i, im, tag=tag, images=images):
            images.append(im)
            if save:
                save_image(f"{args.outputs}/nerv_{name}_{tag}_{i:03}.png", im)

        results[tag] = evaluate(
            eval_scene(scene, shadows, bound),
            lambda i: NeRFCamera(torch.from_numpy(test.cam_to_worlds[i:i + 1]),
                                 test.focal),
            test.images, Direct(training=False), size=args.size,
            chunk_size=chunk_for(args.size), tone_map=True,
            with_ms_ssim=args.size > 160, light_update=eval_light_update,
            save_fn=save_test)
        results[tag + "_images"] = np.stack(images)
        metrics.append({"step": int(state.step), "test_" + tag: results[tag]})
    flush_metrics()
    return state, results


def main(argv=None):
    args = parser().parse_args(argv)
    from ..training import load_nerv
    name = args.data.rstrip("/").split("/")[-1]
    data = load_nerv(args.data, args.size, "train")
    test = None if args.skip_test else load_nerv(args.data, args.size, "test")
    state, results = run(args, data, test, name)
    # main returns the test's metrics only
    return state, {tag: results[tag] for tag in ("soft", "hard") if tag in results}


if __name__ == "__main__":
    main(sys.argv[1:])
