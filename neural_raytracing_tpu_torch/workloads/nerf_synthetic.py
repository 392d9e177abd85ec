"""NeRF-synthetic reconstruction (the flagship workload).

The twin of ``scripts/nerf_synthetic.py`` of the JAX package:
``SDF(SphereSDF(128))`` + ``ComposeSpatialVarying`` over 8
``NeuralBSDF(softplus)`` lobes + a learned ``LightField`` under the
``Direct`` integrator; AdamW per component (surface 8e-5, BSDF 8e-4, light
8e-5); the eikonal term; 6 views x 80^2 crops, uniform (``--mask-crops``:
centred on mask pixels), 64 march steps in training and 256 at test; a
validation render and PSNR every ``--valid-freq`` steps; then the test
split.  ``--half-res-throughput`` runs the silhouette min-scan on the
2x-subsampled crop; ``--half-res-warmup N`` does so for the first N steps
only.  ``--device-data`` trains on the on-device data path.
``--surface hash`` swaps the surface for ``HashSDF()`` (a hash-encoded
grid and a 2 x 64 relu net), which the kernels do not march: its march
and min-scan are the plain loops, as in the JAX package.

    python -m neural_raytracing_tpu_torch.workloads.nerf_synthetic \
        --data nerf_synthetic/lego --size 256

``run`` takes the splits in memory (``NeRFDataset``s).  ``--device`` picks
the card (default) or the CPU.  ``--data-parallel`` trains over the ranks of
``parallel.make_mesh()``: a world of one in one process, or one process a
card under ``torchrun --nproc_per_node=N`` (each rank on
``cuda:LOCAL_RANK``; only rank 0 logs, validates, saves and tests).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ._common import chunk_for, save_image


def build_scene(max_steps: int = 64, surface: str = "spheres", stable_init: bool = False,
                stable_min: bool = False, throughput_mode: str = "full",
                march_bound=None):
    """The scene of ``scripts/nerf_synthetic.py`` (random weights until
    loaded).  ``stable_init`` zeroes the weight net's output layer, so the
    mixture weights start at 0.5 everywhere."""
    from .. import Scene
    from ..bsdf import ComposeSpatialVarying, NeuralBSDF
    from ..kernels import FusedSkipConnMLP
    from ..lights import LightField
    from ..nn import HashSDF
    from ..shapes import SDF, SphereSDF
    module = HashSDF() if surface == "hash" else SphereSDF(n=128, stable_min=stable_min)
    sp_var_fn = None
    if stable_init:
        sp_var_fn = FusedSkipConnMLP(in_size=3, out=8, num_layers=16, hidden_size=256,
                                     freqs=128, sigma=128.0, init="xavier", zero_out=True)
    return Scene(
        shape=SDF(module, max_steps=max_steps,
                  throughput_steps=128, dist=2.2, throughput_mode=throughput_mode,
                  march_bound=march_bound),
        bsdf=ComposeSpatialVarying([NeuralBSDF(activation="softplus") for _ in range(8)],
                                   sp_var_fn=sp_var_fn),
        lights=LightField())


def make_extra_loss(weight_reg: float = 0.0, sat_guard: float = 0.0):
    """The eikonal term, plus ``weight_reg * mean(std)`` of the mixture
    weights over the lobes and ``sat_guard * mean(softplus(-(raw + 6)))`` of
    their logits where those are on."""
    import torch.nn.functional as F

    from ..ops.math import eikonal_loss, maximum

    def extra_loss(it, got, exp, mask):
        loss = eikonal_loss(it.raw_normals)
        if weight_reg and it.normalized_weights is not None:
            var = torch.var(it.normalized_weights, dim=-1, correction=0)
            loss = loss + weight_reg * torch.mean(torch.sqrt(maximum(var, 1e-12)))
        if sat_guard and it.nonnormalized_weights is not None:
            loss = loss + sat_guard * torch.mean(F.softplus(-(it.nonnormalized_weights + 6.0)))
        return loss

    return extra_loss


def phases(args) -> list:
    """``[(throughput_mode, steps), ...]``: one phase, or the half-res
    warm-up and then full resolution."""
    if args.half_res_warmup:
        k = int(min(args.half_res_warmup, args.iters))
        out = [("half_res", k), ("full", args.iters - k)]
    else:
        out = [("half_res" if args.half_res_throughput else "full", args.iters)]
    return [(m, n) for m, n in out if n > 0]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", type=str, required=True,
                    help="dataset dir with transforms_{train,test}.json")
    ap.add_argument("--dataset-name", type=str, default=None)
    ap.add_argument("--size", type=int, default=256, help="image size")
    ap.add_argument("--iters", type=int, default=25_000)
    ap.add_argument("--crop-size", type=int, default=80)
    ap.add_argument("--n-views", type=int, default=6)
    ap.add_argument("--outputs", type=str, default="outputs")
    ap.add_argument("--models", type=str, default="models")
    ap.add_argument("--load", action="store_true",
                    help="resume from saved scene artifacts")
    ap.add_argument("--clip-norm", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--skip-test", action="store_true")
    ap.add_argument("--eval-march-bound", type=float, default=1.2,
                    help="bounding-sphere clip of the test renders' march (0: none)")
    ap.add_argument("--nan-skip", action="store_true",
                    help="skip, not raise on, non-finite-loss steps")
    ap.add_argument("--data-parallel", action="store_true",
                    help="shard the views over the ranks of parallel.make_mesh()")
    ap.add_argument("--surface-lr", type=float, default=8e-5)
    ap.add_argument("--bsdf-lr", type=float, default=8e-4)
    ap.add_argument("--light-lr", type=float, default=8e-5)
    ap.add_argument("--test-max-steps", type=int, default=256)
    ap.add_argument("--surface", type=str, default="spheres", choices=["spheres", "hash"])
    ap.add_argument("--resume", action="store_true",
                    help="resume the scene, the optimizer state and the step")
    ap.add_argument("--stable-init", action="store_true",
                    help="zero-out weight-net head (collapse-resistant)")
    ap.add_argument("--stable-min", action="store_true",
                    help="exact logsumexp smooth-min")
    ap.add_argument("--weight-reg", type=float, default=0.0,
                    help="weight-diversity regularizer coefficient")
    ap.add_argument("--sat-guard", type=float, default=0.0,
                    help="penalty on weight-net logits below -6")
    ap.add_argument("--no-ssim", action="store_true",
                    help="drop the -log SSIM colour-loss term")
    ap.add_argument("--mask-weight", type=float, default=15.0)
    ap.add_argument("--load-from", type=str, default=None,
                    help="seed the scene from another model dir")
    ap.add_argument("--mask-crops", action="store_true",
                    help="centre training crops on random mask pixels")
    ap.add_argument("--device-data", action="store_true",
                    help="the on-device data path: views and crops drawn on the device")
    ap.add_argument("--half-res-throughput", action="store_true",
                    help="the silhouette min-scan on the 2x-subsampled crop")
    ap.add_argument("--half-res-warmup", type=int, default=0,
                    help="the half-res min-scan for the first N steps only")
    ap.add_argument("--valid-freq", type=int, default=2500,
                    help="a validation render and PSNR every N steps (0: none)")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def run(args, data, test=None, name: str = "nerf", save: bool = True, mesh=None):
    """Train on ``data`` (a ``NeRFDataset``), then, given ``test``, the test
    split.  ``save`` writes the scene artifacts, the resume file, the
    metrics and the renders.  ``mesh`` (a ``parallel.Mesh``) trains
    data-parallel; then only rank 0 saves and runs the test split.
    Returns ``(state, results)``: ``results["losses"]``, ``results["test"]``
    (the metrics) and ``results["test_images"]``."""
    from ..cameras import NeRFCamera
    from ..integrators import Direct
    from ..ops.math import mse2psnr
    from ..render import pathtrace
    from ..training import (
        device_dataset, evaluate, init_train_state, load_scene, load_train_state,
        make_optimizer, rand_uv_mask, save_scene, save_train_state, train,
    )

    if args.half_res_warmup and args.half_res_throughput:
        raise ValueError("--half-res-warmup and --half-res-throughput are exclusive")
    if mesh is not None and mesh.rank != 0:
        save, test = False, None
    plan = phases(args)
    scene = build_scene(surface=args.surface, stable_init=args.stable_init,
                        stable_min=args.stable_min,
                        throughput_mode=plan[0][0] if plan else "full")
    opt = make_optimizer({"shape": args.surface_lr, "bsdf": args.bsdf_lr,
                          "lights": args.light_lr}, clip_norm=args.clip_norm)
    state = init_train_state(scene, opt, torch.Generator().manual_seed(args.seed),
                             device=args.device)
    model_dir = f"{args.models}/{name}"
    state_path = os.path.join(model_dir, "train_state.pt")
    if args.resume and os.path.exists(state_path):
        step = load_train_state(state_path, scene, state.optimizer)
        state = state._replace(step=step)
        print(f"resumed from step {step}")
    elif args.load:
        load_scene(model_dir, scene)
    elif args.load_from:
        load_scene(args.load_from, scene)
        print(f"seeded the scene from {args.load_from}")

    def make_camera(idxs):
        return NeRFCamera(torch.from_numpy(data.cam_to_worlds[np.asarray(idxs)]), data.focal)

    metrics: list = []

    def flush_metrics():
        if save:
            os.makedirs(args.outputs, exist_ok=True)
            with open(os.path.join(args.outputs, f"metrics_{name}.jsonl"), "w") as f:
                f.writelines(json.dumps(m) + "\n" for m in metrics)

    def valid_fn(st, i):
        img, _ = pathtrace(st.scene, make_camera([0]), Direct(training=False),
                           size=args.size, chunk_size=chunk_for(args.size),
                           background=0.0, key=0, device=args.device)
        got = np.clip(img.cpu().numpy()[..., :3], 0.0, 1.0)
        mse = float(np.mean((got - np.asarray(data.images[0][..., :3])) ** 2))
        psnr = float(mse2psnr(max(mse, 1e-10)))
        metrics.append({"step": int(i), "valid_psnr": psnr})
        if save:
            save_image(f"{args.outputs}/valid_{name}_{int(i):06}.png", got)
        print(f"valid @ {int(i)}: PSNR {psnr:.2f}")

    def save_fn(st, i):
        if save:
            save_scene(model_dir, st.scene, step=st.step)
            save_train_state(state_path, st.scene, st.optimizer, st.step)
            flush_metrics()

    device_data = camera_builder = None
    if args.device_data:
        device_data = device_dataset(data.images, data.masks, data.cam_to_worlds,
                                     args.crop_size, device=args.device)
        camera_builder = lambda c: NeRFCamera(c, data.focal)

    results: dict = {"losses": []}
    for pi, (mode, n) in enumerate(plan):
        if len(plan) > 1:
            print(f"phase {pi}: throughput_mode={mode} ({n} steps)")
        scene.shape.throughput_mode = mode
        generator = torch.Generator(device=args.device).manual_seed(args.seed + 1 + pi)
        state, losses = train(
            scene, Direct(training=True), opt, state, make_camera, data.images,
            data.masks, generator, size=args.size, crop_size=args.crop_size, iters=n,
            n_views=args.n_views, nan_policy="skip" if args.nan_skip else "raise",
            with_ssim=not args.no_ssim, mask_weight=args.mask_weight,
            uv_select=rand_uv_mask if args.mask_crops else None,
            extra_loss=make_extra_loss(args.weight_reg, args.sat_guard),
            log_every=args.log_every, metrics=metrics, device_data=device_data,
            camera_builder=camera_builder, valid_freq=args.valid_freq, mesh=mesh,
            valid_fn=valid_fn if args.valid_freq else None, save_fn=save_fn,
            ckpt_freq=max(n // 5 - 1, 1))
        results["losses"] += losses
    if plan:
        save_fn(state, state.step)
    flush_metrics()

    if test is not None:
        print("Running on test set")
        images = []

        def save_test(i, im):
            images.append(im)
            if save:
                save_image(f"{args.outputs}/test_{name}_{i:03}.png", im)

        bound = args.eval_march_bound if args.eval_march_bound > 0 else None
        test_scene = scene.replace(shape=scene.shape.replace(
            max_steps=args.test_max_steps, march_bound=bound, throughput_mode="full"))
        results["test"] = evaluate(
            test_scene, lambda i: NeRFCamera(torch.from_numpy(test.cam_to_worlds[i:i + 1]),
                                             test.focal),
            test.images, Direct(training=False), size=args.size,
            chunk_size=chunk_for(args.size), save_fn=save_test)
        results["test_images"] = np.stack(images)
        metrics.append({"step": int(state.step), "test": results["test"]})
        flush_metrics()
    return state, results


def main(argv=None, save: bool = True):
    args = parser().parse_args(argv)
    mesh = data_parallel_mesh(args) if args.data_parallel else None
    from ..training import load_nerf_synthetic
    name = args.dataset_name or args.data.rstrip("/").split("/")[-1]
    print(f"{name}, Size: {args.size}, Iters: {args.iters}")
    data = load_nerf_synthetic(args.data, args.size, "train")
    test = None if args.skip_test else load_nerf_synthetic(args.data, args.size, "test")
    return run(args, data, test, name, save=save, mesh=mesh)


def data_parallel_mesh(args):
    """``parallel.make_mesh()`` on ``args.device`` for a world of one, on
    the rank's device under ``torchrun``; ``args.device`` becomes the mesh's
    device."""
    from ..parallel import make_mesh
    if args.device_data:
        raise ValueError("--device-data is single-device: it takes no --data-parallel")
    dist_run = int(os.environ.get("WORLD_SIZE", "1")) > 1
    mesh = make_mesh(device=None if dist_run else args.device)
    args.device = str(mesh.device)
    if mesh.rank == 0:
        print(f"data-parallel over {mesh.size} devices")
    return mesh


if __name__ == "__main__":
    main(sys.argv[1:])
