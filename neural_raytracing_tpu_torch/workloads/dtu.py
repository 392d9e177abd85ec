"""DTU multi-view reconstruction under unknown lighting.

The twin of ``scripts/dtu.py`` of the JAX package: a DTU / IDR scan
(``cameras.npz`` with ``world_mat_i`` and ``scale_mat_i`` decomposed into a
pose and an intrinsic, the poses scaled into the unit sphere, ``image/``
and ``mask/``); ``SDF(SphereSDF(128))`` + ``ComposeSpatialVarying`` over 6
``NeuralBSDF(softplus)`` lobes + a learned ``LightField``; every 10th view
held out; 3 views x 96^2 mask-centred crops, the mask term at weight 10
(the DTU protocol's, not the NeRF-synthetic 15), AdamW 8e-5 for every
group; then the masked test at 128 march steps, bounded by
``--eval-march-bound``.  ``--device-data`` trains on the on-device data
path, each view's pose and intrinsic packed as one ``[2, 4, 4]`` array.

    python -m neural_raytracing_tpu_torch.workloads.dtu --data DTU/scan97 --size 200

``main`` loads the scan with ``load_dtu``'s default source size (1600 x
1200, the real scans'), as the JAX script does; ``run`` takes a
``DTUDataset`` in memory, so a caller with no PNGs, or no PIL, can drive
the same path.  ``--data-parallel`` trains on the one device, as the JAX
script does on one chip; beside ``--device-data`` it is refused, as there.
``--device`` picks the card (default) or the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ._common import chunk_for, save_image


def build_scene(max_steps: int = 64, n_bases: int = 6, march_bound=None):
    """The scene of ``scripts/dtu.py`` (random weights until loaded)."""
    from .. import Scene
    from ..bsdf import ComposeSpatialVarying, NeuralBSDF
    from ..lights import LightField
    from ..shapes import SDF, SphereSDF
    return Scene(
        shape=SDF(SphereSDF(n=128), max_steps=max_steps, throughput_steps=128,
                  dist=2.2, march_bound=march_bound),
        bsdf=ComposeSpatialVarying(
            [NeuralBSDF(activation="softplus") for _ in range(n_bases)]),
        lights=LightField())


def eval_scene(scene, march_bound=None):
    """The test scene over ``scene``'s parameters: 128 march steps, bounded
    by ``march_bound``."""
    return scene.replace(shape=scene.shape.replace(max_steps=128, march_bound=march_bound))


def split(n: int, test_every: int):
    """-> (train view indices, test view indices): every ``test_every``-th
    view from the first is held out."""
    test_idx = np.arange(0, n, test_every)
    return np.setdiff1d(np.arange(n), test_idx), test_idx


def camera_maker(data):
    """``make_camera(idxs) -> DTUCamera`` over the scan's poses and
    intrinsics, at its source size."""
    from ..cameras import DTUCamera

    def make_camera(idxs):
        idxs = np.asarray(idxs)
        return DTUCamera(torch.from_numpy(data.poses[idxs]),
                         torch.from_numpy(data.intrinsics[idxs]), data.src_size)
    return make_camera


def packed_cameras(data, idxs) -> np.ndarray:
    """The views' pose and intrinsic as one ``[V, 2, 4, 4]`` array (the device
    data path gathers it per view like a camera-to-world matrix)."""
    return np.stack([data.poses[idxs], data.intrinsics[idxs]], axis=1)


def packed_camera_builder(src_size):
    """``camera_builder(c) -> DTUCamera`` over a ``[V, 2, 4, 4]`` batch."""
    from ..cameras import DTUCamera
    return lambda c: DTUCamera(c[:, 0], c[:, 1], src_size)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", type=str, required=True)
    ap.add_argument("--size", type=int, default=200, help="image size")
    ap.add_argument("--iters", type=int, default=25_000)
    ap.add_argument("--crop-size", type=int, default=96)
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
                    help="bounding-sphere clip of the test renders' march (0: none)")
    ap.add_argument("--nan-skip", action="store_true",
                    help="skip, not raise on, non-finite-loss steps")
    ap.add_argument("--data-parallel", action="store_true",
                    help="accepted; one device trains (refused with --device-data)")
    ap.add_argument("--surface-lr", type=float, default=8e-5)
    ap.add_argument("--bsdf-lr", type=float, default=8e-5)
    ap.add_argument("--light-lr", type=float, default=8e-5)
    ap.add_argument("--device-data", action="store_true",
                    help="the on-device data path: views, crops and the DTU camera "
                         "pair drawn on the device")
    ap.add_argument("--test-every", type=int, default=10,
                    help="every k-th view is held out")
    ap.add_argument("--mask-weight", type=float, default=10.0,
                    help="the mask term's weight (the DTU protocol's 10)")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def run(args, data, name: str = "scan", save: bool = True):
    """Train on ``data`` (a ``DTUDataset``), then test on its held-out views
    with their masks.  ``save`` writes the scene artifacts, the metrics and
    the renders.  Returns ``(state, results)``: ``results["losses"]``,
    ``results["test"]`` (the metrics) and ``results["test_images"]``."""
    from ..integrators import Direct
    from ..training import (
        device_dataset, evaluate, init_train_state, load_scene, make_optimizer,
        rand_uv_mask, save_scene, train,
    )

    if args.device_data and args.data_parallel:
        raise ValueError("--device-data is single-device: drop --data-parallel")
    train_idx, test_idx = split(len(data.images), args.test_every)
    scene = build_scene()
    opt = make_optimizer({"shape": args.surface_lr, "bsdf": args.bsdf_lr,
                          "lights": args.light_lr}, clip_norm=args.clip_norm)
    state = init_train_state(scene, opt, torch.Generator().manual_seed(args.seed),
                             device=args.device)
    model_dir = f"{args.models}/dtu_{name}"
    if args.load:
        load_scene(model_dir, scene)
    make_camera = camera_maker(data)
    metrics: list = []

    def flush_metrics():
        if save:
            os.makedirs(args.outputs, exist_ok=True)
            with open(os.path.join(args.outputs, f"metrics_dtu_{name}.jsonl"), "w") as f:
                f.writelines(json.dumps(m) + "\n" for m in metrics)

    device_data = camera_builder = None
    if args.device_data:
        device_data = device_dataset(data.images[train_idx], data.masks[train_idx],
                                     packed_cameras(data, train_idx), args.crop_size,
                                     device=args.device)
        camera_builder = packed_camera_builder(data.src_size)

    results: dict = {}
    if args.iters > 0:
        generator = torch.Generator(device=args.device).manual_seed(args.seed + 1)
        state, losses = train(
            scene, Direct(training=True), opt, state,
            lambda idxs: make_camera(train_idx[np.asarray(idxs)]),
            data.images[train_idx], data.masks[train_idx], generator, size=args.size,
            crop_size=args.crop_size, iters=args.iters, n_views=args.n_views,
            nan_policy="skip" if args.nan_skip else "raise",
            mask_weight=args.mask_weight, uv_select=rand_uv_mask,
            log_every=args.log_every, metrics=metrics, device_data=device_data,
            camera_builder=camera_builder,
            save_fn=(lambda st, i: (save_scene(model_dir, st.scene, step=st.step),
                                    flush_metrics())) if save else None,
            ckpt_freq=max(args.iters // 5 - 1, 1))
        results["losses"] = losses
        if save:
            save_scene(model_dir, scene, step=state.step)
        flush_metrics()

    if not args.skip_test:
        images = []

        def save_test(i, im):
            images.append(im)
            if save:
                save_image(f"{args.outputs}/dtu_{name}_test_{i:02}.png", im)

        bound = args.eval_march_bound if args.eval_march_bound > 0 else None
        results["test"] = evaluate(
            eval_scene(scene, bound), lambda i: make_camera([test_idx[i]]),
            data.images[test_idx], Direct(training=False), size=args.size,
            chunk_size=chunk_for(args.size), masks=data.masks[test_idx],
            save_fn=save_test)
        results["test_images"] = np.stack(images)
        metrics.append({"step": int(state.step), "test": results["test"]})
        flush_metrics()
    return state, results


def main(argv=None):
    args = parser().parse_args(argv)
    from ..training import load_dtu
    name = args.data.rstrip("/").split("/")[-1]
    return run(args, load_dtu(args.data, args.size), name)


if __name__ == "__main__":
    main(sys.argv[1:])
