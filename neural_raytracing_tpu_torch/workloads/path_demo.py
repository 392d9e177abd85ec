"""Path against Direct on ground truth with interreflections.

The twin of ``scripts/path_demo.py`` of the JAX package.  On a dataset of
``make_mesh_dataset --format nerv --mirror-plate R --gt-bounces 2`` the
ground truth holds light that a single bounce cannot carry (a delta light
and a delta conductor: the plate shows only the reflected object).  This
rebuilds the ground-truth scene from ``meta.json`` (its kind, light scale,
material and plate; like the JAX script it does not read ``obj_scale``)
with the generator's weights, renders every test view with
``Mask(Direct(horizon_mask=True))`` and with ``Mask(Path(max_depth,
horizon_mask=True))`` averaged over ``--samples`` passes (pass ``s`` seeded
``1 + s``, as the generator's), and reports each view's PSNR against the
stored ground truth and the means.

    python -m neural_raytracing_tpu_torch.workloads.path_demo --data outputs/gear_mirror

``run`` takes the test split in memory (a ``NeRVDataset``) and the meta
dict, so a caller with no PNGs can drive the same path; ``main`` writes the
JSON and a strip of the first three views (ground truth, Direct, Path).
``--device`` picks the card (default) or the CPU.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

from ._common import base_parser, device_of, save_image


def parser():
    ap = base_parser(__doc__.split("\n\n")[0])
    ap.add_argument("--data", type=str, required=True)
    ap.add_argument("--samples", type=int, default=16,
                    help="Path passes averaged a view")
    ap.add_argument("--max-depth", type=int, default=2)
    ap.add_argument("--out-json", type=str, default=None,
                    help="the metrics' JSON (default {outputs}/path_demo.json)")
    return ap


def gt_scene(meta: dict, device="cuda"):
    """The ground-truth scene of ``meta`` with the generator's weights."""
    from .make_mesh_dataset import SEED, build_gt_scene
    scene = build_gt_scene(meta["kind"], light_scale=meta["light_scale"], occlusion="hard",
                           material=meta["material"], mirror_plate=meta["mirror_plate"])
    return scene.init(torch.Generator().manual_seed(SEED), device=device)


def psnr(got: np.ndarray, exp: np.ndarray) -> float:
    from ..ops.math import mse2psnr
    return float(mse2psnr(max(float(np.mean((got - exp) ** 2)), 1e-10)))


def run(args, test, meta: dict, scene=None, log_fn=print) -> dict:
    """Render each view of ``test`` by Direct and by Path -> ``{"samples",
    "max_depth", "avg_psnr_direct", "avg_psnr_path", "delta", "per_view"
    [{"view", "psnr_direct", "psnr_path"}], "strip"}`` (``strip``: the
    first three views' ground truth, Direct and Path side by side)."""
    from ..cameras import NeRFCamera
    from ..integrators import Direct, Mask, Path
    from .make_mesh_dataset import render
    device = device_of(args)
    scene = scene if scene is not None else gt_scene(meta, device)
    size = int(meta["size"])
    scale = float(meta["light_scale"])
    direct = Mask(Direct(training=False, horizon_mask=True))
    path = Mask(Path(max_depth=args.max_depth, training=False, horizon_mask=True))
    rows, strip = [], []
    for i in range(len(test.images)):
        cam = NeRFCamera(torch.from_numpy(test.cam_to_worlds[i:i + 1]), test.focal)
        light = test.light_locs[i]
        exp = np.clip(test.images[i], 0.0, 1.0)
        d = np.clip(render(scene, cam, light, scale, direct, 1, size=size,
                           device=device)[..., :3], 0.0, 1.0)
        p = np.clip(render(scene, cam, light, scale, path, args.samples, size=size,
                           device=device)[..., :3], 0.0, 1.0)
        rows.append({"view": i, "psnr_direct": psnr(d, exp), "psnr_path": psnr(p, exp)})
        log_fn(f"view {i}: Direct {rows[-1]['psnr_direct']:.2f}  Path "
               f"{rows[-1]['psnr_path']:.2f}  delta "
               f"{rows[-1]['psnr_path'] - rows[-1]['psnr_direct']:+.2f}")
        if i < 3:
            strip.append(np.concatenate([exp, d, p], axis=1))
    avg_d = float(np.mean([r["psnr_direct"] for r in rows]))
    avg_p = float(np.mean([r["psnr_path"] for r in rows]))
    return {"samples": args.samples, "max_depth": args.max_depth, "avg_psnr_direct": avg_d,
            "avg_psnr_path": avg_p, "delta": avg_p - avg_d, "per_view": rows,
            "strip": np.concatenate(strip, axis=0) if strip else None}


def main(argv=None) -> dict:
    """Read the dataset, run, write the JSON and the strip; returns ``run``'s
    dict."""
    args = parser().parse_args(argv)
    from ..training import load_nerv
    with open(os.path.join(args.data, "meta.json")) as f:
        meta = json.load(f)
    test = load_nerv(args.data, int(meta["size"]), "test")
    out = run(args, test, meta)
    if out["strip"] is not None:
        save_image(os.path.join(args.outputs, "path_demo_gt_direct_path.png"), out["strip"])
    record = {"data": args.data, **{k: v for k, v in out.items() if k != "strip"}}
    path = args.out_json or os.path.join(args.outputs, "path_demo.json")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(json.dumps({k: v for k, v in record.items() if k != "per_view"}, indent=1))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
