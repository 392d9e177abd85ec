"""Dataset generation: a NeRV-format scene (a point light per frame)
rendered by the port itself.

The twin of ``scripts/make_nerv_dataset.py`` of the JAX package: the layout
``workloads.nerv`` reads, ``{split}_point/transforms_{split}.json`` (the
field of view, and per frame its camera-to-world matrix and ``light_loc``)
beside RGBA renders ``{split}_point/{split}/r_{i}.png`` whose alpha is the
hit mask.  The scene is a procedural SDF (``make_dataset``'s kinds, the
armadillo by default) under ``ComposeSpatialVarying`` over two ``Diffuse``
lobes mixed by a 2 x 32 plain weight net, ``PointLights(scale=
light_scale)`` and hard shadows, rendered by ``Mask(Direct(training=False,
horizon_mask=True))`` through a ``NeRFCamera`` with a 60-degree field of
view.  From ``numpy.random.default_rng(0)``, first the train frames, then
the test frames: each camera at distance 1, elevation U(5, 40) and azimuth
U(-180, 180) degrees (``nerf_c2w``), its light at radius 1.3, elevation
U(10, 60) and azimuth U(-180, 180).

    python -m neural_raytracing_tpu_torch.workloads.make_nerv_dataset \
        --out outputs/nerv_ds --size 64

``render_split`` returns the images and frame dicts, so a caller on the
card needs no PIL; ``main`` writes them.  The weight net is drawn from a
seeded ``torch.Generator`` (the JAX script's from ``PRNGKey(7)``);
``build_scene`` followed by ``load_jax_params`` renders with the JAX draw.
``--device`` picks the card (default) or the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Optional

import numpy as np
import torch

SEED = 7                       # the weight net's draw (the JAX script's PRNGKey(7))
CAMERA_ANGLE_X = math.radians(60.0)


def build_scene(kind: str = "armadillo", light_scale: float = 1.5):
    """The generator's scene (the weight net random until initialised or
    loaded)."""
    from .. import Scene
    from ..bsdf import ComposeSpatialVarying, Diffuse
    from ..lights import PointLights
    from ..nn import SkipConnMLP
    from .make_dataset import procedural_shape
    return Scene(
        shape=procedural_shape(kind),
        bsdf=ComposeSpatialVarying(
            [Diffuse((0.7, 0.4, 0.2)), Diffuse((0.3, 0.3, 0.6))],
            sp_var_fn=SkipConnMLP(in_size=3, out=2, num_layers=2, hidden_size=32,
                                  freqs=8, sigma=8.0)),
        lights=PointLights(scale=light_scale),
        occlusion="hard")


def focal(size: int) -> float:
    return 0.5 * size / math.tan(0.5 * CAMERA_ANGLE_X)


def draw_frame(rng: np.random.Generator):
    """-> (camera-to-world ``[4, 4]``, light location ``[3]``): one frame's
    draws, in the JAX script's order."""
    from ..cameras import nerf_c2w
    c2w = nerf_c2w(rng.uniform(5, 40), rng.uniform(-180, 180), dist=1.0)
    le, la = math.radians(rng.uniform(10, 60)), math.radians(rng.uniform(-180, 180))
    light = 1.3 * np.asarray([math.cos(le) * math.sin(la), math.sin(le),
                              math.cos(le) * math.cos(la)], np.float32)
    return c2w, light


def render_frame(scene, c2w: np.ndarray, light: np.ndarray, *, size: int,
                 key: Optional[int] = 0, device="cuda") -> np.ndarray:
    """One RGBA frame ``[size, size, 4]`` in [0, 1], lit from ``light``."""
    from ..cameras import NeRFCamera
    from ..integrators import Direct, Mask
    from ..render import pathtrace
    scene.lights.set_location(light[None])
    cam = NeRFCamera(torch.as_tensor(c2w[None, :3, :4]), focal(size))
    img, _ = pathtrace(scene, cam, Mask(Direct(training=False, horizon_mask=True)),
                       size=size, chunk_size=size, background=0.0, key=key,
                       device=device)
    return np.clip(img.cpu().numpy(), 0.0, 1.0)


def render_split(scene, split: str, n: int, rng: np.random.Generator, *, size: int,
                 device="cuda", log_fn=print):
    """-> (RGBA images ``[n, S, S, 4]`` uint8, the frame dicts): frame ``i``
    renders with key ``i``."""
    images, frames = [], []
    for i in range(n):
        c2w, light = draw_frame(rng)
        rgba = render_frame(scene, c2w, light, size=size, key=i, device=device)
        images.append((rgba * 255).astype(np.uint8))
        frames.append({"file_path": f"{split}/r_{i}", "transform_matrix": c2w.tolist(),
                       "light_loc": light.tolist()})
        log_fn(f"{split} {i + 1} / {n}")
    return np.stack(images), frames


def render_dataset(scene, *, size: int, train_views: int = 12, test_views: int = 4,
                   device="cuda", log_fn=print) -> dict:
    """``{split: (images, frames)}`` for the train and the test split."""
    rng = np.random.default_rng(0)
    return {split: render_split(scene, split, n, rng, size=size, device=device,
                                log_fn=log_fn)
            for split, n in (("train", train_views), ("test", test_views))}


def as_dataset(images: np.ndarray, frames: list, size: int):
    """The ``NeRVDataset`` that ``load_nerv`` reads back from a split's PNGs
    and frames, in memory."""
    from ..training import NeRVDataset
    imgs = images.astype(np.float64).astype(np.float32) / 255.0
    return NeRVDataset(
        np.stack([np.asarray(f["transform_matrix"], np.float32)[:3, :4] for f in frames]),
        float(0.5 * size / np.tan(0.5 * CAMERA_ANGLE_X)),     # as load_nerv has it
        imgs[..., :3], np.ceil(imgs[..., 3] - 1e-5),
        np.stack([np.asarray(f["light_loc"], np.float32) for f in frames]), None)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--kind", type=str, default="armadillo")
    ap.add_argument("--train-views", type=int, default=12)
    ap.add_argument("--test-views", type=int, default=4)
    ap.add_argument("--light-scale", type=float, default=1.5)
    ap.add_argument("--size", type=int, default=64, help="image size")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def main(argv=None) -> dict:
    """Render and write both splits; returns ``render_dataset``'s dict."""
    args = parser().parse_args(argv)
    from PIL import Image   # only the writer needs PIL

    scene = build_scene(args.kind, args.light_scale)
    scene.init(torch.Generator().manual_seed(SEED), device=args.device)
    out = render_dataset(scene, size=args.size, train_views=args.train_views,
                         test_views=args.test_views, device=args.device)
    for split, (images, frames) in out.items():
        base = os.path.join(args.out, f"{split}_point")
        os.makedirs(os.path.join(base, split), exist_ok=True)
        for img, frame in zip(images, frames):
            Image.fromarray(img, "RGBA").save(os.path.join(base, frame["file_path"] + ".png"))
        with open(os.path.join(base, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": CAMERA_ANGLE_X, "frames": frames}, f)
    print("wrote", args.out)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
