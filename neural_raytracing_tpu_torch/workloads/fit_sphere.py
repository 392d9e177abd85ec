"""Fit an SDF scene to ground truth rendered from an analytic sphere.

The twin of ``scripts/fit_sphere.py`` of the JAX package: no dataset is
needed.  The ground truth is ``Sphere(r=0.7)`` with ``Diffuse((0.8, 0.3,
0.2))`` under a point light at ``(0, 1, 4)`` (scale 50), 16 views from
distance 2 (4 elevations in [0, 40] by 4 azimuths in [-60, 60]) rendered
through ``Mask(Direct)``.  The learned scene is ``SDF(SphereSDF(n=32),
max_steps=32, throughput_steps=64, dist=4.0)`` with ``Diffuse((0.5, 0.5,
0.5))`` and the same light (not learned); AdamW 1e-3 for the surface and
5e-3 for the BSDF.  ``train``, then ``save_scene`` to
``{models}/fit_sphere``, then ``evaluate`` on the first 4 views.  On the
card the march and the silhouette scan are K2 and K3, the shift net K1.

    python -m neural_raytracing_tpu_torch.workloads.fit_sphere --size 64 --iters 500

The ground-truth jitter comes from the render seed 1 and the training draws
from a ``torch.Generator`` seeded ``--seed + 1``; the JAX script draws them
from ``PRNGKey``s.  ``--device`` picks the card (default) or the CPU.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ._common import base_parser, device_of, save_image

LRS = {"shape": 1e-3, "bsdf": 5e-3, "lights": 0.0}


def parser():
    ap = base_parser(__doc__.split("\n\n")[0], size=64)
    ap.set_defaults(iters=1000, crop_size=32, n_views=3)
    return ap


def cameras():
    """The 16 ground-truth views: 4 elevations by 4 azimuths."""
    from ..cameras import FoVPerspectiveCamera, look_at_view_transform
    r, t = look_at_view_transform(dist=2.0, elev=np.tile(np.linspace(0, 40, 4), 4),
                                  azim=np.repeat(np.linspace(-60, 60, 4), 4))
    return FoVPerspectiveCamera(R=r, T=t)


def render_gt(size: int, device="cuda"):
    """-> (images [16, size, size, 3], masks [16, size, size]) as numpy."""
    from .. import Scene
    from ..bsdf import Diffuse
    from ..integrators import Direct, Mask
    from ..lights import PointLights
    from ..render import pathtrace
    from ..shapes import Sphere
    gt = Scene(shape=Sphere((0.0, 0.0, 0.0), 0.7), bsdf=Diffuse((0.8, 0.3, 0.2)),
               lights=PointLights(location=(0.0, 1.0, 4.0), scale=50.0)).to(device)
    img, _ = pathtrace(gt, cameras(), Mask(Direct(training=False)), size=size,
                       chunk_size=min(size, 64), bundle_size=1, background=0.0, key=1,
                       squeeze_first=False, device=device)
    img = img.cpu().numpy()
    return img[..., :3], img[..., 3]


def build_scene():
    """The learnable scene (random weights until ``init``)."""
    from .. import Scene
    from ..bsdf import Diffuse
    from ..lights import PointLights
    from ..shapes import SDF, SphereSDF
    return Scene(shape=SDF(SphereSDF(n=32), max_steps=32, throughput_steps=64, dist=4.0),
                 bsdf=Diffuse((0.5, 0.5, 0.5)),
                 lights=PointLights(location=(0.0, 1.0, 4.0), scale=50.0))


def run(args, gt=None, scene=None, generator="seed", save: bool = True,
        log_fn=print) -> dict:
    """Train on ``gt`` (``render_gt``'s, rendered here when None), save and
    evaluate -> ``{"state", "losses", "metrics", "gt"}``.  ``scene``: a
    ``build_scene()`` with its weights (default: drawn from seed
    ``--seed``); ``generator``: the training draws (default: seeded
    ``--seed + 1``; None: no jitter)."""
    from ..cameras import FoVPerspectiveCamera
    from ..integrators import Direct
    from ..training import evaluate, init_train_state, make_optimizer, save_scene, train
    device = device_of(args)
    if gt is None:
        log_fn("rendering ground truth ...")
        gt = render_gt(args.size, device)
    imgs, masks = gt
    if save:
        save_image(f"{args.outputs}/fit_sphere_gt.png", imgs[0])
    opt = make_optimizer(LRS, clip_norm=args.clip_norm)
    if scene is None:
        scene = build_scene()
        state = init_train_state(scene, opt, torch.Generator().manual_seed(args.seed),
                                 device=device)
    else:
        state = init_train_state(scene, opt, device=device)
    cams = cameras()

    def make_camera(idxs):
        idxs = torch.as_tensor(np.asarray(idxs))
        return FoVPerspectiveCamera(R=cams.R[idxs], T=cams.T[idxs])

    if generator == "seed":
        generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    state, losses = train(scene, Direct(training=True), opt, state, make_camera, imgs,
                          masks, generator, size=args.size, crop_size=args.crop_size,
                          iters=args.iters, n_views=args.n_views, log_every=args.log_every,
                          log_fn=log_fn, nan_policy="skip" if args.nan_skip else "raise")
    if save:
        save_scene(f"{args.models}/fit_sphere", scene, step=args.iters)
    metrics = None
    if not args.skip_test:
        metrics = evaluate(
            scene, lambda i: make_camera([i]), imgs[:4], Direct(training=False),
            size=args.size, chunk_size=min(args.size, 64), log_fn=log_fn,
            save_fn=(lambda i, im: save_image(f"{args.outputs}/fit_sphere_test_{i}.png", im))
            if save else None)
        log_fn(f"final: {metrics}")
    return {"state": state, "losses": losses, "metrics": metrics, "gt": gt}


def main(argv=None) -> dict:
    return run(parser().parse_args(argv))


if __name__ == "__main__":
    main(sys.argv[1:])
