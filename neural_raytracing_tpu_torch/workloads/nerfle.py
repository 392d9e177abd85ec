"""NeRF+PT / NeRF+LE: the volumetric relighting baseline on the colocated
dataset.

The twin of ``scripts/nerfle.py`` of the JAX package: a ``NeRFLE`` volume
(light conditioning by the point-light location, or by an envmap probe with
``--envmap``) and ``PointLights(scale=100)``, rendered through
``NeRFReproduce``; MSE-only training on 16^2 crops of 4 views a step, each
view lit by a point light at 1.05 x its camera centre (camera and light are
colocated in the data); then the test renders of the first 8 views.

    python -m neural_raytracing_tpu_torch.workloads.nerfle \
        --data mitsuba_scenes/cbox_relight/outputs --kind bunny --envmap

The loop resolves each step's loss one step behind (as ``training.train``
does), so the loss sampler sees a step's loss after the next step's views
are drawn.  ``--device`` picks the card (default) or the CPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Optional

import numpy as np
import torch

from ._common import chunk_for, save_image


def build_scene(envmap: bool = False):
    """The scene of ``scripts/nerfle.py`` (random weights until loaded)."""
    from .. import Scene
    from ..lights import PointLights
    from ..shapes import NeRFLE
    return Scene(shape=NeRFLE(envmap=envmap), lights=PointLights(scale=100.0))


def colocate_cameras(data):
    """The ``FoVPerspectiveCamera`` of every view of a ``ColocateDataset``."""
    from ..cameras import FoVPerspectiveCamera, look_at_view_transform
    r, t = look_at_view_transform(dist=data.dist, elev=data.elevs, azim=data.azims)
    return FoVPerspectiveCamera(R=r, T=t)


def build_step(scene, optimizer, *, size: int, crop_size: int,
               bundle_size: int = 1):
    """The MSE-only step of ``scripts/nerfle.py``:
    ``step(camera, uv, exp, generator=None) -> loss`` renders the crop at
    ``uv`` through ``pathtrace_sample``, averages the bundle, and takes one
    AdamW step on ``mean((got - exp)^2)``; the loss is not synchronised."""
    from ..integrators import NeRFReproduce
    from ..render import pathtrace_sample
    from ..training import broadcast_state
    integrator = NeRFReproduce()

    def step(camera, uv, exp, generator=None):
        optimizer.zero_grad(set_to_none=False)
        got, _, _ = pathtrace_sample(scene, integrator, camera, uv, generator,
                                     crop_size=crop_size, bundle_size=bundle_size,
                                     size=size)
        loss = torch.mean(torch.square(got.mean(dim=-2) - exp))
        loss.backward()
        broadcast_state(optimizer)
        optimizer.step()
        return loss.detach()

    return step


def train(scene, optimizer, cameras, images: np.ndarray, *, size: int,
          crop_size: int, iters: int, n_views: int, seed: int = 0,
          generator: Optional[torch.Generator] = None, log_every: int = 100,
          log_fn: Callable = print) -> list:
    """The loss-sampler loop of ``scripts/nerfle.py``: ``n_views`` views a
    step, a uniform crop, each view lit at 1.05 x its camera centre.
    ``cameras`` holds every view, ``images [V, H, W, 3]`` their ground
    truth.  Returns the losses."""
    from ..cameras import FoVPerspectiveCamera
    from ..training import LossSampler, rand_uv
    step = build_step(scene, optimizer, size=size, crop_size=crop_size)
    device = next(scene.parameters()).device
    imgs = torch.as_tensor(np.asarray(images)[..., :3], dtype=torch.float32,
                           device=device)
    lights = cameras.camera_center() * 1.05
    selector = LossSampler(len(images))
    rng = np.random.default_rng(seed)
    losses: list = []
    pending = None

    def resolve(i, idxs, loss):
        loss = float(loss)
        losses.append(loss)
        selector.update_idxs(idxs, loss)
        if log_every and i % log_every == 0:
            log_fn(f"step {i:6d} loss {loss:.6f}")

    for i in range(iters):
        idxs = selector.sample(n=n_views)
        sel = torch.as_tensor(idxs)
        camera = FoVPerspectiveCamera(R=cameras.R[sel], T=cameras.T[sel])
        u, v = rand_uv(rng, size, size, crop_size)
        exp = imgs[sel.to(device), u:u + crop_size, v:v + crop_size]
        scene.lights.set_location(lights[sel])
        loss = step(camera, (u, v), exp, generator)
        if pending is not None:
            resolve(*pending)
        pending = (i, idxs, loss)
    if pending is not None:
        resolve(*pending)
    return losses


def evaluate(scene, cameras, images: np.ndarray, *, size: int,
             save_fn: Optional[Callable] = None, log_fn: Callable = print):
    """The test of ``scripts/nerfle.py``: every view of ``images`` rendered
    through ``NeRFReproduce`` (chunk ``chunk_for(size)``, no jitter), lit at
    1.05 x its camera centre.  Returns ``training.evaluate``'s metrics."""
    from ..cameras import FoVPerspectiveCamera
    from ..integrators import NeRFReproduce
    from ..training import evaluate as evaluate_views
    lights = cameras.camera_center() * 1.05

    def light_update(scene_, camera, i):
        scene_.lights.set_location(lights[i:i + 1])

    return evaluate_views(
        scene, lambda i: FoVPerspectiveCamera(R=cameras.R[i:i + 1], T=cameras.T[i:i + 1]),
        images, NeRFReproduce(), size=size, chunk_size=chunk_for(size), key=None,
        light_update=light_update, save_fn=save_fn, log_fn=log_fn)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", type=str, required=True)
    ap.add_argument("--kind", type=str, default="bunny")
    ap.add_argument("--n-elev", type=int, default=8)
    ap.add_argument("--n-azim", type=int, default=8)
    ap.add_argument("--envmap", action="store_true")
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument("--size", type=int, default=200, help="image size")
    ap.add_argument("--iters", type=int, default=300_000)
    ap.add_argument("--crop-size", type=int, default=16)
    ap.add_argument("--n-views", type=int, default=4)
    ap.add_argument("--outputs", type=str, default="outputs")
    ap.add_argument("--models", type=str, default="models")
    ap.add_argument("--load", action="store_true",
                    help="resume from saved scene artifacts")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=100)
    ap.add_argument("--skip-test", action="store_true")
    ap.add_argument("--device", type=str, default="cuda")
    return ap


def main(argv=None):
    """Train, save and test; returns ``(scene, losses, test metrics)``."""
    args = parser().parse_args(argv)
    from ..training import load_colocate, load_scene, make_optimizer, save_scene

    data = load_colocate(args.data, args.kind, args.size, n_elev=args.n_elev,
                         n_azim=args.n_azim)
    cameras = colocate_cameras(data)
    scene = build_scene(envmap=args.envmap)
    scene.init(torch.Generator().manual_seed(args.seed), device=args.device)
    model_dir = f"{args.models}/nerfle_{args.kind}"
    if args.load:
        load_scene(model_dir, scene)
    optimizer = make_optimizer({"shape": args.lr, "lights": args.lr}).init(scene)
    generator = torch.Generator(device=args.device).manual_seed(args.seed + 1)
    losses = train(scene, optimizer, cameras, data.images, size=args.size,
                   crop_size=args.crop_size, iters=args.iters,
                   n_views=args.n_views, seed=args.seed, generator=generator,
                   log_every=args.log_every)
    save_scene(model_dir, scene, step=args.iters)
    results = {}
    if not args.skip_test:
        results = evaluate(
            scene, cameras, data.images[:8], size=args.size,
            save_fn=lambda i, im: save_image(
                f"{args.outputs}/nerfle_{args.kind}_{i:02}.png", im))
    return scene, losses, results


if __name__ == "__main__":
    main(sys.argv[1:])
