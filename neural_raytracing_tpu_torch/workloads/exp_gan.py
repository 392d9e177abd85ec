"""GAN-NeRF experiment: a ``PlainNeRF`` generator against a DCGAN critic.

The twin of ``scripts/exp_gan.py`` of the JAX package.  ``PlainNeRF
(latent_size=--latent, steps=24)`` renders ``--n-views`` random views
(distance 2, elevation in [0, 30], azimuth in [-180, 180]), each with its own
standard-normal latent code, through ``NeRFReproduce`` and
``pathtrace_sample`` (the whole ``--size``^2 image as one crop); the
``Discriminator`` judges them against as many real images.  Each step
takes one critic step (``softplus(fake) + softplus(-real)``) and one
generator step (``softplus(-fake)``), both by Adam with ``betas=(0.5,
0.999)``.  On the card the compositing is K8.

    python -m neural_raytracing_tpu_torch.workloads.exp_gan --data images_dir --size 64

``train_gan`` takes the real images as an array, so a caller without image
files (or without PIL) can drive it.  The draws come from a
``torch.Generator`` seeded ``--seed`` and the views from numpy's
``default_rng(--seed)``; the JAX script draws the latents and the render
jitter from ``PRNGKey``s.  ``--device`` picks the card (default) or the CPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ._common import base_parser, device_of


def parser():
    ap = base_parser(__doc__.split("\n\n")[0], size=64)
    ap.add_argument("--data", type=str, required=True, help="directory of training images")
    ap.add_argument("--latent", type=int, default=32)
    ap.add_argument("--g-lr", type=float, default=1e-4)
    ap.add_argument("--d-lr", type=float, default=2e-4)
    ap.set_defaults(iters=2000, n_views=4)
    return ap


def build(latent: int, generator: torch.Generator, device="cuda"):
    """-> (scene over ``PlainNeRF(latent, steps=24)``, ``Discriminator``),
    their weights drawn from ``generator`` in that order."""
    from .. import Scene
    from ..nn import Discriminator
    from ..shapes import PlainNeRF
    scene = Scene(shape=PlainNeRF(latent_size=latent, steps=24)).init(generator, device=device)
    return scene, Discriminator().init(generator, device=device)


def render_fake(scene, latents: torch.Tensor, camera, generator, size: int) -> torch.Tensor:
    """The views of ``camera``, each conditioned on its row of ``latents``
    -> ``[n, size, size, 3]``."""
    from ..integrators import NeRFReproduce
    from ..render import pathtrace_sample
    scene.shape.latent = latents
    try:
        values, _, _ = pathtrace_sample(scene, NeRFReproduce(), camera, (0, 0), generator,
                                        crop_size=size, bundle_size=1, size=size)
    finally:
        scene.shape.latent = None
    return values.mean(dim=-2)


def _nchw(img: torch.Tensor) -> torch.Tensor:
    return img.permute(0, 3, 1, 2)


def d_step(scene, disc, d_opt, latents, camera, real, generator, size: int) -> torch.Tensor:
    """One critic step; -> its loss (not synchronised)."""
    with torch.no_grad():
        fake = render_fake(scene, latents, camera, generator, size)
    loss = (torch.mean(F.softplus(disc(_nchw(fake))))
            + torch.mean(F.softplus(-disc(_nchw(real)))))
    d_opt.zero_grad(set_to_none=True)
    loss.backward()
    d_opt.step()
    return loss.detach()


def g_step(scene, disc, g_opt, latents, camera, generator, size: int) -> torch.Tensor:
    """One generator step (the critic's weights get no gradient); -> its
    loss."""
    fake = render_fake(scene, latents, camera, generator, size)
    loss = torch.mean(F.softplus(-disc(_nchw(fake))))
    params = [p for group in g_opt.param_groups for p in group["params"]]
    g_opt.zero_grad(set_to_none=True)
    loss.backward(inputs=params)
    g_opt.step()
    return loss.detach()


def train_gan(reals: np.ndarray, *, size: int = 64, n_views: int = 4, iters: int = 2000,
              latent: int = 32, g_lr: float = 1e-4, d_lr: float = 2e-4, seed: int = 0,
              device="cuda", log_every: int = 100, log_fn=print) -> dict:
    """Train on ``reals [M, size, size, 3]`` -> ``{"scene", "disc",
    "d_losses", "g_losses"}`` (the losses as floats)."""
    from ..cameras import FoVPerspectiveCamera, look_at_view_transform
    from ..ops import sampling
    generator = torch.Generator(device=device).manual_seed(seed)
    scene, disc = build(latent, torch.Generator().manual_seed(seed), device)
    g_opt = torch.optim.Adam(scene.parameters(), lr=g_lr, betas=(0.5, 0.999))
    d_opt = torch.optim.Adam(disc.parameters(), lr=d_lr, betas=(0.5, 0.999))
    reals = torch.as_tensor(np.asarray(reals)[..., :3], dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    d_losses, g_losses = [], []
    for i in range(iters):
        latents = sampling.normal(generator, (n_views, latent), device)
        r, t = look_at_view_transform(dist=2.0, elev=rng.uniform(0, 30, n_views),
                                      azim=rng.uniform(-180, 180, n_views))
        camera = FoVPerspectiveCamera(R=r, T=t)
        real = reals[torch.as_tensor(rng.integers(0, len(reals), n_views), device=device)]
        d_losses.append(d_step(scene, disc, d_opt, latents, camera, real, generator, size))
        g_losses.append(g_step(scene, disc, g_opt, latents, camera, generator, size))
        if log_every and i % log_every == 0:
            log_fn(f"step {i:6d} d {float(d_losses[-1]):.4f} g {float(g_losses[-1]):.4f}")
    return {"scene": scene, "disc": disc, "d_losses": [float(x) for x in d_losses],
            "g_losses": [float(x) for x in g_losses]}


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    from ..training.datasets import load_image
    files = [os.path.join(args.data, f) for f in sorted(os.listdir(args.data))
             if f.lower().endswith((".png", ".jpg", ".jpeg"))]
    reals = np.stack([load_image(f, resize=(args.size, args.size))[..., :3] for f in files])
    print(f"{len(reals)} real images")
    out = train_gan(reals, size=args.size, n_views=args.n_views, iters=args.iters,
                    latent=args.latent, g_lr=args.g_lr, d_lr=args.d_lr, seed=args.seed,
                    device=device_of(args), log_every=args.log_every)
    print("done")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
