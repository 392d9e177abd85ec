"""Render drivers: full-image tiled rendering and crop sampling.

Counterpart of ``pathtrace``/``pathtrace_sample``/``render_rays`` in
``neural_raytracing_tpu/render.py``.  The image is cut into square tiles
taken in the order of the JAX tile scan: tile ``idx`` covers first-axis
pixels from ``(idx // n_tiles) * chunk`` and second-axis pixels from
``(idx % n_tiles) * chunk``.  Each tile draws its camera jitter from its own
``torch.Generator``, seeded from ``(key, idx)`` as the JAX render folds the
tile index into its key.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .scene import Scene


def render_rays(scene: Scene, rays: torch.Tensor, integrator, generator=None,
                training: bool = False):
    """Run the integrator over an arbitrary ray batch ``[..., 6]``."""
    return integrator.sample(scene, rays, generator=generator, training=training)


def _tile_positions(x_start: float, y_start: float, chunk: int,
                    device) -> torch.Tensor:
    """Pixel-position grid for one tile: [chunk, chunk, 2] = (y, x) coords."""
    xs = x_start + torch.arange(chunk, dtype=torch.float32, device=device)
    ys = y_start + torch.arange(chunk, dtype=torch.float32, device=device)
    gx, gy = torch.meshgrid(xs, ys, indexing="ij")
    # positions[..., 0] = second image axis (y), [..., 1] = first (x)
    return torch.stack([gy, gx], dim=-1)


def tile_generator(key: Optional[int], idx: int, device) -> Optional[torch.Generator]:
    """The tile's own generator, seeded from ``(key, idx)``; None without a key."""
    if key is None:
        return None
    seed = int(np.random.SeedSequence([key, idx]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed & ((1 << 63) - 1))


@torch.no_grad()
def pathtrace(scene: Scene, camera, integrator, size: int = 512,
              chunk_size: int = 32, bundle_size: int = 4,
              background: float = 1.0, key: Optional[int] = None,
              with_noise=1e-3, training: bool = False,
              squeeze_first: bool = True, scan_tiles: bool = True,
              device="cuda"):
    """Full-image render; returns ``(images [N, W, H, dims], it)``.

    ``key`` (an int) seeds the per-tile generators; None renders without
    jitter.  ``it`` is the last tile's interaction with
    ``scan_tiles=False`` and None otherwise, as in the JAX render.  The
    images stay on ``device``.
    """
    if size % chunk_size:
        raise ValueError(f"chunk_size must divide size ({size} % {chunk_size})")
    camera = camera.to(device)
    n = len(camera)
    n_tiles = size // chunk_size
    out = torch.full((n, size, size, integrator.dims()), float(background),
                     dtype=torch.float32, device=device)
    it = None
    for idx in range(n_tiles * n_tiles):
        ti, tj = divmod(idx, n_tiles)
        generator = tile_generator(key, idx, device)
        positions = _tile_positions(float(ti * chunk_size),
                                    float(tj * chunk_size), chunk_size, device)
        rays = camera.sample_positions(positions, generator=generator,
                                       bundle_size=bundle_size, size=size,
                                       with_noise=with_noise)
        values, mask, it = integrator.sample(scene, rays, generator=generator,
                                             training=training)
        # mean over the bundle dim; background where no bundle ray hit
        valid = torch.any(mask, dim=-1)                      # [N, c, c]
        v = torch.mean(values, dim=-2)                       # [N, c, c, dims]
        out[:, ti * chunk_size:(ti + 1) * chunk_size,
            tj * chunk_size:(tj + 1) * chunk_size] = torch.where(
                valid[..., None], v, float(background))
    if squeeze_first and n == 1:
        out = out[0]
    return out, (None if scan_tiles else it)


def pathtrace_sample(scene: Scene, integrator, camera, uv, generator=None,
                     crop_size: int = 32, bundle_size: int = 1, size: int = 256,
                     with_noise=False, training: bool = True):
    """Render the ``crop_size``^2 window at pixel offset ``uv = (u, v)`` on
    the scene's device, differentiably (the training crop).  ``generator``
    draws the camera jitter and the integrator's randomness.  Returns
    ``(values [N, S, S, bundle, dims], active, it)``."""
    device = next(scene.parameters()).device
    positions = _tile_positions(float(uv[0]), float(uv[1]), crop_size, device)
    rays = camera.to(device).sample_positions(
        positions, generator=generator, bundle_size=bundle_size, size=size,
        with_noise=with_noise)
    return integrator.sample(scene, rays, generator=generator, training=training)
