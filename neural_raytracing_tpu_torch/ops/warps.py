"""Sampling-space warps (unit square -> disk / sphere / hemisphere) and their
densities.

Counterpart of ``neural_raytracing_tpu/ops/warps.py``.  Every warp takes
uniform samples in ``[0, 1]^2`` in the last axis; ``random_on_sphere``
draws its own through ``ops.sampling.uniform``.
"""

from __future__ import annotations

import math

import torch

from . import sampling
from .math import absolute, clip, maximum


def circ(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(maximum(1.0 - torch.square(x), 1e-10))


def square_to_uniform_disk_concentric(sample: torch.Tensor) -> torch.Tensor:
    """Shirley-Chiu concentric map, branch-free as in the JAX package."""
    v = 2.0 * sample - 1.0
    is_zero = torch.all(v == 0.0, dim=-1, keepdim=True)
    quadrant_1_or_3 = torch.abs(v[..., 0:1]) < torch.abs(v[..., 1:2])
    x, y = v[..., 0:1], v[..., 1:2]

    r = torch.where(quadrant_1_or_3, y, x)
    rp = torch.where(quadrant_1_or_3, x, y)

    r_safe = torch.sign(r) * maximum(absolute(r), 1e-12)
    phi = 0.25 * math.pi * rp / r_safe
    phi = torch.where(quadrant_1_or_3, 0.5 * math.pi - phi, phi)
    phi = torch.where(is_zero, torch.zeros_like(phi), phi)

    return torch.cat([r * torch.sin(phi), r * torch.cos(phi)], dim=-1)


def square_to_uniform_sphere(sample: torch.Tensor) -> torch.Tensor:
    z = 1.0 - 2.0 * sample[..., 1]
    r = circ(z)
    tmp = 2.0 * math.pi * sample[..., 0] - math.pi
    return torch.stack([r * torch.cos(tmp), r * torch.sin(tmp), z], dim=-1)


def square_to_uniform_sphere_pdf(sample: torch.Tensor) -> float:
    return 1.0 / (4.0 * math.pi)


def square_to_cos_hemisphere(sample: torch.Tensor) -> torch.Tensor:
    p = square_to_uniform_disk_concentric(sample)
    z = torch.sqrt(maximum(1.0 - torch.sum(p * p, dim=-1, keepdim=True), 1e-7))
    return torch.cat([p, z], dim=-1)


def square_to_cos_hemisphere_pdf(d: torch.Tensor) -> torch.Tensor:
    return d[..., 2] / math.pi


def random_on_sphere(generator, batches: int, device, dtype: torch.dtype = torch.float32):
    """Sphere directions ``[batches, 3]`` and the uniform ``uv [batches, 2]``
    that made them (drawn through ``ops.sampling.uniform``), both in
    ``dtype``: the draw and the trigonometry run in it."""
    # a float32 draw keeps uniform's float32 call, the one that a replay of
    # the JAX package's draws stands in for (see ops.sampling)
    kw = {} if dtype == torch.float32 else {"dtype": dtype}
    uv = sampling.uniform(generator, (batches, 2), device, **kw)
    u, v = uv[..., 0:1], uv[..., 1:2]
    theta = 2.0 * math.pi * u
    phi = torch.arccos(clip(2.0 * v - 1.0, -1.0, 1.0))
    d = torch.cat([torch.sin(theta) * torch.cos(phi),
                   torch.sin(theta) * torch.sin(phi),
                   torch.cos(theta)], dim=-1)
    return d, uv
