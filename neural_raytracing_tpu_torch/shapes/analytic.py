"""Analytic shapes: ``Sphere`` and ``SphereCloud``.

Counterpart of ``neural_raytracing_tpu/shapes/analytic.py``: closed-form
ray-sphere intersections, used for BSDF visualisation renders and as a
known surface in the integrators' tests.  Neither has a learnable
parameter: their centres and radii are buffers outside the state dict, as
the JAX package's ``init`` returns no params for them.  The interface is
``SDF``'s: ``intersect(rays, max_t, primary, generator) -> (Interaction,
hit)`` and ``intersect_test(rays, max_t, active) -> not blocked``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..interaction import Interaction
from ..ops.math import normalize

EPS = 1e-8


def quad_solve(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """Both roots ``[..., 2]`` of ``a x^2 + b x + c`` and where they are
    valid (a positive discriminant)."""
    disc = b * b - 4.0 * a * c
    valid = disc > 0
    sq = torch.sqrt(torch.where(valid, disc, 0.0))
    roots = (-b[..., None] + torch.stack([sq, -sq], dim=-1)) / (2.0 * a[..., None])
    return roots, valid


def _min_positive_root(roots: torch.Tensor, valid: torch.Tensor):
    """The smallest root >= EPS (inf where none) and where there is one."""
    ok = roots >= EPS
    t = torch.amin(torch.where(ok, roots, math.inf), dim=-1)
    return t, valid & torch.any(ok, dim=-1)


def _interaction(r_o, r_d, t, hit, normal_of) -> tuple:
    """The hit record of ``SDF.intersect``'s layout (``p`` offset 1e-5 along
    the normal; zeros where no hit)."""
    t_safe = torch.where(hit, t, 0.0)
    p = r_o + t_safe[..., None] * r_d
    n = torch.where(hit[..., None], normalize(normal_of(p)), 0.0)
    it = Interaction(p=p + n * 1e-5, t=t_safe).with_normals(n)
    return it._replace(wi=it.to_local(-r_d)), hit


class Sphere(nn.Module):
    """One analytic sphere (not learnable)."""

    def __init__(self, center=(0.0, 0.0, 0.0), radius: float = 1.0):
        super().__init__()
        self.register_buffer("center", torch.tensor(center, dtype=torch.float32),
                             persistent=False)
        self.radius = float(radius)

    def reset_parameters(self, generator: torch.Generator = None):
        pass

    def _quad(self, rays):
        r_o, r_d = rays[..., :3], rays[..., 3:]
        fs = r_o - self.center
        a = torch.sum(r_d * r_d, dim=-1)
        b = 2.0 * torch.sum(r_d * fs, dim=-1)
        c = torch.sum(fs * fs, dim=-1) - self.radius * self.radius
        return quad_solve(a, b, c)

    def intersect(self, rays: torch.Tensor, max_t: float = 10.0, primary: bool = True,
                  generator=None):
        """-> (Interaction, hit [...]); ``max_t``, ``primary`` and
        ``generator`` are taken for ``SDF``'s interface and not used."""
        t, hit = _min_positive_root(*self._quad(rays))
        return _interaction(rays[..., :3], rays[..., 3:], t, hit, lambda p: p - self.center)

    def intersect_test(self, rays: torch.Tensor, max_t=math.inf, active=None):
        """True where the ray is NOT blocked before ``max_t``."""
        t, hit = _min_positive_root(*self._quad(rays))
        return ~(hit & (t < max_t))

    def intersect_limits(self, rays: torch.Tensor):
        """-> (entry t, exit t, hit): the smallest and largest roots >= EPS."""
        roots, valid = self._quad(rays)
        ok = roots >= EPS
        pos = torch.where(ok, roots, math.inf)
        lower = torch.amin(pos, dim=-1)
        upper = torch.amax(torch.where(torch.isfinite(pos), pos, -math.inf), dim=-1)
        return lower, upper, valid & torch.any(ok, dim=-1)


class SphereCloud(nn.Module):
    """Many spheres (``centers`` ``[S, 3]``, ``radii`` ``[S]`` or one
    radius); the nearest hit over a sphere axis."""

    def __init__(self, centers, radii):
        super().__init__()
        centers = torch.as_tensor(centers, dtype=torch.float32)
        radii = torch.as_tensor(radii, dtype=torch.float32)
        if radii.dim() == 0:
            radii = radii.expand(centers.shape[0]).clone()
        self.register_buffer("centers", centers, persistent=False)
        self.register_buffer("radii", radii, persistent=False)

    def reset_parameters(self, generator: torch.Generator = None):
        pass

    def _all_ts(self, rays, t_max):
        """-> (each sphere's nearest root in [EPS, t_max), inf where none
        [..., S]; whether it has one)."""
        r_o, r_d = rays[..., :3], rays[..., 3:]
        fs = r_o[..., None, :] - self.centers                        # [..., S, 3]
        a = torch.sum(r_d * r_d, dim=-1)[..., None].expand(fs.shape[:-1])
        b = 2.0 * torch.sum(r_d[..., None, :] * fs, dim=-1)
        c = torch.sum(fs * fs, dim=-1) - self.radii * self.radii
        roots, valid = quad_solve(a, b, c)                           # [..., S, 2]
        if isinstance(t_max, torch.Tensor):
            t_max = t_max[..., None, None]
        t = torch.amin(torch.where((roots >= EPS) & (roots < t_max), roots, math.inf),
                       dim=-1)
        mask = valid & torch.isfinite(t)
        return torch.where(mask, t, math.inf), mask

    def intersect(self, rays: torch.Tensor, max_t: float = math.inf, primary: bool = True,
                  generator=None):
        """-> (Interaction, hit [...]) of the nearest sphere before
        ``max_t``; ``primary`` and ``generator`` are not used."""
        ts, mask = self._all_ts(rays, max_t)
        t, idx = torch.min(ts, dim=-1)
        hit = torch.any(mask, dim=-1) & torch.isfinite(t)
        return _interaction(rays[..., :3], rays[..., 3:], t, hit,
                            lambda p: p - self.centers[idx])

    def intersect_test(self, rays: torch.Tensor, max_t=math.inf, active=None):
        """True where no sphere blocks the ray before ``max_t``."""
        ts, mask = self._all_ts(rays, max_t)
        if isinstance(max_t, torch.Tensor):
            max_t = max_t[..., None]
        return ~torch.any(mask & (ts < max_t), dim=-1)
