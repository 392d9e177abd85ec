"""Rusinkiewicz half/difference-angle BRDF parameterization.

Counterpart of ``neural_raytracing_tpu/ops/rusin.py``: in
``param_rusin2`` wi/wo are in the local shading frame and the result is
``[cos(phi_d), cos(theta_h), cos(theta_d)]``; ``param_rusin`` takes world
vectors, first turns the frame so that ``n`` is +z, and returns
``[phi_d, cos(theta_h), cos(theta_d)]``.  Every epsilon clamp is kept,
including ``sqrt(max(1 - h_z, 1e-6))`` where the exact formula would use
``1 - h_z**2``; the clamps take the tie forms of ``ops.math``.
"""

from __future__ import annotations

import torch

from .math import clip, device_constant, maximum, nonzero_eps, normalize, rotate_vector


def param_rusin2(wo: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """Local-frame Rusinkiewicz parameterization ``[..., 3]``."""
    wo = normalize(wo)
    wi = normalize(wi)
    e1 = device_constant((0.0, 1.0, 0.0), wo.dtype, wo.device).expand(wo.shape)
    e2 = device_constant((0.0, 0.0, 1.0), wo.dtype, wo.device).expand(wo.shape)

    h = normalize(wo + wi)
    cos_theta_h = h[..., 2]

    # rotate wi about z by -phi_h (cos/sin without trig round-trips)
    r = maximum(torch.hypot(nonzero_eps(h[..., 1]), nonzero_eps(h[..., 0])), 1e-6)
    c = (h[..., 0] / r)[..., None]
    s = -(h[..., 1] / r)[..., None]
    tmp = normalize(rotate_vector(wi, e2, c, s))

    # rotate about y by -theta_h
    c = h[..., 2][..., None]
    s = -torch.sqrt(maximum(1.0 - h[..., 2], 1e-6))[..., None]
    diff = normalize(rotate_vector(tmp, e1, c, s))

    cos_theta_d = diff[..., 2]
    cos_phi_d = torch.cos(torch.atan2(nonzero_eps(diff[..., 1]),
                                      nonzero_eps(diff[..., 0])))
    return torch.stack([cos_phi_d, cos_theta_h, cos_theta_d], dim=-1)


def param_rusin(n: torch.Tensor, wo: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """World-frame variant ``[..., 3]``: a half turn about the bisector of
    ``n`` and +z maps ``n`` to +z first."""
    n = normalize(n)
    wo = normalize(wo)
    wi = normalize(wi)
    e2 = device_constant((0.0, 0.0, 1.0), n.dtype, n.device).expand(n.shape)
    midway = normalize((n + e2) / 2.0)

    # 180-degree rotation about the bisector maps n -> z
    wo = rotate_vector(wo, midway, -torch.ones_like(wo), torch.zeros_like(wo))
    wi = rotate_vector(wi, midway, -torch.ones_like(wi), torch.zeros_like(wi))

    h = normalize((wo + wi) / 2.0)
    cos_theta_h = clip(h[..., 2:3], -1.0, 1.0)
    phi_h = torch.atan2(nonzero_eps(h[..., 1]), nonzero_eps(h[..., 0]))

    v = -phi_h[..., None]
    tmp = normalize(rotate_vector(wi, n, torch.cos(v), torch.sin(v)))

    sin_theta_h = -torch.sqrt(maximum(1.0 - torch.square(cos_theta_h), 1e-6))
    e1 = device_constant((0.0, 1.0, 0.0), n.dtype, n.device).expand(tmp.shape)
    diff = normalize(rotate_vector(tmp, e1, cos_theta_h, sin_theta_h))

    cos_theta_d = diff[..., 2]
    phi_d = torch.atan2(nonzero_eps(diff[..., 1]), nonzero_eps(diff[..., 0]))
    return torch.stack([phi_d, cos_theta_h[..., 0], cos_theta_d], dim=-1)
