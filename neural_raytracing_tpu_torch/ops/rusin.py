"""Rusinkiewicz half/difference-angle BRDF parameterization.

Counterpart of ``param_rusin2`` in ``neural_raytracing_tpu/ops/rusin.py``:
wi/wo are in the local shading frame and the result is
``[cos(phi_d), cos(theta_h), cos(theta_d)]``.  Every epsilon clamp is kept,
including ``sqrt(max(1 - h_z, 1e-6))`` where the exact formula would use
``1 - h_z**2``.
"""

from __future__ import annotations

import torch

from .math import maximum, nonzero_eps, normalize, rotate_vector


def param_rusin2(wo: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """Local-frame Rusinkiewicz parameterization ``[..., 3]``."""
    wo = normalize(wo)
    wi = normalize(wi)
    e1 = wo.new_tensor([0.0, 1.0, 0.0]).expand(wo.shape)
    e2 = wo.new_tensor([0.0, 0.0, 1.0]).expand(wo.shape)

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
