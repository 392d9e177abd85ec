"""Point-splat compositing: the counterpart of pytorch3d/csrc/compositing
(alpha composite, weighted sum, normalised weighted sum).

Counterpart of ``neural_raytracing_tpu/raster/compositing.py``: the csrc
kernels walk a pixel's K fragments front to back; here the walk is an
exclusive cumulative product over the K axis, differentiable by autograd.
(The volume compositing of the NeRF path is K8, ``kernels.composite``.)

Layout: idx ``[H, W, K]`` (-1 empty, as ``rasterize_points`` gives it),
alphas ``[H, W, K]``, features ``[P, C]`` -> an image ``[H, W, C]``.
"""

from __future__ import annotations

import torch

from ..ops.math import maximum


def _gather(features: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    f = features[torch.clamp_min(idx, 0).long()]           # [H, W, K, C]
    return torch.where((idx >= 0)[..., None], f, 0.0)


def _masked_alpha(alphas: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.where(idx >= 0, alphas, 0.0)


def alpha_composite(features: torch.Tensor, alphas: torch.Tensor,
                    idx: torch.Tensor) -> torch.Tensor:
    """Front-to-back over: ``sum_k a_k prod_{j<k} (1 - a_j) f_k``."""
    a = _masked_alpha(alphas, idx)
    trans = torch.cumprod(1.0 - a, dim=-1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], dim=-1)
    return torch.sum((a * trans)[..., None] * _gather(features, idx), dim=-2)


def weighted_sum(features: torch.Tensor, alphas: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """``sum_k a_k f_k``."""
    a = _masked_alpha(alphas, idx)
    return torch.sum(a[..., None] * _gather(features, idx), dim=-2)


def norm_weighted_sum(features: torch.Tensor, alphas: torch.Tensor, idx: torch.Tensor,
                      eps: float = 1e-8) -> torch.Tensor:
    """``sum_k a_k f_k / max(sum_k a_k, eps)``."""
    a = _masked_alpha(alphas, idx)
    denom = maximum(torch.sum(a, dim=-1, keepdim=True), eps)
    return torch.sum((a / denom)[..., None] * _gather(features, idx), dim=-2)
