"""Fragment blending: the counterpart of the reference's csrc/blending
(sigmoid_alpha_blend) and the renderer-side hard and softmax blends.

Counterpart of ``neural_raytracing_tpu/raster/blending.py``: elementwise
math on the ``[H, W, K]`` fragment buffers, differentiable by autograd.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.math import maximum
from .rasterize import Fragments


def _background(background, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(background, dtype=like.dtype, device=like.device)


def hard_rgb_blend(colors: torch.Tensor, fragments: Fragments,
                   background: Tuple[float, float, float] = (1.0, 1.0, 1.0)) -> torch.Tensor:
    """The nearest fragment wins: colors ``[H, W, K, 3]`` -> RGBA ``[H, W, 4]``."""
    valid = fragments.idx[..., 0] >= 0
    rgb = torch.where(valid[..., None], colors[..., 0, :], _background(background, colors))
    return torch.cat([rgb, valid[..., None].to(colors.dtype)], dim=-1)


def sigmoid_alpha_blend(fragments: Fragments, sigma: float = 1e-4) -> torch.Tensor:
    """The soft silhouette: each fragment's ``prob = sigmoid(-dist /
    sigma)``, ``alpha = 1 - prod_k (1 - prob_k)`` -> ``[H, W]``; ``dists``
    are the signed squared edge distances of ``rasterize_meshes``."""
    prob = torch.where(fragments.idx >= 0, torch.sigmoid(-fragments.dists / sigma), 0.0)
    return 1.0 - torch.prod(1.0 - prob, dim=-1)


def softmax_rgb_blend(colors: torch.Tensor, fragments: Fragments, sigma: float = 1e-4,
                      gamma: float = 1e-4,
                      background: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                      znear: float = 1.0, zfar: float = 100.0) -> torch.Tensor:
    """SoftRas aggregation, coverage x a depth softmax with a background
    weight: colors ``[H, W, K, 3]`` -> RGBA ``[H, W, 4]``."""
    eps = 1e-10
    valid = fragments.idx >= 0
    prob = torch.where(valid, torch.sigmoid(-fragments.dists / sigma), 0.0)
    alpha = 1.0 - torch.prod(1.0 - prob, dim=-1)

    z_inv = torch.where(valid, (zfar - fragments.zbuf) / (zfar - znear), 0.0)
    z_inv_max = maximum(torch.amax(z_inv, dim=-1, keepdim=True), eps)
    weights = prob * torch.exp((z_inv - z_inv_max) / gamma)
    delta = torch.exp((eps - z_inv_max[..., 0]) / gamma)
    denom = torch.sum(weights, dim=-1) + delta
    rgb = (torch.sum(weights[..., None] * colors, dim=-2)
           + delta[..., None] * _background(background, colors)) / denom[..., None]
    return torch.cat([rgb, alpha[..., None]], dim=-1)
