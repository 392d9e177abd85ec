"""Training losses.

Counterpart of ``neural_raytracing_tpu/ops/losses.py`` (the reference's
``masked_loss``):
  * active pixels: throughput > 0 and mask == 1;
  * color loss = L1 + L2 + RMSE - log(SSIM) of the active-masked images, the
    means taken over the FULL crop; optional Reinhard tone mapping first;
  * a crop with no active pixel contributes no color loss;
  * miss loss = BCE(-with-logits) of throughput against the mask, averaged
    over the miss pixels;
  * total = mask_weight * miss + 10 * color.
"""

from __future__ import annotations

import torch

from .math import absolute, clip, maximum
from .ssim import ssim as ssim_fn


def binary_cross_entropy_with_logits(logits: torch.Tensor,
                                     targets: torch.Tensor) -> torch.Tensor:
    # numerically stable log(1 + exp(-|x|)) form
    return (maximum(logits, 0.0) - logits * targets
            + torch.log1p(torch.exp(-absolute(logits))))


def binary_cross_entropy(probs: torch.Tensor, targets: torch.Tensor,
                         eps: float = 1e-12) -> torch.Tensor:
    probs = clip(probs, eps, 1.0 - eps)
    return -(targets * torch.log(probs) + (1.0 - targets) * torch.log(1.0 - probs))


def masked_loss(got: torch.Tensor, exp: torch.Tensor, throughput: torch.Tensor,
                exp_mask: torch.Tensor, mask_weight: float = 1.0,
                with_logits: bool = True, tone_mapping: bool = False,
                with_ssim: bool = True) -> torch.Tensor:
    """Photometric + silhouette loss on an ``[N, W, H, 3]`` crop.

    ``throughput`` / ``exp_mask`` are ``[N, W, H]`` (logit alpha / binary mask).
    """
    active = (throughput > 0) & (exp_mask == 1)
    misses = ~active
    a = active[..., None].to(got.dtype)
    got_active = got * a
    exp_active = exp * a
    if tone_mapping:
        got_active = got_active / (1.0 + got_active)
        exp_active = exp_active / (1.0 + exp_active)

    diff = got_active - exp_active
    l1_loss = absolute(diff).mean()
    l2_loss = diff.square().mean()
    rmse_loss = torch.sqrt(maximum(l2_loss, 1e-10))
    color_loss = l1_loss + l2_loss + rmse_loss
    if with_ssim:
        ssim_val = ssim_fn(got_active.permute(0, 3, 1, 2),
                           exp_active.permute(0, 3, 1, 2), data_range=1.0)
        color_loss = color_loss - torch.log(maximum(ssim_val, 1e-10))
    # no active pixel: no color loss (the reference skips the branch)
    color_loss = torch.where(active.any(), color_loss, 0.0)

    if with_logits:
        bce = binary_cross_entropy_with_logits(throughput, exp_mask)
    else:
        bce = binary_cross_entropy(throughput, exp_mask)
    miss_count = misses.sum()
    mask_loss = torch.where(misses, bce, 0.0).sum() / torch.clamp_min(miss_count, 1)
    return mask_weight * mask_loss + 10.0 * color_loss
