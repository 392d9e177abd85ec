"""The published training loss in plain PyTorch: the masked photometric loss
(L1 + L2 + RMSE - log SSIM of the active pixels, means over the whole crop)
plus the silhouette's binary cross-entropy with logits over the missed
pixels, ``mask_weight * miss + 10 * colour``, and the eikonal term."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _blur(x, win: int = 11, sigma: float = 1.5):
    coords = np.arange(win, dtype=np.float32) - win // 2
    g = np.exp(-np.square(coords) / (2.0 * sigma * sigma))
    g = torch.from_numpy(g / np.sum(g)).to(x.device, x.dtype)
    c = x.shape[1]
    out = F.conv2d(x, g.reshape(1, 1, win, 1).expand(c, 1, win, 1), groups=c)
    return F.conv2d(out, g.reshape(1, 1, 1, win).expand(c, 1, 1, win), groups=c)


def ssim(x, y, data_range: float = 1.0, k1: float = 0.01, k2: float = 0.03):
    """SSIM of NCHW images: a gaussian window 11 wide, sigma 1.5, 'valid'."""
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    mu_x, mu_y = _blur(x), _blur(y)
    sxx = _blur(x * x) - mu_x * mu_x
    syy = _blur(y * y) - mu_y * mu_y
    sxy = _blur(x * y) - mu_x * mu_y
    cs = (2.0 * sxy + c2) / (sxx + syy + c2)
    return (((2.0 * mu_x * mu_y + c1) / (mu_x * mu_x + mu_y * mu_y + c1)) * cs).mean()


def masked_loss(got, exp, throughput, mask, *, mask_weight: float, with_ssim: bool):
    """``got``/``exp`` ``[N, S, S, 3]``, ``throughput`` (logits) and ``mask``
    ``[N, S, S]``."""
    active = (throughput > 0) & (mask == 1)
    a = active[..., None].to(got.dtype)
    diff = got * a - exp * a
    l2 = diff.square().mean()
    colour = torch.abs(diff).mean() + l2 + torch.sqrt(torch.clamp_min(l2, 1e-10))
    if with_ssim:
        s = ssim((got * a).permute(0, 3, 1, 2), (exp * a).permute(0, 3, 1, 2))
        colour = colour - torch.log(torch.clamp_min(s, 1e-10))
    colour = torch.where(active.any(), colour, 0.0)
    bce = (torch.clamp_min(throughput, 0.0) - throughput * mask
           + torch.log1p(torch.exp(-torch.abs(throughput))))
    misses = ~active
    miss = torch.where(misses, bce, 0.0).sum() / torch.clamp_min(misses.sum(), 1)
    return mask_weight * miss + 10.0 * colour


def eikonal(grad):
    n = torch.sqrt(torch.clamp_min(torch.sum(grad * grad, dim=-1), 1e-12))
    return torch.mean(torch.square(n - 1.0))
