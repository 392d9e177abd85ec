"""Differentiable SSIM / MS-SSIM.

Counterpart of ``neural_raytracing_tpu/ops/ssim.py`` (the ``pytorch_msssim``
definition): gaussian window 11, sigma 1.5, K = (0.01, 0.03), a "valid"
separable depthwise blur, per-(batch, channel) maps averaged.  Images are
NCHW.

The blur is a float32 convolution; on a GPU cuDNN runs those in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False, and SSIM's
``E[x^2] - mu^2`` cancellation then gives errors of the order of
``C2 = 9e-4``.  The blur therefore turns TF32 off for its own convolutions
(the JAX code forces ``Precision.HIGHEST`` for the same reason).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

MS_SSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


@functools.lru_cache(maxsize=8)
def _gaussian_kernel(win_size: int, sigma: float) -> np.ndarray:
    coords = np.arange(win_size, dtype=np.float32) - win_size // 2
    g = np.exp(-np.square(coords) / (2.0 * sigma * sigma))
    return g / np.sum(g)


@functools.lru_cache(maxsize=8)
def _gaussian_taps(win_size: int, sigma: float, dtype, device) -> torch.Tensor:
    # on the input's device once: a copy at every blur waits for the card
    return torch.from_numpy(_gaussian_kernel(win_size, sigma)).to(device, dtype)


def _gaussian_blur(x: torch.Tensor, win_size: int, sigma: float) -> torch.Tensor:
    """Separable 'valid' gaussian filter of an NCHW tensor, depthwise."""
    c = x.shape[1]
    g = _gaussian_taps(win_size, sigma, x.dtype, x.device)
    kh = g.reshape(1, 1, win_size, 1).expand(c, 1, win_size, 1)
    kw = g.reshape(1, 1, 1, win_size).expand(c, 1, 1, win_size)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return F.conv2d(F.conv2d(x, kh, groups=c), kw, groups=c)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _ssim_components(x, y, data_range, win_size, sigma, k1, k2):
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_x = _gaussian_blur(x, win_size, sigma)
    mu_y = _gaussian_blur(y, win_size, sigma)
    mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
    sigma_xx = _gaussian_blur(x * x, win_size, sigma) - mu_xx
    sigma_yy = _gaussian_blur(y * y, win_size, sigma) - mu_yy
    sigma_xy = _gaussian_blur(x * y, win_size, sigma) - mu_xy
    cs_map = (2.0 * sigma_xy + c2) / (sigma_xx + sigma_yy + c2)
    ssim_map = ((2.0 * mu_xy + c1) / (mu_xx + mu_yy + c1)) * cs_map
    return ssim_map, cs_map


def ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
         win_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03, size_average: bool = True) -> torch.Tensor:
    """SSIM over NCHW images; a scalar if ``size_average``, else ``[N]``."""
    ssim_map, _ = _ssim_components(x, y, data_range, win_size, sigma, k1, k2)
    if size_average:
        return ssim_map.mean()
    return ssim_map.mean(dim=(1, 2, 3))


def ms_ssim(x: torch.Tensor, y: torch.Tensor, data_range: float = 1.0,
            win_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
            k2: float = 0.03, weights=MS_SSIM_WEIGHTS,
            size_average: bool = True) -> torch.Tensor:
    """Multi-scale SSIM over NCHW images (2x2 average pool between scales)."""
    weights = torch.as_tensor(weights, dtype=x.dtype, device=x.device)
    levels = weights.shape[0]
    min_side = min(x.shape[-1], x.shape[-2])
    if min_side <= (win_size - 1) * 2 ** (levels - 1):
        raise ValueError(f"image too small ({min_side}) for {levels}-level "
                         f"ms-ssim with window {win_size}")
    mcs = []
    for i in range(levels):
        ssim_map, cs_map = _ssim_components(x, y, data_range, win_size, sigma,
                                            k1, k2)
        if i < levels - 1:
            mcs.append(torch.relu(cs_map.mean(dim=(1, 2, 3))))
            # odd sides are zero-padded at the end, as the JAX reduce_window
            pad = (0, x.shape[3] % 2, 0, x.shape[2] % 2)
            x = F.avg_pool2d(F.pad(x, pad), 2)
            y = F.avg_pool2d(F.pad(y, pad), 2)
    ssim_val = torch.relu(ssim_map.mean(dim=(1, 2, 3)))
    stacked = torch.stack(mcs + [ssim_val], dim=0)          # [levels, N]
    out = torch.prod(stacked ** weights[:, None], dim=0)
    return out.mean() if size_average else out
