"""Small utilities of the reference's grab-bag.

Counterpart of ``neural_raytracing_tpu/ops/misc.py``: the partition helpers
of the partitioned auto-decoders (``cartesian_to_log_polar``,
``log_polar_indices``, ``cartesian_indices``; their bins are int32 floors,
as in JAX), ``finite_diff_ray``, the 3x3 Laplacian ``edge_detection``,
``gaussian_kernel``, ``inverse_tan_activation`` and ``crop``.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .math import PI, TWO_PI, clip, maximum, nonzero_eps


def cartesian_to_log_polar(p: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    r = maximum(torch.sum(torch.square(p), dim=-1, keepdim=True), eps)
    x, y, z = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    phi = torch.atan2(nonzero_eps(y, eps), nonzero_eps(x, eps))
    theta = torch.atan2(torch.sqrt(maximum(x * x + y * y, eps)), nonzero_eps(z, eps))
    return torch.cat([torch.log(r), phi, theta], dim=-1)


def log_polar_indices(lp: torch.Tensor, max_lr: float = 15.0, n_lr: int = 8,
                      n_phi: int = 8, n_theta: int = 8):
    """Bin log-polar coordinates -> (int32 bin indices, local coordinates)."""
    lr = clip(lp[..., 0:1], 0.0, max_lr)
    phi = clip(lp[..., 1:2] + PI, 0.0, TWO_PI)
    theta = clip(lp[..., 2:3] + PI, 0.0, TWO_PI)
    lr_idx = clip(lr * (n_lr / max_lr), 0.0, float(n_lr))
    phi_idx = clip(phi * (n_phi / TWO_PI), 0.0, float(n_phi))
    theta_idx = clip(theta * (n_theta / TWO_PI), 0.0, float(n_theta))
    idx = torch.floor(torch.cat([lr_idx, phi_idx, theta_idx], dim=-1)).to(torch.int32) - 1
    local = torch.cat([lr - lr_idx * (max_lr / n_lr), phi - phi_idx * (PI / n_phi),
                       theta - theta_idx * (PI / n_theta)], dim=-1)
    return idx, local


def cartesian_indices(xyz: torch.Tensor, bound: float = 3.0, n: int = 8):
    """Bin ``xyz`` in ``[-bound, bound]^3`` -> (int32 indices, local
    coordinates)."""
    xyz = clip(xyz, -bound, bound) + bound
    inv = (n - 1) / (2.0 * bound)
    idx = torch.clamp(torch.floor(xyz * inv).to(torch.int32), 0, n - 1)
    return idx, xyz * inv - idx


def finite_diff_ray(r_d: torch.Tensor, eps: float = 1e-5):
    """Two neighbouring directions, offset along two directions orthogonal
    to ``r_d``."""
    x, y, z = r_d[..., 0:1], r_d[..., 1:2], r_d[..., 2:3]
    sign = torch.sign(z)
    a = 1.0 / (-(sign + z) + 1e-5)
    b = x * y * a
    s = torch.cat([x * x * a * sign + 1.0, b * sign, x * -sign], dim=-1)
    t = torch.cat([b, sign + y * y * a, -y], dim=-1)
    return r_d + s * eps, r_d + t * eps


def edge_detection(img: torch.Tensor) -> torch.Tensor:
    """The 3x3 Laplacian edge filter of an ``[H, W, C]`` image (valid
    convolution, each channel on its own)."""
    c = img.shape[-1]
    k = torch.tensor([[-1.0, -1, -1], [-1, 8, -1], [-1, -1, -1]], dtype=img.dtype,
                     device=img.device)
    out = F.conv2d(img.permute(2, 0, 1)[None], k.expand(c, 1, 3, 3), groups=c)
    return out[0].permute(1, 2, 0)


def gaussian_kernel(n: int, sigma: float = 3.0, device="cpu") -> torch.Tensor:
    """The ``(2n+1)^2`` Gaussian stencil, normalised to sum 1."""
    coords = np.arange(-n, n + 1, dtype=np.float32)
    g = np.exp(-coords ** 2 / (2.0 * sigma ** 2))
    k = np.outer(g, g)
    return torch.as_tensor(k / k.sum(), dtype=torch.float32, device=device)


def inverse_tan_activation(x: torch.Tensor, eps: float = 1e-1) -> torch.Tensor:
    """``[-1, 1]`` -> nearly unbounded, by ``tan``."""
    return torch.tan(x * math.pi / (2.0 + eps))


def crop(img, u: int, v: int, size: int):
    return img[u:u + size, v:v + size]
