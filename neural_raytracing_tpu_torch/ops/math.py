"""Numerics helpers shared across the port.

Counterpart of ``neural_raytracing_tpu/ops/math.py``.  The load-bearing
epsilons of the reference are kept verbatim: they are part of the behaviour.
"""

from __future__ import annotations

import torch


def normalize(v: torch.Tensor, eps: float = 1e-7, dim: int = -1) -> torch.Tensor:
    """L2-normalize along ``dim``, clamping INSIDE the sqrt.

    The clamp inside keeps the gradient at ``v = 0`` at 0 instead of NaN;
    missed rays carry zero normals through ``where``.
    """
    n = torch.sqrt(torch.clamp_min(torch.sum(v * v, dim=dim, keepdim=True),
                                   eps * eps))
    return v / n


def nonzero_eps(v: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Replace near-zero entries with ``eps`` so atan2/divisions stay finite."""
    return torch.where(torch.abs(v) < eps, torch.full_like(v, eps), v)


def smooth_min(v: torch.Tensor, k: float = 32.0, dim: int = 0) -> torch.Tensor:
    """Clamped exponential smooth minimum ``-log(max(sum(exp(-k v)), 1e-4)) / k``.

    The 1e-4 clamp saturates the field at ``-log(1e-4)/k`` (0.288 for k=32).
    That plateau is the reference's behaviour and is kept.
    """
    return -torch.log(torch.clamp_min(torch.sum(torch.exp(-k * v), dim=dim),
                                      1e-4)) / k


def stable_smooth_min(v: torch.Tensor, k: float = 32.0,
                      dim: int = 0) -> torch.Tensor:
    """Exact exponential smooth minimum via logsumexp: ``-lse(-k v)/k``."""
    return -torch.logsumexp(-k * v, dim=dim) / k


def eikonal_loss(grad: torch.Tensor) -> torch.Tensor:
    """Mean squared deviation of ``||grad||`` from 1 (IDR surface regularizer).

    The norm clamps inside the sqrt: raw SDF gradients are exactly zero
    where the clamped smooth_min saturates, and a plain norm would give NaN
    gradients there.
    """
    n = torch.sqrt(torch.clamp_min(torch.sum(grad * grad, dim=-1), 1e-12))
    return torch.mean(torch.square(n - 1.0))


def mse2psnr(x) -> torch.Tensor:
    return -10.0 * torch.log10(torch.as_tensor(x, dtype=torch.float32))


def rotate_vector(v: torch.Tensor, axis: torch.Tensor, c: torch.Tensor,
                  s: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation of ``v`` about unit ``axis`` by the angle with cos ``c``, sin ``s``."""
    return (v * c
            + axis * torch.sum(v * axis, dim=-1, keepdim=True) * (1.0 - c)
            + torch.linalg.cross(axis, v, dim=-1) * s)
