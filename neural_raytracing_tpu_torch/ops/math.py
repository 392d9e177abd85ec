"""Numerics helpers shared across the port.

Counterpart of ``neural_raytracing_tpu/ops/math.py``.  The load-bearing
epsilons of the reference are kept verbatim: they are part of the behaviour.
"""

from __future__ import annotations

import torch


# jnp's tie-breaking forms.  At a tie the JAX package's gradient is not
# torch's: jnp.maximum and jnp.clip split it in half where clamp_min and
# clamp pass all of it, and jnp.abs takes slope 1 at 0 where torch.abs
# takes 0.  These keep torch's values, bit for bit, and take JAX's gradient.

class _Clip(torch.autograd.Function):
    """``torch.clamp(x, lo, hi)`` with ``jnp.clip``'s gradient (``hi``
    None: ``jnp.maximum``'s), the step function ``H(x - lo) H(hi - x)``
    with ``H(0) = 1/2``: three launches a backward where ``torch.maximum``
    takes five."""

    @staticmethod
    def forward(ctx, x, lo, hi):
        ctx.save_for_backward(x)
        ctx.bounds = (lo, hi)
        return torch.clamp(x, lo, hi)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lo, hi = ctx.bounds
        half = torch.tensor(0.5, dtype=x.dtype)
        with torch.no_grad():         # a step function: no gradient of its own
            step = torch.heaviside(x - lo, half)
            if hi is not None:
                step = step * torch.heaviside(hi - x, half)
        return g * step, None, None


def maximum(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)`` for a number ``c``."""
    return _Clip.apply(x, c, None)


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``."""
    return _Clip.apply(x, lo, hi)


class _Abs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def absolute(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs(x)``: ``torch.abs``'s values (``abs(-0.0)`` is ``+0.0``),
    with the gradient ``where(x >= 0, 1, -1)``, built from differentiable
    ops."""
    return _Abs.apply(x)


def normalize(v: torch.Tensor, eps: float = 1e-7, dim: int = -1) -> torch.Tensor:
    """L2-normalize along ``dim``, clamping INSIDE the sqrt.

    The clamp inside keeps the gradient at ``v = 0`` at 0 instead of NaN;
    missed rays carry zero normals through ``where``.
    """
    n = torch.sqrt(maximum(torch.sum(v * v, dim=dim, keepdim=True), eps * eps))
    return v / n


def nonzero_eps(v: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Replace near-zero entries with ``eps`` so atan2/divisions stay finite."""
    return torch.where(torch.abs(v) < eps, torch.full_like(v, eps), v)


def smooth_min(v: torch.Tensor, k: float = 32.0, dim: int = 0) -> torch.Tensor:
    """Clamped exponential smooth minimum ``-log(max(sum(exp(-k v)), 1e-4)) / k``.

    The 1e-4 clamp saturates the field at ``-log(1e-4)/k`` (0.288 for k=32).
    That plateau is the reference's behaviour and is kept.
    """
    return -torch.log(maximum(torch.sum(torch.exp(-k * v), dim=dim), 1e-4)) / k


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
    n = torch.sqrt(maximum(torch.sum(grad * grad, dim=-1), 1e-12))
    return torch.mean(torch.square(n - 1.0))


def mse2psnr(x) -> torch.Tensor:
    return -10.0 * torch.log10(torch.as_tensor(x, dtype=torch.float32))


def rotate_vector(v: torch.Tensor, axis: torch.Tensor, c: torch.Tensor,
                  s: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation of ``v`` about unit ``axis`` by the angle with cos ``c``, sin ``s``."""
    return (v * c
            + axis * torch.sum(v * axis, dim=-1, keepdim=True) * (1.0 - c)
            + torch.linalg.cross(axis, v, dim=-1) * s)
