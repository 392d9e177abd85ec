"""Numerics helpers shared across the port.

Counterpart of ``neural_raytracing_tpu/ops/math.py``.  The load-bearing
epsilons of the reference are kept verbatim: they are part of the behaviour.
"""

from __future__ import annotations

import functools
import math

import torch

PI = math.pi
TWO_PI = 2.0 * math.pi
INV_PI = 1.0 / math.pi


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The constant ``torch.tensor(values)``, made once per dtype and device:
    made at every call it is a host-to-device copy that waits for the card."""
    return torch.tensor(values, dtype=dtype, device=device)


# jnp's tie-breaking forms.  At a tie the JAX package's gradient is not
# torch's: jnp.maximum and jnp.clip split it in half where clamp_min and
# clamp pass all of it, and jnp.abs takes slope 1 at 0 where torch.abs
# takes 0.  These keep torch's values, bit for bit, and take JAX's gradient.

class _Clip(torch.autograd.Function):
    """``torch.clamp(x, lo, hi)`` with ``jnp.clip``'s gradient (``hi``
    None: ``jnp.maximum``'s; ``lo`` None: ``jnp.minimum``'s), the step
    function ``H(x - lo) H(hi - x)`` with ``H(0) = 1/2``: three launches a
    backward where ``torch.maximum`` takes five."""

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
            step = None if lo is None else torch.heaviside(x - lo, half)
            if hi is not None:
                upper = torch.heaviside(hi - x, half)
                step = upper if step is None else step * upper
        return g * step, None, None


def maximum(x: torch.Tensor, c) -> torch.Tensor:
    """``jnp.maximum(x, c)`` for a number ``c``, or a tensor ``c``: between
    two tensors ``torch.maximum`` already splits the gradient of a tie in
    half, as ``jnp.maximum`` does."""
    if isinstance(c, torch.Tensor):
        return torch.maximum(x, c)
    return _Clip.apply(x, c, None)


def minimum(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.minimum(x, c)`` for a number ``c``."""
    return _Clip.apply(x, None, c)


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


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.cross(a, b)`` over the last axis, the operands broadcast."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b)


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


def dot(a: torch.Tensor, b: torch.Tensor, keepdims: bool = True) -> torch.Tensor:
    return torch.sum(a * b, dim=-1, keepdim=keepdims)


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


def reflect(n: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Mirror ``v`` about the normal ``n`` (both pointing away from the surface)."""
    return 2.0 * torch.sum(n * v, dim=-1, keepdim=True) * n - v


def local_reflect(v: torch.Tensor) -> torch.Tensor:
    """Mirror about the local +z axis: ``(x, y, z) -> (-x, -y, z)``."""
    # negation builds no constant tensor (a host-to-device copy on the card)
    # and gives the bits, and the gradient, of a product with (-1, -1, 1)
    return torch.cat([-v[..., :2], v[..., 2:]], dim=-1)


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


def weak_sigmoid(x: torch.Tensor, k: float = 4e-4, sqrt_k: float = 2e-2,
                 eps: float = 1e-6) -> torch.Tensor:
    """Signed sqrt with a linear region near zero."""
    ax = absolute(x)
    return torch.where(ax < k, x / sqrt_k, torch.sign(x) * torch.sqrt(ax + eps))


def pos_weak_sigmoid(x: torch.Tensor, k: float = 4e-4, k_pow_3_2: float = 2e-2,
                     eps: float = 1e-5) -> torch.Tensor:
    """Positive symmetric variant of ``weak_sigmoid``."""
    ax = absolute(x)
    return torch.where(ax <= k, torch.square(x) / k_pow_3_2, torch.sqrt(ax + eps))


def fwidth(v: torch.Tensor) -> torch.Tensor:
    """``|ddx| + |ddy|`` over the image axes 1 and 2 of ``[N, W, H, ..., C]``
    (the last difference repeated at the far edge)."""
    dx = v[:, 1:] - v[:, :-1]
    dx = torch.cat([dx, dx[:, -1:]], dim=1)
    dy = v[:, :, 1:] - v[:, :, :-1]
    dy = torch.cat([dy, dy[:, :, -1:]], dim=2)
    return absolute(dx) + absolute(dy)


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product of quaternions stored ``[w, x, y, z]``."""
    t = r[..., :, None] * q[..., None, :]
    w = t[..., 0, 0] - t[..., 1, 1] - t[..., 2, 2] - t[..., 3, 3]
    x = t[..., 0, 1] + t[..., 1, 0] - t[..., 2, 3] + t[..., 3, 2]
    y = t[..., 0, 2] + t[..., 1, 3] + t[..., 2, 0] - t[..., 3, 1]
    z = t[..., 0, 3] - t[..., 1, 2] + t[..., 2, 1] + t[..., 3, 0]
    return torch.stack([w, x, y, z], dim=-1)


def quat_rot(v: torch.Tensor, axis: torch.Tensor, theta) -> torch.Tensor:
    """Rotate ``v`` about the unit ``axis`` by ``theta`` by quaternion
    conjugation."""
    q1 = torch.cat([torch.zeros_like(v[..., :1]), v], dim=-1)
    t2 = (torch.as_tensor(theta, dtype=v.dtype, device=v.device) / 2.0).expand(
        v.shape[:-1] + (1,))
    q2 = torch.cat([torch.cos(t2), torch.sin(t2) * axis], dim=-1)
    q2_inv = torch.cat([q2[..., :1], -q2[..., 1:]], dim=-1)
    return qmul(qmul(q2, q1), q2_inv)[..., 1:]


def almost_identity(x: torch.Tensor, thresh: float = 1e-1) -> torch.Tensor:
    """The identity above ``thresh`` in magnitude, a smooth cubic below."""
    x_abs = absolute(x)
    t = x_abs / thresh
    v = (x_abs - thresh) * t * t + thresh
    return torch.where(x_abs > thresh, x, torch.sign(x) * v)
