"""Scene edits over a trained SDF: point warps and value edits.

Counterpart of ``neural_raytracing_tpu/edits.py``.  A point warp
(``bend``, ``translate_above``, ``scale_axis``, or their ``compose``) maps
each point before the surface: ``sdf.with_warp(bend(k=2.5))``.  A value
edit (``add_hole``, ``displace``) changes the surface's values:
``SDF(EditedModule(sdf.module, displace))``, or ``value_edited`` with the
settings the JAX scripts carry over.  Every edit builds new
tensors (no in-place write on a tensor autograd needs for the normals), and
neither kind is taken by the kernels, so an edited SDF marches by the plain
loops, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from .ops.math import device_constant, maximum
from .shapes.sdf import SDF, adopt_surface


def bend(k: float = 2.5, axis: int = 1) -> Callable:
    """Rotate x and z by an angle proportional to the ``axis`` coordinate."""

    def warp(p):
        x, y, z = p[..., 0:1], p[..., 1:2], p[..., 2:3]
        v = p[..., axis:axis + 1] * k
        c, s = torch.cos(v), -torch.sin(v)
        return torch.cat([c * x - s * z, y, s * x + c * z], dim=-1)

    return warp


def translate_above(a: float = 0.1, thresh: float = -0.05, coord: int = 1,
                    move: int = 0) -> Callable:
    """Shift coordinate ``move`` by ``a`` where coordinate ``coord`` > ``thresh``."""

    def warp(p):
        cols = list(p.unbind(-1))
        cols[move] = cols[move] + a * (p[..., coord] > thresh).to(p.dtype)
        return torch.stack(cols, dim=-1)

    return warp


def scale_axis(s: float = 0.2, axis: int = 2) -> Callable:
    """Stretch space along one axis (the SDF sees ``p_axis / s``)."""

    def warp(p):
        cols = list(p.unbind(-1))
        cols[axis] = cols[axis] / s
        return torch.stack(cols, dim=-1)

    return warp


def add_hole(sdf_fn: Callable, radius: float = 0.2, center=(0.0, 0.0, 0.0)) -> Callable:
    """Subtract a sphere from an SDF value function (CSG ``max(sdf, -sphere)``).

    At the sphere's centre the distance's gradient is torch's 0 where the
    JAX package's ``jnp.linalg.norm`` gives NaN."""
    center = tuple(float(c) for c in center)

    def edited(p):
        prev = sdf_fn(p)
        cut = torch.linalg.norm(p - device_constant(center, p.dtype, p.device), dim=-1) - radius
        return maximum(prev, -cut)

    return edited


def displace(sdf_fn: Callable, amp: float = 0.05, freq: float = 20.0) -> Callable:
    """Add a cosine-product displacement to an SDF value function."""

    def edited(p):
        out = sdf_fn(p)
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        return out + amp * (torch.cos(freq * x) * torch.cos(freq * y) * torch.cos(freq * z))

    return edited


class EditedModule(nn.Module):
    """A surface module under a value edit (``add_hole``, ``displace``):
    ``forward(p) = edit_fn(module)(p)``.

    It owns no parameters: it exposes the wrapped surface's parameters and
    children under the same names, so ``SDF(EditedModule(...))`` names them
    as ``SDF(module)`` does (``centers``, ``shift.layers.0.w``, ...) and a
    scene artifact loads the same before and after the edit."""

    def __init__(self, module: nn.Module, edit_fn: Callable):
        super().__init__()
        adopt_surface(self, module)
        self.edit = edit_fn(module)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.module.reset_parameters(generator)

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        return self.edit(p)


def value_edited(sdf: SDF, edit_fn: Callable) -> SDF:
    """``sdf``'s surface under the value edit ``edit_fn``, as the JAX
    scripts rebuild it: ``SDF(EditedModule(...))`` with only ``epsilon``,
    ``max_steps``, ``dist`` and ``throughput_steps`` carried over."""
    return SDF(EditedModule(sdf.module, edit_fn), epsilon=sdf.epsilon,
               max_steps=sdf.max_steps, dist=sdf.dist, throughput_steps=sdf.throughput_steps)


def compose(*warps: Callable) -> Callable:
    """Compose point warps left to right."""

    def warp(p):
        for w in warps:
            p = w(p)
        return p

    return warp
