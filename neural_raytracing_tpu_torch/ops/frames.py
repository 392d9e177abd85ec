"""Orthonormal shading frames and local/world direction transforms.

Counterpart of ``neural_raytracing_tpu/ops/frames.py``.  Frames are
``[..., 3, 3]`` with COLUMNS (s, t, n); ``frame[..., 2]`` is the normal.
"""

from __future__ import annotations

import torch

from .math import normalize


def coordinate_system(n: torch.Tensor) -> torch.Tensor:
    """Build a ``[..., 3, 3]`` orthonormal frame (columns s, t, n) from normals."""
    n = normalize(n, eps=1e-7)
    x, y, z = n[..., 0:1], n[..., 1:2], n[..., 2:3]
    sign = torch.where(z >= 0, 1.0, -1.0)
    s_z = sign + z
    a = -1.0 / torch.where(torch.abs(s_z) < 1e-6, torch.full_like(s_z, 1e-6),
                           s_z)
    b = x * y * a

    s = torch.cat([x * x * a * sign + 1.0, b * sign, x * -sign], dim=-1)
    s = normalize(s, eps=1e-7)
    t = normalize(torch.linalg.cross(s, n, dim=-1), eps=1e-7)
    s = normalize(torch.linalg.cross(n, t, dim=-1), eps=1e-7)
    return torch.stack([s, t, n], dim=-1)


def partial_frame(n: torch.Tensor, wi: torch.Tensor) -> torch.Tensor:
    """A frame from a normal and an incident direction (columns n, wi,
    n x wi)."""
    c = normalize(torch.linalg.cross(*torch.broadcast_tensors(n, wi), dim=-1), eps=1e-7)
    return torch.stack([n, wi, c], dim=-1)


def to_local(frame: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """World direction -> local frame coordinates (then renormalized)."""
    out = torch.einsum("...ij,...i->...j", frame, wo)
    return normalize(out, eps=1e-7)


def from_local(frame: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Local frame coordinates -> world direction (then renormalized)."""
    out = torch.einsum("...ij,...j->...i", frame, v)
    return normalize(out, eps=1e-7)
