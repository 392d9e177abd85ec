"""Ray / segment / point geometry helpers.

Counterpart of ``neural_raytracing_tpu/ops/geometry.py`` (the reference's
pytorch3d/pathtracer/scene.py:169-287):
  * ``ray_point_dist``: the distance from rays to points;
  * ``distance_between_rays_and_segments``: the closest distance between
    rays and line segments;
  * ``mesh_level_surfaces``: each ray's minimum distance to a mesh's edges
    (the reference's approximation of the ray-mesh distance).
"""

from __future__ import annotations

import torch

from .math import clip, maximum, normalize


def ray_point_dist(r_o: torch.Tensor, r_d: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """r_o / r_d ``[..., 3]``, points ``[P, 3]`` -> ``[..., P]``: the distance
    from the half-ray (closest approach clamped to t >= 0) to each point."""
    d = normalize(r_d)
    w = points - r_o[..., None, :]                       # [..., P, 3]
    along = maximum(torch.sum(w * d[..., None, :], dim=-1), 0.0)
    closest = r_o[..., None, :] + along[..., None] * d[..., None, :]
    return torch.linalg.norm(points - closest, dim=-1)


def distance_between_rays_and_segments(r_o, r_d, seg_a, seg_b, eps: float = 1e-8):
    """r_o / r_d ``[..., 3]``, seg_a / seg_b ``[S, 3]`` -> ``[..., S]``: the
    closest points of two lines, the segment parameter clamped to [0, 1] and
    the ray parameter to t >= 0 (re-projected after the segment's clamp)."""
    u = normalize(r_d)[..., None, :]                     # the ray direction
    v = seg_b - seg_a                                    # [S, 3]
    w0 = r_o[..., None, :] - seg_a                       # [..., S, 3]

    a = torch.sum(u * u, dim=-1)
    b = torch.sum(u * v, dim=-1)
    c = torch.sum(v * v, dim=-1)
    d = torch.sum(u * w0, dim=-1)
    e = torch.sum(v * w0, dim=-1)

    denom = maximum(a * c - b * b, eps)
    t = clip((a * e - b * d) / denom, 0.0, 1.0)          # the segment parameter
    s = maximum((t * b - d) / maximum(a, eps), 0.0)      # the ray parameter
    p_ray = r_o[..., None, :] + s[..., None] * u
    p_seg = seg_a + t[..., None] * v
    return torch.linalg.norm(p_ray - p_seg, dim=-1)


def mesh_level_surfaces(r_o, r_d, verts, faces, chunk: int = 256) -> torch.Tensor:
    """Each ray's minimum distance to the edges of the mesh ``verts [V, 3]``,
    ``faces [F, 3]`` -> ``[...]``, over chunks of ``chunk`` edges (the JAX
    package pads the last chunk with far segments)."""
    tris = verts[faces.long()]                           # [F, 3, 3]
    seg_a = torch.cat([tris[:, 0], tris[:, 1], tris[:, 2]])
    seg_b = torch.cat([tris[:, 1], tris[:, 2], tris[:, 0]])
    out = torch.full(r_o.shape[:-1], torch.inf, dtype=r_o.dtype, device=r_o.device)
    for i in range(0, seg_a.shape[0], chunk):
        d = distance_between_rays_and_segments(r_o, r_d, seg_a[i:i + chunk],
                                               seg_b[i:i + chunk])
        out = torch.minimum(out, torch.amin(d, dim=-1))
    return out
