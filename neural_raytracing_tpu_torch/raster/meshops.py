"""Mesh utility ops: the counterparts of the reference's small csrc kernels.

Counterpart of ``neural_raytracing_tpu/raster/meshops.py`` (each op mirrors
the pytorch3d csrc extension it replaces):
  * ``face_areas_normals``: csrc/face_areas_normals/;
  * ``interp_face_attrs``: csrc/interp_face_attrs/;
  * ``packed_to_padded`` / ``padded_to_packed``: csrc/packed_to_padded_tensor/;
  * ``gather_scatter``: csrc/gather_scatter/;
  * ``point_face_distance`` / ``face_point_distance`` /
    ``point_edge_distance`` / ``edge_point_distance``: csrc/point_mesh/.

Every op is batched tensor math or a gather, differentiable by autograd.
A ragged batch of meshes is given by segment ids over statically shaped
arrays, as in the JAX package, where the csrc takes first-index arrays.
Minima over an axis take ``amin`` (ties share the gradient, as
``jnp.min``'s) and the first index at a tie, as ``jnp.argmin``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.math import clip, cross, maximum


def face_areas_normals(verts: torch.Tensor, faces: torch.Tensor,
                       eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """verts ``[V, 3]``, faces ``[F, 3]`` -> (areas ``[F]``, unit normals
    ``[F, 3]``); a degenerate face gets area 0 and normal 0 (the csrc
    forward: normal = cross / max(2 area, eps))."""
    tris = verts[faces.long()]                             # [F, 3, 3]
    n = cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    # the double where: the norm's gradient at cross = 0 (a degenerate face)
    # is not finite, and the eps clamp below does not block it
    sq = torch.sum(n * n, dim=-1)
    pos = sq > 0.0
    norm = torch.where(pos, torch.sqrt(torch.where(pos, sq, 1.0)), 0.0)
    areas = 0.5 * norm
    normals = n / maximum(norm, eps)[..., None]
    return areas, normals


def interp_face_attrs(pix_to_face: torch.Tensor, barycentric: torch.Tensor,
                      face_attrs: torch.Tensor) -> torch.Tensor:
    """pix_to_face ``[...]`` (-1: no face), barycentric ``[..., 3]``,
    face_attrs ``[F, 3, D]`` -> ``[..., D]``; zeros where there is no face."""
    attrs = face_attrs[torch.clamp_min(pix_to_face, 0).long()]   # [..., 3, D]
    out = torch.sum(barycentric[..., :, None] * attrs, dim=-2)
    return torch.where((pix_to_face >= 0)[..., None], out, 0.0)


def packed_to_padded(inputs: torch.Tensor, first_idxs: torch.Tensor,
                     max_size: int) -> torch.Tensor:
    """Ragged packed ``[P, ...]`` -> padded ``[N, max_size, ...]``, zeros past
    each element's end; ``first_idxs [N]`` the packed start of each."""
    n, p = first_idxs.shape[0], inputs.shape[0]
    first_idxs = first_idxs.long()
    ends = torch.cat([first_idxs[1:], torch.tensor([p], device=first_idxs.device)])
    idx = first_idxs[:, None] + torch.arange(max_size, device=first_idxs.device)[None, :]
    valid = idx < ends[:, None]
    flat = inputs[torch.clamp_max(idx, p - 1).reshape(-1)]
    flat = flat.reshape((n, max_size) + inputs.shape[1:])
    return torch.where(valid.reshape(valid.shape + (1,) * (flat.dim() - 2)), flat,
                       torch.zeros((), dtype=flat.dtype, device=flat.device))


def padded_to_packed(inputs: torch.Tensor, first_idxs: torch.Tensor,
                     num_inputs: int) -> torch.Tensor:
    """Padded ``[N, M, ...]`` -> packed ``[num_inputs, ...]`` (the inverse of
    ``packed_to_padded``)."""
    m = inputs.shape[1]
    first_idxs = first_idxs.long()
    pos = torch.arange(num_inputs, device=first_idxs.device)
    # each packed element's batch: the starts at or before it, minus 1
    batch = torch.sum(pos[:, None] >= first_idxs[None, :], dim=-1) - 1
    within = pos - first_idxs[batch]
    return inputs[batch, torch.clamp_max(within, m - 1)]


def gather_scatter(inputs: torch.Tensor, edges: torch.Tensor,
                   directed: bool = False) -> torch.Tensor:
    """Graph-conv neighbour sums: inputs ``[V, D]``, edges ``[E, 2]`` ->
    ``[V, D]`` with ``out[v0] += in[v1]`` for each edge, and, undirected,
    ``out[v1] += in[v0]``."""
    e0, e1 = edges[:, 0].long(), edges[:, 1].long()
    out = torch.zeros_like(inputs).index_add(0, e0, inputs[e1])
    if not directed:
        out = out.index_add(0, e1, inputs[e0])
    return out


def point_line_seg_dists(points: torch.Tensor, seg_a: torch.Tensor,
                         seg_b: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """The squared distance from each point ``[P, 3]`` to each segment
    ``[S, 3]`` -> ``[P, S]``."""
    v = seg_b - seg_a                                      # [S, 3]
    w = points[:, None, :] - seg_a[None, :, :]             # [P, S, 3]
    t = torch.sum(w * v, dim=-1) / maximum(torch.sum(v * v, dim=-1), eps)
    t = clip(t, 0.0, 1.0)
    d = points[:, None, :] - (seg_a + t[..., None] * v)
    return torch.sum(d * d, dim=-1)


def point_triangle_dists(points: torch.Tensor, tris: torch.Tensor,
                         eps: float = 1e-8) -> torch.Tensor:
    """The squared distance from each point ``[P, 3]`` to each triangle
    ``[T, 3, 3]`` -> ``[P, T]``: the plane's distance where the projection
    falls inside the face, else the nearest edge's."""
    a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]           # [T, 3]
    n = cross(b - a, c - a)                                # [T, 3]
    nn = torch.sum(n * n, dim=-1)                          # [T]
    w = points[:, None, :] - a[None, :, :]                 # [P, T, 3]
    dist_plane = torch.sum(w * n, dim=-1)                  # signed x |n|
    proj = points[:, None, :] - (dist_plane / maximum(nn, eps))[..., None] * n

    w_a = torch.sum(cross(c - b, proj - b[None]) * n, dim=-1)
    w_b = torch.sum(cross(a - c, proj - c[None]) * n, dim=-1)
    w_c = torch.sum(cross(b - a, proj - a[None]) * n, dim=-1)
    inside = (w_a >= 0) & (w_b >= 0) & (w_c >= 0) & (nn > eps)[None, :]

    d_in = dist_plane * dist_plane / maximum(nn, eps)
    d_edge = torch.minimum(torch.minimum(point_line_seg_dists(points, a, b, eps),
                                         point_line_seg_dists(points, b, c, eps)),
                           point_line_seg_dists(points, c, a, eps))
    return torch.where(inside, d_in, d_edge)


def _min(d: torch.Tensor, dim: int):
    return torch.amin(d, dim=dim), torch.argmin(d, dim=dim)


def _segment_min(dists, row_seg, col_seg, dim: int):
    """Min and argmin of ``dists [R, C]`` over ``dim`` among the pairs of
    the same segment (a mesh of a ragged batch); other pairs read inf."""
    mask = row_seg[:, None] == col_seg[None, :]
    return _min(torch.where(mask, dists, torch.inf), dim)


def point_face_distance(points: torch.Tensor, tris: torch.Tensor,
                        points_seg: Optional[torch.Tensor] = None,
                        tris_seg: Optional[torch.Tensor] = None):
    """Each point's least squared distance to its mesh's faces -> (dists
    ``[P]``, face ``[P]``); ``*_seg`` segment ids (None: one mesh)."""
    d = point_triangle_dists(points, tris)
    if points_seg is None:
        return _min(d, -1)
    return _segment_min(d, points_seg, tris_seg, -1)


def face_point_distance(points: torch.Tensor, tris: torch.Tensor,
                        points_seg: Optional[torch.Tensor] = None,
                        tris_seg: Optional[torch.Tensor] = None):
    """Each face's least squared distance to its mesh's points -> (dists
    ``[T]``, point ``[T]``)."""
    d = point_triangle_dists(points, tris)
    if points_seg is None:
        return _min(d, 0)
    return _segment_min(d, points_seg, tris_seg, 0)


def point_edge_distance(points: torch.Tensor, seg_a: torch.Tensor, seg_b: torch.Tensor,
                        points_seg: Optional[torch.Tensor] = None,
                        edges_seg: Optional[torch.Tensor] = None):
    """Each point's least squared distance to its mesh's edges."""
    d = point_line_seg_dists(points, seg_a, seg_b)
    if points_seg is None:
        return _min(d, -1)
    return _segment_min(d, points_seg, edges_seg, -1)


def edge_point_distance(points: torch.Tensor, seg_a: torch.Tensor, seg_b: torch.Tensor,
                        points_seg: Optional[torch.Tensor] = None,
                        edges_seg: Optional[torch.Tensor] = None):
    """Each edge's least squared distance to its mesh's points."""
    d = point_line_seg_dists(points, seg_a, seg_b)
    if points_seg is None:
        return _min(d, 0)
    return _segment_min(d, points_seg, edges_seg, 0)
