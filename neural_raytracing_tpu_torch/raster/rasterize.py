"""Differentiable rasterizers: the counterparts of the reference's csrc
rasterizers.

Counterpart of ``neural_raytracing_tpu/raster/rasterize.py``:
  * ``rasterize_points``: pytorch3d/csrc/rasterize_points/;
  * ``rasterize_meshes``: pytorch3d/csrc/rasterize_meshes/, naive, or
    coarse-to-fine with ``bin_size``;
  * ``rasterize_spheres``: the fork's csrc/rasterize_spheres/, a point
    rasterizer with a radius a sphere (zbuf the centre's z).

Conventions (the reference rasterizers'): screen x, y are NDC in [-1, 1]
with pixel (0, 0) at (+1, +1) (``ndc = 1 - 2 (i + 0.5) / S``), z is the
view-space depth kept as it is (smaller is closer, z < 0 culled), K
fragments a pixel sorted by ascending z, and an empty slot has idx, zbuf,
dists (and bary) -1.

The K-buffer is a running top-K merged over chunks of primitives: each
chunk's coverage of every pixel is one batched evaluation, its K nearest
are merged with the carry.  Both selections are stable sorts, so among
equal depths the lower index comes first, as ``lax.top_k`` orders them in
the JAX package: ``idx`` is the JAX package's, ties included.  Gradients
reach the primitives' coordinates through zbuf, dists and bary (idx is an
integer), as the csrc backward kernels propagate them.

``bin_size`` selects the coarse-to-fine path: a ``[tiles, F]`` test of each
face's blur-expanded box against each tile builds a face list of fixed
capacity a tile (the first ``max_faces_per_bin`` overlapping faces by
index, by default ``max(1024, F // 5)``; faces past it are dropped, like
the reference's bin overflow), then the fine top-K pass runs a tile over
its list only.  Its output is the naive rule's whenever no bin overflows.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple, Union

import torch

from ..ops.math import clip, maximum

_EPS = 1e-8


class Fragments(NamedTuple):
    """The K-buffer a pixel: idx ``[H, W, K]``, zbuf, dists; bary ``[H, W,
    K, 3]`` for meshes (None otherwise).  An empty slot is -1 in every
    field: test ``idx >= 0`` before using a value."""
    idx: torch.Tensor
    zbuf: torch.Tensor
    dists: torch.Tensor
    bary: Optional[torch.Tensor] = None


def _image_size(image_size) -> Tuple[int, int]:
    if isinstance(image_size, int):
        return image_size, image_size
    h, w = image_size
    return int(h), int(w)


def pix_to_ndc(i: torch.Tensor, s: int) -> torch.Tensor:
    """Pixel index -> the NDC of its centre, ``1 - 2 (i + 0.5) / s``."""
    return 1.0 - 2.0 * (i + 0.5) / s


def _pixel_grid(h: int, w: int, device):
    ys = pix_to_ndc(torch.arange(h, dtype=torch.float32, device=device), h)
    xs = pix_to_ndc(torch.arange(w, dtype=torch.float32, device=device), w)
    return torch.meshgrid(ys, xs, indexing="ij")          # [H, W] each


def _ascending(z: torch.Tensor, k: int):
    """The ``k`` least values of ``z`` along its last axis, ascending, and
    their indices; among equal values the lower index first."""
    zs, sel = torch.sort(z, dim=-1, stable=True)
    return zs[..., :k], sel[..., :k]


def _topk_scan(n: int, chunk: int, chunk_fn, k: int, pix_shape, n_payload: int, device,
               ok: Optional[torch.Tensor] = None):
    """The running top-K a pixel (ascending z) over ``n`` primitives in
    chunks of ``chunk``.

    ``chunk_fn(lo, hi) -> (z, valid, payload)`` for primitives ``lo:hi``,
    with z ``pix_shape + [C]`` (any value where invalid) and payload
    ``pix_shape + [C, n_payload]``; ``ok [T, n]`` masks primitives out of
    tile ``T`` (the binned path, whose pixel shape is ``[T, b, b]``).  ->
    (z ``pix_shape + [K]``, idx int64 (-1 where empty), payload
    ``pix_shape + [K, n_payload]``).
    """
    cz = torch.full(pix_shape + (k,), torch.inf, dtype=torch.float32, device=device)
    cidx = torch.full(pix_shape + (k,), -1, dtype=torch.int64, device=device)
    cpay = torch.zeros(pix_shape + (k, n_payload), dtype=torch.float32, device=device)
    for base in range(0, n, chunk):
        z, valid, pay = chunk_fn(base, base + chunk)
        if ok is not None:
            valid = valid & ok[:, None, None, base:base + chunk]
        z = torch.where(valid, z, torch.inf)
        gz, sel = _ascending(z, min(k, z.shape[-1]))        # the chunk's nearest
        gidx = torch.where(torch.isfinite(gz), base + sel, -1)
        gpay = torch.gather(pay, -2, sel[..., None].expand(sel.shape + (n_payload,)))
        cz, sel2 = _ascending(torch.cat([cz, gz], dim=-1), k)   # merged with the carry
        cidx = torch.gather(torch.cat([cidx, gidx], dim=-1), -1, sel2)
        cpay = torch.gather(torch.cat([cpay, gpay], dim=-2), -2,
                            sel2[..., None].expand(sel2.shape + (n_payload,)))
    return cz, cidx, cpay


def rasterize_points(points: torch.Tensor, image_size=256,
                     radius: Union[float, torch.Tensor] = 0.01,
                     points_per_pixel: int = 8, chunk: int = 256) -> Fragments:
    """Point-cloud rasterization: points ``[P, 3]`` = (x_ndc, y_ndc,
    z_view), radius a number or ``[P]`` in NDC units -> Fragments whose
    dists are the squared NDC distance from the pixel centre to the point."""
    h, w = _image_size(image_size)
    p = points.shape[0]
    radius = torch.as_tensor(radius, dtype=torch.float32, device=points.device).expand(p)
    py, px = _pixel_grid(h, w, points.device)

    def chunk_fn(lo, hi):
        x, y, z, r = points[lo:hi, 0], points[lo:hi, 1], points[lo:hi, 2], radius[lo:hi]
        dx = px[..., None] - x
        dy = py[..., None] - y
        d2 = dx * dx + dy * dy
        valid = (d2 < r * r) & (z >= 0) & (r > 0)
        return z.expand(d2.shape), valid, d2[..., None]

    z, idx, pay = _topk_scan(p, chunk, chunk_fn, points_per_pixel, (h, w), 1, points.device)
    filled = idx >= 0
    return Fragments(idx=idx, zbuf=torch.where(filled, z, -1.0),
                     dists=torch.where(filled, pay[..., 0], -1.0))


def rasterize_spheres(spheres: torch.Tensor, image_size=256, points_per_pixel: int = 8,
                      chunk: int = 256) -> Fragments:
    """The fork's sphere rasterizer: spheres ``[S, 4]`` = (x_ndc, y_ndc,
    z_view, radius_ndc), ``rasterize_points`` with a radius column."""
    return rasterize_points(spheres[:, :3], image_size, radius=spheres[:, 3],
                            points_per_pixel=points_per_pixel, chunk=chunk)


def _tri_coverage(tri, px, py, blur_radius, cull_backfaces):
    """The coverage rule of the naive and binned paths: triangles ``tri
    [..., C, 3, 3]`` over the pixel centres ``px`` / ``py`` (leading pixel
    axes that broadcast against ``tri``'s).  -> (z, covered, payload [dist,
    b0, b1, b2]) with the pixel axes + ``[C]``."""
    eps = _EPS

    def edge_fn(p, a, b):
        # twice the signed area of (a, b, p); positive left of a -> b
        return ((b[..., 0] - a[..., 0]) * (p[..., 1] - a[..., 1])
                - (b[..., 1] - a[..., 1]) * (p[..., 0] - a[..., 0]))

    def seg_d2(p, a, b):
        v = b - a
        t = clip(torch.sum((p - a) * v, dim=-1) / maximum(torch.sum(v * v, dim=-1), eps),
                 0.0, 1.0)
        d = p - (a + t[..., None] * v)
        return torch.sum(d * d, dim=-1)

    a2, b2, c2 = tri[..., 0, :2], tri[..., 1, :2], tri[..., 2, :2]
    az, bz, cz = tri[..., 0, 2], tri[..., 1, 2], tri[..., 2, 2]
    pxy = torch.stack([px, py], dim=-1)[..., None, :]     # pixel axes + [1, 2]
    area = edge_fn(a2, b2, c2)                            # [..., C]
    w0 = edge_fn(pxy, b2, c2)
    w1 = edge_fn(pxy, c2, a2)
    w2 = edge_fn(pxy, a2, b2)
    small = torch.abs(area) < eps
    inv = torch.where(small, 0.0, 1.0 / torch.where(small, 1.0, area))
    b0, b1, b2_ = w0 * inv, w1 * inv, w2 * inv
    inside = (b0 >= 0) & (b1 >= 0) & (b2_ >= 0)
    d_edge = torch.minimum(torch.minimum(seg_d2(pxy, a2, b2), seg_d2(pxy, b2, c2)),
                           seg_d2(pxy, c2, a2))
    dist = torch.where(inside, -d_edge, d_edge)
    ok = ~small
    if cull_backfaces:
        ok = ok & (area > 0)
    ok = ok & (az >= 0) & (bz >= 0) & (cz >= 0)
    covered = inside | (d_edge < blur_radius)
    # barycentrics clipped to the face for the z interpolation
    cb0, cb1, cb2 = (maximum(b, 0.0) for b in (b0, b1, b2_))
    s = maximum(cb0 + cb1 + cb2, eps)
    z = cb0 / s * az + cb1 / s * bz + cb2 / s * cz
    pay = torch.stack([dist, b0, b1, b2_], dim=-1)
    return z, covered & ok, pay


def _mesh_fragments(z, idx, pay) -> Fragments:
    filled = idx >= 0
    return Fragments(idx=idx, zbuf=torch.where(filled, z, -1.0),
                     dists=torch.where(filled, pay[..., 0], -1.0),
                     bary=torch.where(filled[..., None], pay[..., 1:4], -1.0))


def rasterize_meshes(verts: torch.Tensor, faces: torch.Tensor, image_size=256,
                     blur_radius: float = 0.0, faces_per_pixel: int = 8,
                     chunk: int = 256, cull_backfaces: bool = False,
                     bin_size: Optional[int] = None,
                     max_faces_per_bin: Optional[int] = None) -> Fragments:
    """Triangle rasterization: verts ``[V, 3]`` in (x_ndc, y_ndc, z_view),
    faces ``[F, 3]`` -> Fragments with the NDC barycentrics and dists the
    squared NDC distance to the nearest edge, negated inside the face.  A
    pixel keeps a face it is inside, or within ``blur_radius`` (squared) of
    an edge of; faces with |area| < eps or a vertex with z < 0 are skipped.
    ``bin_size`` (not None or 0) takes the coarse-to-fine path."""
    h, w = _image_size(image_size)
    if bin_size:
        return _rasterize_meshes_binned(verts, faces, h, w, blur_radius, faces_per_pixel,
                                        chunk, cull_backfaces, bin_size, max_faces_per_bin)
    tris = verts[faces.long()]                            # [F, 3, 3]
    py, px = _pixel_grid(h, w, verts.device)
    z, idx, pay = _topk_scan(
        tris.shape[0], chunk,
        lambda lo, hi: _tri_coverage(tris[lo:hi], px, py, blur_radius, cull_backfaces),
        faces_per_pixel, (h, w), 4, verts.device)
    return _mesh_fragments(z, idx, pay)


def _rasterize_meshes_binned(verts, faces, h, w, blur_radius, faces_per_pixel, chunk,
                             cull_backfaces, bin_size, max_faces_per_bin) -> Fragments:
    """Coarse-to-fine tiled rasterization: per-tile face lists of fixed
    capacity from one stable sort, then the fine pass over every tile's list
    at once."""
    device = verts.device
    f = faces.shape[0]
    b = int(bin_size)
    th, tw = -(-h // b), -(-w // b)                       # the tile grid
    q = min(max_faces_per_bin or max(1024, f // 5), f)
    tris_all = verts[faces.long()]                        # [F, 3, 3]

    # coarse pass: each face's blur-expanded box against each tile's
    # rectangle of pixel centres
    expand = math.sqrt(max(blur_radius, 0.0))
    xy = tris_all[..., :2].detach()
    fx_min, fx_max = xy[..., 0].amin(1) - expand, xy[..., 0].amax(1) + expand
    fy_min, fy_max = xy[..., 1].amin(1) - expand, xy[..., 1].amax(1) + expand
    rows = torch.arange(th, device=device) * b
    cols = torch.arange(tw, device=device) * b
    ty_max, ty_min = pix_to_ndc(rows.float(), h), pix_to_ndc((rows + b - 1).float(), h)
    tx_max, tx_min = pix_to_ndc(cols.float(), w), pix_to_ndc((cols + b - 1).float(), w)
    ov_y = (fy_min[None, :] <= ty_max[:, None]) & (fy_max[None, :] >= ty_min[:, None])
    ov_x = (fx_min[None, :] <= tx_max[:, None]) & (fx_max[None, :] >= tx_min[:, None])
    overlap = (ov_y[:, None, :] & ov_x[None, :, :]).reshape(th * tw, f)

    # each tile's list: its first q overlapping faces, by ascending id
    key = torch.where(overlap, torch.arange(f, 0, -1, device=device), 0)
    topv, topi = torch.sort(key, dim=-1, descending=True, stable=True)
    topv, topi = topv[:, :q], topi[:, :q]
    tile_ids = torch.where(topv > 0, topi, -1)            # [T, q]
    tile_tris = tris_all[torch.clamp_min(tile_ids, 0)]    # [T, q, 3, 3]

    # fine pass: the naive rule a tile over its q faces; the NDC keeps the
    # true h / w scale, and the padded rows and columns past the image are
    # cut after stitching
    ys = pix_to_ndc(torch.arange(th * b, dtype=torch.float32, device=device), h)
    xs = pix_to_ndc(torch.arange(tw * b, dtype=torch.float32, device=device), w)
    py_full, px_full = torch.meshgrid(ys, xs, indexing="ij")
    tiles = lambda g: g.reshape(th, b, tw, b).permute(0, 2, 1, 3).reshape(th * tw, b, b)
    tile_px, tile_py = tiles(px_full), tiles(py_full)
    z, lidx, pay = _topk_scan(
        q, min(chunk, q),
        lambda lo, hi: _tri_coverage(tile_tris[:, None, None, lo:hi], tile_px, tile_py,
                                     blur_radius, cull_backfaces),
        faces_per_pixel, (th * tw, b, b), 4, device, ok=tile_ids >= 0)
    # list-local indices back to face ids
    idx = torch.where(lidx >= 0, torch.gather(
        tile_ids, 1, torch.clamp(lidx, 0, q - 1).reshape(th * tw, -1)).reshape(lidx.shape), -1)

    def stitch(a):
        a = a.reshape((th, tw, b, b) + a.shape[3:])
        a = a.movedim(2, 1).reshape((th * b, tw * b) + a.shape[4:])
        return a[:h, :w]

    return _mesh_fragments(stitch(z), stitch(idx), stitch(pay))
