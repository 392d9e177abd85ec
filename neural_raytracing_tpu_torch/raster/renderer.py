"""Rasterization renderer front ends.

Counterpart of ``neural_raytracing_tpu/raster/renderer.py``, the
reference's renderer layer:
  * ``SpheresRasterizer`` / ``SphereFragments``: the fork's
    renderer/spheres/rasterizer.py (project the centres with the camera,
    keep the view-space z, rasterize with a radius a sphere);
  * ``PointsRasterizer`` / ``MeshRasterizer``: the upstream
    renderer/points and renderer/mesh rasterizers they build on.

The rasterizers take a ``FoVPerspectiveCamera`` (batch size 1) and
world-space geometry, project it inline, and hand it to ``.rasterize``.
``bin_size`` / ``max_faces_per_bin`` select the tiled mesh path; unset, the
naive chunked pass runs and ``chunk`` bounds its memory.
``max_points_per_bin`` is taken for the reference's signature and changes
nothing (the point rasterizer has no bins).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import torch

from .rasterize import Fragments, rasterize_meshes, rasterize_points, rasterize_spheres


class SphereFragments(NamedTuple):
    """renderer/spheres/rasterizer.py's fragments."""
    idx: torch.Tensor
    zbuf: torch.Tensor
    dists: torch.Tensor


class RasterizationSettings:
    """The reference's sphere, mesh and point raster settings in one."""

    def __init__(self, image_size: Union[int, tuple] = 256, blur_radius: float = 0.0,
                 faces_per_pixel: int = 8, points_per_pixel: int = 8,
                 bin_size: Optional[int] = None, max_points_per_bin: Optional[int] = None,
                 max_faces_per_bin: Optional[int] = None, chunk: int = 256):
        self.image_size = image_size
        self.blur_radius = blur_radius
        self.faces_per_pixel = faces_per_pixel
        self.points_per_pixel = points_per_pixel
        self.bin_size = bin_size                      # meshes: the tiled path
        self.max_points_per_bin = max_points_per_bin  # the reference's signature only
        self.max_faces_per_bin = max_faces_per_bin
        self.chunk = chunk


def transform_points_screen(camera, pts_world: torch.Tensor) -> torch.Tensor:
    """World ``[P, 3]`` -> (x_ndc, y_ndc, z_view): the row-vector view
    transform ``X_world R + T`` of view 0, then the FoV projection that
    inverts ``FoVPerspectiveCamera.sample_positions``, the z kept."""
    view = pts_world @ camera.R[0].to(pts_world) + camera.T[0].to(pts_world)   # [P, 3]
    tan_half = math.tan(0.5 * float(camera.fov) * math.pi / 180.0)
    z = view[..., 2]
    safe_z = torch.where(torch.abs(z) < 1e-8, 1e-8, z)
    x_ndc = view[..., 0] / (tan_half * camera.aspect * safe_z)
    y_ndc = view[..., 1] / (tan_half * safe_z)
    return torch.stack([x_ndc, y_ndc, z], dim=-1)


def _camera(given, own):
    cam = given if given is not None else own
    if cam is None:
        raise ValueError("Cameras must be specified either at initialization or in the "
                         "forward pass")
    return cam


class PointsRasterizer:
    """Project a world-space point cloud and rasterize it."""

    def __init__(self, cameras=None, raster_settings=None):
        self.cameras = cameras
        self.raster_settings = raster_settings or RasterizationSettings()

    def __call__(self, points_world: torch.Tensor, radius: Union[float, torch.Tensor] = 0.01,
                 cameras=None) -> Fragments:
        s = self.raster_settings
        pts = transform_points_screen(_camera(cameras, self.cameras), points_world)
        return rasterize_points(pts, s.image_size, radius, s.points_per_pixel, chunk=s.chunk)


class MeshRasterizer:
    """Project a world-space triangle mesh and rasterize it."""

    def __init__(self, cameras=None, raster_settings=None):
        self.cameras = cameras
        self.raster_settings = raster_settings or RasterizationSettings()

    def __call__(self, verts_world: torch.Tensor, faces: torch.Tensor,
                 cameras=None) -> Fragments:
        s = self.raster_settings
        verts = transform_points_screen(_camera(cameras, self.cameras), verts_world)
        return rasterize_meshes(verts, faces, s.image_size, s.blur_radius, s.faces_per_pixel,
                                chunk=s.chunk, bin_size=s.bin_size,
                                max_faces_per_bin=s.max_faces_per_bin)


class SpheresRasterizer:
    """The fork's sphere-cloud rasterizer: ``radii`` are screen radii in
    NDC units carried beside the projected centres (the fork's fourth
    column)."""

    def __init__(self, cameras=None, raster_settings=None):
        self.cameras = cameras
        self.raster_settings = raster_settings or RasterizationSettings()

    def transform(self, centers_world: torch.Tensor, cameras=None) -> torch.Tensor:
        return transform_points_screen(_camera(cameras, self.cameras), centers_world)

    def __call__(self, centers_world: torch.Tensor, radii: torch.Tensor,
                 cameras=None) -> SphereFragments:
        s = self.raster_settings
        pts = self.transform(centers_world, cameras)
        frags = rasterize_spheres(torch.cat([pts, radii[:, None]], dim=-1), s.image_size,
                                  s.points_per_pixel, chunk=s.chunk)
        return SphereFragments(idx=frags.idx, zbuf=frags.zbuf, dists=frags.dists)
