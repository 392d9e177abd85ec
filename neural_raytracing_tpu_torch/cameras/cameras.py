"""Cameras: pixel-grid positions -> world-space ray bundles.

Counterpart of ``neural_raytracing_tpu/cameras/cameras.py`` for the render
path:
  * ``NeRFCamera`` from ``[N, 3, 4]`` camera-to-world matrices, and the
    ``nerf_c2w`` pose helper;
  * ``FoVPerspectiveCamera`` with PyTorch3D conventions (row-vector
    transforms ``X_view = X R + T``, the camera looks down +z) and
    ``look_at_view_transform``.  It keeps the reference's quirk of
    normalising the world POINT on the far plane as the ray direction, not
    the point minus the camera centre;
  * ``DTUCamera`` (IDR-style: a camera-to-world pose and an intrinsic
    matrix, pixel positions scaled by ``src_size / size``) and ``lift``;
  * ``NeRFMMCamera`` (NeRF--: axis-angle poses and per-view focals) and
    ``NeRVCamera`` (a world-to-camera rotation and the camera location).

``positions[..., 0]`` is the second image axis and ``positions[..., 1]`` the
first.  Rays are ``[N, *grid, bundle, 6]`` (origin ++ direction).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..ops import sampling
from ..ops.math import normalize, rotate_vector


def _as_f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def camera_position_from_spherical_angles(dist, elev, azim, degrees=True,
                                          device=None) -> torch.Tensor:
    dist, elev, azim = torch.broadcast_tensors(
        torch.atleast_1d(_as_f32(dist, device)),
        torch.atleast_1d(_as_f32(elev, device)),
        torch.atleast_1d(_as_f32(azim, device)))
    if degrees:
        elev = elev * (math.pi / 180.0)
        azim = azim * (math.pi / 180.0)
    x = dist * torch.cos(elev) * torch.sin(azim)
    y = dist * torch.sin(elev)
    z = dist * torch.cos(elev) * torch.cos(azim)
    return torch.stack([x, y, z], dim=-1)


def look_at_rotation(camera_position: torch.Tensor, at, up) -> torch.Tensor:
    """World->view rotation matrices ``[N, 3, 3]`` (row-vector convention)."""
    camera_position = torch.atleast_2d(camera_position)
    at = torch.atleast_2d(_as_f32(at, camera_position.device)).expand(
        camera_position.shape)
    up = torch.atleast_2d(_as_f32(up, camera_position.device)).expand(
        camera_position.shape)
    z_axis = normalize(at - camera_position, eps=1e-5)
    x_axis = normalize(torch.linalg.cross(up, z_axis, dim=-1), eps=1e-5)
    y_axis = normalize(torch.linalg.cross(z_axis, x_axis, dim=-1), eps=1e-5)
    is_close = torch.all(torch.isclose(x_axis, torch.zeros_like(x_axis),
                                       atol=5e-3), dim=1, keepdim=True)
    replacement = normalize(torch.linalg.cross(y_axis, z_axis, dim=-1), eps=1e-5)
    x_axis = torch.where(is_close, replacement, x_axis)
    r = torch.stack([x_axis, y_axis, z_axis], dim=1)
    return r.transpose(1, 2)


def look_at_view_transform(dist=1.0, elev=0.0, azim=0.0, degrees=True,
                           at=((0.0, 0.0, 0.0),), up=((0.0, 1.0, 0.0),),
                           device=None):
    """(R [N,3,3], T [N,3]) such that ``X_view = X_world R + T``."""
    at_arr = torch.atleast_2d(_as_f32(at, device))
    c = camera_position_from_spherical_angles(dist, elev, azim, degrees, device)
    c, at = torch.broadcast_tensors(c, at_arr)
    c = c + at
    r = look_at_rotation(c, at, up)
    t = -torch.einsum("nij,ni->nj", r, c)
    return r, t


def nerf_c2w(elev_deg, azim_deg, dist=2.0) -> np.ndarray:
    """NeRF-convention 4x4 camera-to-world (camera -z looks at the origin)."""
    e, a = math.radians(elev_deg), math.radians(azim_deg)
    pos = np.asarray([
        dist * math.cos(e) * math.sin(a),
        dist * math.sin(e),
        dist * math.cos(e) * math.cos(a),
    ])
    forward = pos / np.linalg.norm(pos)              # camera -z
    right = np.cross([0.0, 1.0, 0.0], forward)
    right = right / max(np.linalg.norm(right), 1e-9)
    up = np.cross(forward, right)
    m = np.eye(4, dtype=np.float32)
    m[:3, 0] = right
    m[:3, 1] = up
    m[:3, 2] = forward
    m[:3, 3] = pos
    return m


def spherical_positions(min_elev=0.0, max_elev=45.0, min_azim=-135.0, max_azim=135.0,
                        n_elev: int = 8, n_azim: int = 8, dist: float = 1.0, device=None):
    """(R, T) of a grid of look-at views about the origin: ``n_elev``
    elevations by ``n_azim`` azimuths, elevation-major."""
    elevs = torch.linspace(min_elev, max_elev, n_elev, dtype=torch.float32)
    azims = torch.linspace(min_azim, max_azim, n_azim, dtype=torch.float32)
    ee, aa = torch.meshgrid(elevs, azims, indexing="ij")
    return look_at_view_transform(dist=dist, elev=ee.reshape(-1), azim=aa.reshape(-1),
                                  device=device)


def _expand_bundle(positions: torch.Tensor, generator: Optional[torch.Generator],
                   bundle_size: int, with_noise) -> torch.Tensor:
    """[..., 2] -> [..., bundle, 2], jittered by U(-d/2, d/2) if ``with_noise``."""
    pos = positions[..., None, :].expand(
        positions.shape[:-1] + (bundle_size, 2))
    if with_noise and generator is not None:
        d = float(with_noise)
        u = sampling.uniform(generator, pos.shape, pos.device)
        pos = pos + d * u - d / 2.0
    return pos


class FoVPerspectiveCamera(NamedTuple):
    """Batched FoV perspective camera (PyTorch3D conventions)."""

    R: torch.Tensor                  # [N, 3, 3] world->view rotation
    T: torch.Tensor                  # [N, 3] world->view translation
    fov: float = 60.0                # full field of view, degrees
    znear: float = 1.0
    zfar: float = 100.0
    aspect: float = 1.0

    def __len__(self):
        return self.R.shape[0]

    def to(self, device) -> "FoVPerspectiveCamera":
        return FoVPerspectiveCamera(self.R.to(device), self.T.to(device),
                                    self.fov, self.znear, self.zfar, self.aspect)

    def camera_center(self) -> torch.Tensor:
        return -torch.einsum("ni,nji->nj", self.T, self.R.transpose(1, 2))

    def sample_positions(self, positions: torch.Tensor, generator=None,
                         bundle_size: int = 1, size: int = 512,
                         with_noise=False) -> torch.Tensor:
        pos = _expand_bundle(positions, generator, bundle_size, with_noise)
        # [0, size] -> [-1, 1] NDC (flipped: pixel 0 -> +1)
        ndc = -2.0 * (pos / size) + 1.0
        tan_half = math.tan(0.5 * float(self.fov) * math.pi / 180.0)
        # NDC point at the far plane in view space (x left, y up, z forward)
        x = ndc[..., 0:1] * tan_half * self.aspect * self.zfar
        y = ndc[..., 1:2] * tan_half * self.zfar
        z = torch.full_like(x, self.zfar)
        view_pts = torch.cat([x, y, z], dim=-1)               # [..., B, 3]
        rt = self.R.transpose(1, 2)
        # world point: X_world = (X_view - T) R^T  (row-vector convention)
        world_pts = torch.einsum("...j,nkj->n...k", view_pts, rt)
        shift = torch.einsum("ni,nki->nk", self.T, rt)
        world_pts = world_pts - shift[(slice(None),) + (None,) * (world_pts.ndim - 2)]
        # reference quirk: normalise the world POINT, not point - centre
        directions = normalize(world_pts)
        origins = self.camera_center()[
            (slice(None),) + (None,) * (directions.ndim - 2)].expand(directions.shape)
        return torch.cat([origins, directions], dim=-1)


class NeRFCamera(NamedTuple):
    """NeRF-convention pinhole camera from ``[N, 3, 4]`` camera-to-world."""

    cam_to_world: torch.Tensor       # [N, 3, 4] (or [N, 4, 4])
    focal: Union[float, torch.Tensor]

    def __len__(self):
        return self.cam_to_world.shape[0]

    def to(self, device) -> "NeRFCamera":
        focal = self.focal.to(device) if isinstance(self.focal, torch.Tensor) else self.focal
        return NeRFCamera(self.cam_to_world.to(device), focal)

    def sample_positions(self, positions: torch.Tensor, generator=None,
                         bundle_size: int = 1, size: int = 512,
                         with_noise=False) -> torch.Tensor:
        pos = _expand_bundle(positions, generator, bundle_size, with_noise)
        u, v = pos[..., 0:1], pos[..., 1:2]
        d = torch.cat([
            (u - size * 0.5) / self.focal,
            -(v - size * 0.5) / self.focal,
            -torch.ones_like(u),
        ], dim=-1)                                            # [..., B, 3]
        r_d = torch.einsum("...j,nij->n...i", d, self.cam_to_world[..., :3, :3])
        r_d = normalize(r_d)
        r_o = self.cam_to_world[..., :3, -1][
            (slice(None),) + (None,) * (r_d.ndim - 2)].expand(r_d.shape)
        return torch.cat([r_o, r_d], dim=-1)


def _per_view(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-view ``x [N, ...]`` -> ``[N, 1, ..., 1, ...]`` with ``ndim``
    ones after the view axis."""
    return x[(slice(None),) + (None,) * ndim]


class NeRFMMCamera(NamedTuple):
    """NeRF-- camera: a position ``t [N, 3]``, an axis-angle rotation
    (``angle [N, 1]`` about the unit ``axis [N, 3]``) and per-view focal
    lengths ``focals [N, 2]`` (x, y)."""

    t: torch.Tensor
    angle: torch.Tensor
    axis: torch.Tensor
    focals: torch.Tensor

    def __len__(self):
        return self.t.shape[0]

    def to(self, device) -> "NeRFMMCamera":
        return NeRFMMCamera(*(x.to(device) for x in self))

    def sample_positions(self, positions: torch.Tensor, generator=None,
                         bundle_size: int = 1, size: int = 512,
                         with_noise=False) -> torch.Tensor:
        pos = _expand_bundle(positions, generator, bundle_size, with_noise)
        u, v = pos[..., 0], pos[..., 1]                       # [..., B]
        ones = pos.ndim - 1
        dx = (u - size * 0.5) / _per_view(self.focals[:, 0], ones)   # [N, ..., B]
        dy = -(v - size * 0.5) / _per_view(self.focals[:, 1], ones)
        d = torch.stack([dx, dy, -torch.ones_like(dx)], dim=-1)
        angle = _per_view(self.angle, ones)
        r_d = normalize(rotate_vector(d, _per_view(self.axis, ones), torch.cos(angle),
                                      torch.sin(angle)))
        r_o = _per_view(self.t, ones).expand(r_d.shape)
        return torch.cat([r_o, r_d], dim=-1)


class NeRVCamera(NamedTuple):
    """NeRV camera: a world-to-camera rotation ``world_to_cam [N, 3|4, 3|4]``
    (directions are multiplied by its transpose), the camera location
    ``loc [N, 3]`` as the ray origin, and a focal length."""

    world_to_cam: torch.Tensor
    loc: torch.Tensor
    focal: Union[float, torch.Tensor]

    def __len__(self):
        return self.world_to_cam.shape[0]

    def to(self, device) -> "NeRVCamera":
        focal = self.focal.to(device) if isinstance(self.focal, torch.Tensor) else self.focal
        return NeRVCamera(self.world_to_cam.to(device), self.loc.to(device), focal)

    def sample_positions(self, positions: torch.Tensor, generator=None,
                         bundle_size: int = 1, size: int = 512,
                         with_noise=False) -> torch.Tensor:
        pos = _expand_bundle(positions, generator, bundle_size, with_noise)
        u, v = pos[..., 0:1], pos[..., 1:2]
        d = torch.cat([
            (u - size * 0.5) / self.focal,
            (v - size * 0.5) / self.focal,
            torch.ones_like(u),
        ], dim=-1)
        # "...j,nji->n...i": the transposed rotation, as the JAX camera
        r_d = normalize(torch.einsum("...j,nji->n...i", d, self.world_to_cam[..., :3, :3]))
        r_o = self.loc[(slice(None),) + (None,) * (r_d.ndim - 2)].expand(r_d.shape)
        return torch.cat([r_o, r_d], dim=-1)


def lift(x, y, z, intrinsics: torch.Tensor) -> torch.Tensor:
    """Unproject pixel coordinates through a ``[N, 3|4, 3|4]`` intrinsic
    matrix (skew included) -> homogeneous camera-space points ``[..., 4]``."""
    fx = intrinsics[..., 0, 0, None]
    fy = intrinsics[..., 1, 1, None]
    cx = intrinsics[..., 0, 2, None]
    cy = intrinsics[..., 1, 2, None]
    sk = intrinsics[..., 0, 1, None]
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack([x_lift, y_lift, z, torch.ones_like(z)], dim=-1)


class DTUCamera(NamedTuple):
    """IDR-style DTU camera: camera-to-world ``pose`` ``[N, 4, 4]`` (or
    ``[N, 3, 4]``, padded to 4x4) and ``intrinsic`` ``[N, 4, 4]`` or
    ``[N, 3, 3]``.

    Pixel positions are scaled by ``src_size / size``: ``src_size`` is the
    source images' ``(width, height)`` (numbers, kept on the host) the
    intrinsics are in, 1600 x 1200 (the DTU scans') when None.  As in the
    JAX package, no jitter is added: ``generator`` and ``with_noise`` are
    ignored.
    """

    pose: torch.Tensor
    intrinsic: torch.Tensor
    src_size: Optional[tuple] = None

    def __len__(self):
        return self.pose.shape[0]

    def to(self, device) -> "DTUCamera":
        return DTUCamera(self.pose.to(device), self.intrinsic.to(device), self.src_size)

    def sample_positions(self, positions: torch.Tensor, generator=None,
                         bundle_size: int = 1, size: int = 512,
                         with_noise=False) -> torch.Tensor:
        n = len(self)
        grid = positions.shape[:-1]
        src = (1600.0, 1200.0) if self.src_size is None else self.src_size
        # two float32 quotients, as the JAX camera's src / size
        scale = np.asarray(src, np.float32) / np.float32(size)
        uv = torch.stack([positions[..., 0] * float(scale[0]),
                          positions[..., 1] * float(scale[1])], dim=-1).reshape(-1, 2)
        u = uv[:, 0].expand(n, uv.shape[0])
        v = uv[:, 1].expand(n, uv.shape[0])
        points = lift(u, v, torch.ones_like(u), self.intrinsic)   # [N, P, 4]
        pose = self.pose
        if pose.shape[-2] == 3:
            pad = torch.zeros(pose.shape[:-2] + (1, 4), dtype=pose.dtype,
                              device=pose.device)
            pad[..., 0, 3] = 1.0
            pose = torch.cat([pose, pad], dim=-2)
        world = torch.einsum("nij,npj->npi", pose, points)[..., :3]
        r_o = pose[:, :3, 3][:, None, :]
        r_d = normalize(world - r_o)
        rays = torch.cat([r_o.expand(r_d.shape), r_d], dim=-1)
        rays = rays.reshape((n,) + grid + (1, 6))
        return rays.expand((n,) + grid + (bundle_size, 6))
