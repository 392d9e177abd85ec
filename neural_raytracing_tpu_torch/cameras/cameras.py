"""Cameras: pixel-grid positions -> world-space ray bundles.

Counterpart of ``neural_raytracing_tpu/cameras/cameras.py`` for the render
path:
  * ``NeRFCamera`` from ``[N, 3, 4]`` camera-to-world matrices, and the
    ``nerf_c2w`` pose helper;
  * ``FoVPerspectiveCamera`` with PyTorch3D conventions (row-vector
    transforms ``X_view = X R + T``, the camera looks down +z) and
    ``look_at_view_transform``.  It keeps the reference's quirk of
    normalising the world POINT on the far plane as the ray direction, not
    the point minus the camera centre.

``positions[..., 0]`` is the second image axis and ``positions[..., 1]`` the
first.  Rays are ``[N, *grid, bundle, 6]`` (origin ++ direction).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Union

import numpy as np
import torch

from ..ops.math import normalize


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


def _expand_bundle(positions: torch.Tensor, generator: Optional[torch.Generator],
                   bundle_size: int, with_noise) -> torch.Tensor:
    """[..., 2] -> [..., bundle, 2], jittered by U(-d/2, d/2) if ``with_noise``."""
    pos = positions[..., None, :].expand(
        positions.shape[:-1] + (bundle_size, 2))
    if with_noise and generator is not None:
        d = float(with_noise)
        u = torch.rand(pos.shape, generator=generator, device=pos.device)
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
