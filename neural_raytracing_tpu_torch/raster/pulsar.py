"""A pulsar-style sphere-based differentiable renderer.

Counterpart of ``neural_raytracing_tpu/raster/pulsar.py`` (pytorch3d's
csrc/pulsar and renderer, by capability, not line for line): spheres with
positions, colours, radii and opacities splatted through a pinhole (or
orthographic) camera and blended by a depth softmax whose ``gamma`` sets
how hard the transparency is (gamma -> 0: the nearest sphere wins), with a
background weight, so an empty pixel fades to ``bg_col``.  The sphere each
pixel sees comes from the chunked top-K rasterizer; autograd gives the
gradients to the positions, colours, radii, opacities and the camera.

Camera: pulsar's 8-vector (position [3], axis-angle rotation [3], focal
length, sensor width), in world units.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.math import clip, maximum
from .rasterize import rasterize_spheres


def _axis_angle_rotation(rvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle -> a 3 x 3 rotation.

    The unnormalised form R = I + a(θ)[r]ₓ + b(θ)[r]ₓ² with a = sin θ / θ,
    b = (1 - cos θ) / θ², and Taylor branches at small θ, so the gradient
    at ``rvec = 0`` (the identity, a camera's natural start) is finite and
    right; a division by ||rvec|| there would not be.
    """
    sq = torch.sum(rvec * rvec)
    theta = torch.sqrt(torch.where(sq > 1e-24, sq, 1.0))
    small = sq < 1e-12
    a = torch.where(small, 1.0 - sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - sq / 24.0,
                    (1.0 - torch.cos(theta)) / torch.where(small, 1.0, sq))
    zero = torch.zeros((), dtype=rvec.dtype, device=rvec.device)
    rx = torch.stack([torch.stack([zero, -rvec[2], rvec[1]]),
                      torch.stack([rvec[2], zero, -rvec[0]]),
                      torch.stack([-rvec[1], rvec[0], zero])])
    return torch.eye(3, dtype=rvec.dtype, device=rvec.device) + a * rx + b * (rx @ rx)


class PulsarRenderer:
    """``PulsarRenderer(width, height, max_spheres)``, then ``renderer(pos,
    col, rad, cam_params, gamma, max_depth, ...)``: pulsar's
    ``Renderer.forward`` surface."""

    def __init__(self, width: int, height: int, max_num_spheres: int = 0,
                 orthogonal_projection: bool = False, n_channels: int = 3,
                 spheres_per_pixel: int = 8, chunk: int = 256):
        self.width = width
        self.height = height
        self.orthogonal = orthogonal_projection
        self.n_channels = n_channels
        self.spheres_per_pixel = spheres_per_pixel
        self.chunk = chunk

    def __call__(self, pos: torch.Tensor, col: torch.Tensor, rad: torch.Tensor,
                 cam_params: torch.Tensor, gamma: float = 0.1, max_depth: float = 100.0,
                 min_depth: float = 0.0, bg_col: Optional[torch.Tensor] = None,
                 opacity: Optional[torch.Tensor] = None) -> torch.Tensor:
        """pos ``[S, 3]`` world, col ``[S, C]``, rad ``[S]`` world radii,
        cam_params ``[8]`` -> an image ``[H, W, C]``."""
        r = _axis_angle_rotation(cam_params[3:6])
        focal, sensor_w = cam_params[6], cam_params[7]
        view = (pos - cam_params[:3]) @ r                   # [S, 3]
        z = view[..., 2]
        half_sensor = 0.5 * sensor_w
        if self.orthogonal:
            x_ndc, y_ndc = view[..., 0] / half_sensor, view[..., 1] / half_sensor
            r_ndc = rad / half_sensor
        else:
            safe_z = maximum(z, 1e-8)
            # the pinhole: the screen offset focal x / z, in sensor halves
            x_ndc = focal * view[..., 0] / (half_sensor * safe_z)
            y_ndc = focal * view[..., 1] / (half_sensor * safe_z)
            r_ndc = focal * rad / (half_sensor * safe_z)

        frags = rasterize_spheres(torch.stack([x_ndc, y_ndc, z, r_ndc], dim=-1),
                                  (self.height, self.width),
                                  points_per_pixel=self.spheres_per_pixel, chunk=self.chunk)
        # spheres outside [min_depth, max_depth] are culled before blending,
        # as pulsar's renderer does
        valid = (frags.idx >= 0) & (frags.zbuf >= min_depth) & (frags.zbuf <= max_depth)
        safe_idx = torch.clamp_min(frags.idx, 0)
        c = torch.where(valid[..., None], col[safe_idx], 0.0)
        op = torch.ones_like(rad) if opacity is None else torch.as_tensor(opacity).to(rad)
        a = torch.where(valid, op[safe_idx], 0.0)

        # the depth softmax: closeness in [0, 1]; the background at
        # closeness 0 with weight exp(0) = 1, the max subtracted (a small
        # gamma would overflow exp(1 / gamma))
        closeness = clip((max_depth - frags.zbuf) / max(max_depth - min_depth, 1e-8), 0.0, 1.0)
        closeness = torch.where(valid, closeness, 0.0)
        logit = closeness / gamma
        m = maximum(torch.amax(logit, dim=-1, keepdim=True), 0.0)
        w = torch.where(valid, a * torch.exp(logit - m), 0.0)
        w_bg = torch.exp(-m[..., 0])
        bg = (torch.zeros(self.n_channels, dtype=col.dtype, device=col.device)
              if bg_col is None else torch.as_tensor(bg_col).to(col))
        denom = torch.sum(w, dim=-1) + w_bg
        return (torch.sum(w[..., None] * c, dim=-2) + w_bg[..., None] * bg) / denom[..., None]
