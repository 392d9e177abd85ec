"""Direction <-> (elevation, azimuth) <-> uv conversions.

Counterpart of ``neural_raytracing_tpu/ops/dirs.py``.  These feed the
learned-occlusion MLP (direction conditioning), so the clamping constants
are kept identical.
"""

from __future__ import annotations

import math

import torch

from .math import clip, maximum, normalize


def uv_to_elev_azim(uv: torch.Tensor) -> torch.Tensor:
    uv = clip(uv, -1.0 + 1e-7, 1.0 - 1e-7)
    u, v = uv[..., 0:1], uv[..., 1:2]
    elev = torch.arcsin(v)
    azim = torch.atan2(u, torch.sqrt(maximum(1.0 - u * u - v * v, 1e-8)))
    return torch.cat([elev, azim], dim=-1)


def elev_azim_to_uv(elev_azim: torch.Tensor) -> torch.Tensor:
    elev, azim = elev_azim[..., 0:1], elev_azim[..., 1:2]
    return torch.cat([torch.cos(elev) * torch.sin(azim), torch.sin(elev)], dim=-1)


def elev_azim_to_dir(elev_azim: torch.Tensor) -> torch.Tensor:
    limit = math.pi - 1e-7
    ea = clip(elev_azim, -limit, limit)
    elev, azim = ea[..., 0:1], ea[..., 1:2]
    return torch.cat([torch.sin(azim) * torch.cos(elev),
                      torch.cos(azim) * torch.cos(elev),
                      torch.sin(elev)], dim=-1)


def dir_to_elev_azim(direction: torch.Tensor) -> torch.Tensor:
    d = clip(normalize(direction), -1.0 + 1e-7, 1.0 - 1e-7)
    x, z = d[..., 0:1], d[..., 2:3]
    elev = torch.arcsin(z)
    azim = torch.atan2(x, torch.sqrt(maximum(1.0 - x * x - z * z, 1e-10)))
    return torch.cat([elev, azim], dim=-1)


def uv_to_dir(uv: torch.Tensor) -> torch.Tensor:
    return elev_azim_to_dir(uv_to_elev_azim(uv))


def dir_to_uv(d: torch.Tensor) -> torch.Tensor:
    return elev_azim_to_uv(dir_to_elev_azim(d))
