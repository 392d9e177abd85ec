"""Visualization and miscellaneous helpers.

Counterpart of ``neural_raytracing_tpu/utils.py``: ``sphere_render_bsdf``
renders a BSDF on a unit sphere lit by a point light (the basis-BSDF
visualization), ``sphere_examples`` does so for every basis of a mixture,
``heightmap`` rasterizes a 2-D warp's pdf, ``depth_image`` normalises a
depth channel and ``count_parameters`` counts the leaves of the JAX params
tree.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _device_of(module: nn.Module, device):
    if device is not None:
        return torch.device(device)
    first = next(module.parameters(), None)
    return first.device if first is not None else torch.device("cuda")


def sphere_render_bsdf(bsdf: nn.Module, integrator=None, size: int = 256,
                       chunk_size: int = 128, scale: float = 100.0, key: int = 0,
                       device=None) -> torch.Tensor:
    """Render ``bsdf`` (its own weights) on a unit sphere lit by a point
    light at ``(0, 1, 4)`` of ``scale``, one view from distance 2, white
    background -> ``[size, size, dims]`` on ``device`` (the BSDF's)."""
    from . import Scene, render
    from .cameras import FoVPerspectiveCamera, look_at_view_transform
    from .integrators import Direct
    from .lights import PointLights
    from .shapes import Sphere

    device = _device_of(bsdf, device)
    if integrator is None:
        integrator = Direct(training=False)
    r, t = look_at_view_transform(dist=2.0, elev=0.0, azim=0.0)
    scene = Scene(shape=Sphere((0.0, 0.0, 0.0), 1.0), bsdf=bsdf,
                  lights=PointLights(location=(0.0, 1.0, 4.0), scale=scale)).to(device)
    img, _ = render.pathtrace(scene, FoVPerspectiveCamera(R=r, T=t), integrator, size=size,
                              chunk_size=min(chunk_size, size), bundle_size=1,
                              background=1.0, key=key, device=device)
    return img


def sphere_examples(mixture_bsdf: nn.Module, size: int = 256, chunk_size: int = 128,
                    scale: float = 100.0, device=None) -> list:
    """``sphere_render_bsdf`` of each basis of a ``Compose`` or
    ``ComposeSpatialVarying`` BSDF."""
    return [sphere_render_bsdf(basis, size=size, chunk_size=chunk_size, scale=scale,
                               device=_device_of(mixture_bsdf, device))
            for basis in mixture_bsdf.bsdfs]


def heightmap(warp: nn.Module, size: int = 256, device=None) -> torch.Tensor:
    """A 2-D warp's pdf over the ``[0, 1]^2`` square, ``[size, size]``."""
    device = _device_of(warp, device)
    lin = torch.linspace(0.0, 1.0, size, device=device)
    u, v = torch.meshgrid(lin, lin, indexing="ij")
    return warp.pdf(torch.stack([u, v], dim=-1))


def depth_image(img: torch.Tensor) -> torch.Tensor:
    """``[..., 2]`` (depth, mask) -> normalised grey RGBA ``[..., 4]``."""
    depth, mask = img[..., 0:1], img[..., 1:2]
    depth = depth / torch.clamp_min(torch.max(depth), 1e-9)
    return torch.cat([depth, depth, depth, mask], dim=-1)


def count_parameters(tree) -> int:
    """The entries of a module's state (its parameters and persistent
    buffers: the leaves of the JAX params tree, the Fourier bases
    included), or of a nested tree of arrays."""
    if isinstance(tree, nn.Module):
        return sum(t.numel() for t in tree.state_dict().values())
    if isinstance(tree, dict):
        return sum(count_parameters(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(count_parameters(v) for v in tree)
    return int(np.prod(np.shape(tree)))
