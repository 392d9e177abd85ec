"""Interaction records passed between shapes, integrators, BSDFs and lights.

Counterpart of ``neural_raytracing_tpu/interaction.py``: NamedTuples of
tensors sharing a leading batch shape ``[...]`` (``[N, W, H, bundle]`` for
image tiles).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .ops.frames import coordinate_system, from_local, to_local


class Interaction(NamedTuple):
    """Surface interaction.

    p:           [..., 3]  hit position (offset along the normal)
    t:           [...]     ray parameter of the hit
    n:           [..., 3]  shading normal (zeros where no hit)
    frame:       [..., 3, 3] shading frame, columns (s, t, n)
    wi:          [..., 3]  incident direction in the LOCAL frame
    throughput:  [...]     soft-silhouette logits (training intersections)
    raw_normals: [..., 3]  un-normalized SDF gradients (eikonal loss)
    nonnormalized_weights / normalized_weights: [..., K] spatially-varying
                           BSDF mixture activations (regularizers)
    """

    p: torch.Tensor
    t: torch.Tensor
    n: Optional[torch.Tensor] = None
    frame: Optional[torch.Tensor] = None
    wi: Optional[torch.Tensor] = None
    throughput: Optional[torch.Tensor] = None
    raw_normals: Optional[torch.Tensor] = None
    nonnormalized_weights: Optional[torch.Tensor] = None
    normalized_weights: Optional[torch.Tensor] = None

    def with_normals(self, normals: torch.Tensor) -> "Interaction":
        return self._replace(n=normals, frame=coordinate_system(normals))

    def to_local(self, wo: torch.Tensor) -> torch.Tensor:
        return to_local(self.frame, wo)

    def from_local(self, v: torch.Tensor) -> torch.Tensor:
        return from_local(self.frame, v)

    def spawn_rays(self, d: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.p.expand(d.shape), d], dim=-1)


class DirectionSample(NamedTuple):
    """A sampled direction towards an emitter.

    d:     [..., 3]  unit direction from the surface towards the light
    pdf:   [...]     sample pdf (1 for delta lights)
    dist:  [...] or None   distance to the light (None for light fields)
    p:     [..., 3] or None  point on the light
    n:     normal on the light (unused for delta lights)
    delta: whether the light is a dirac delta
    """

    d: torch.Tensor
    pdf: torch.Tensor
    dist: Optional[torch.Tensor] = None
    p: Optional[torch.Tensor] = None
    n: Optional[torch.Tensor] = None
    delta: bool = True
