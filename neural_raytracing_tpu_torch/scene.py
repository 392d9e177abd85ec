"""Scene container and emitter sampling.

Counterpart of ``neural_raytracing_tpu/scene.py``.  A ``Scene`` is an
``nn.Module`` whose children are the shape, the BSDF and the lights, so its
parameter names follow the JAX params pytree (``shape.centers``,
``bsdf.bsdfs.5.mlp.out.b``, ``lights.color``).  Only ``occlusion="none"``
(no shadow rays) is ported; "hard" and "learned" come with the occlusion
workloads.
"""

from __future__ import annotations

import torch
from torch import nn

from .interaction import Interaction


class Scene(nn.Module):
    """Shape + BSDF + lights."""

    def __init__(self, shape=None, bsdf=None, lights=None,
                 occlusion: str = "none"):
        super().__init__()
        if occlusion in ("hard", "learned"):
            raise NotImplementedError(
                f"occlusion={occlusion!r} is not ported yet: it comes with the "
                "occlusion workloads (shadow march K4, learned occlusion MLP)")
        if occlusion != "none":
            raise ValueError(f"unknown occlusion mode {occlusion!r}")
        self.shape = shape
        self.bsdf = bsdf
        self.lights = lights
        self.occlusion = occlusion

    @torch.no_grad()
    def init(self, generator: torch.Generator, device="cuda") -> "Scene":
        """Draw every parameter from ``generator`` and move the scene to
        ``device``.  Returns the scene."""
        for part in (self.shape, self.bsdf, self.lights):
            if part is not None:
                part.reset_parameters(generator)
        return self.to(device)

    def replace(self, **kwargs) -> "Scene":
        cfg = dict(shape=self.shape, bsdf=self.bsdf, lights=self.lights,
                   occlusion=self.occlusion)
        cfg.update(kwargs)
        return Scene(**cfg)


def sample_emitter(scene: Scene, it: Interaction, generator=None, active=True):
    """Sample a direction towards the lights -> ``(DirectionSample, spectrum)``."""
    return scene.lights.sample_direction(it, generator=generator, active=active)
