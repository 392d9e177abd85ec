"""Light-transport integrators.

Counterpart of ``neural_raytracing_tpu/integrators/integrators.py``:
``Direct`` with its emitter-sampling arm, the training wrapper
``NeRFIntegrator``, ``Mask``, which appends the hit mask (the dataset
generator's alpha), and ``NeRFReproduce``, which hands the rays to a
volumetric (NeRF-family) shape.  Interface:
``sample(scene, rays, generator, training) -> (values [..., dims],
active [...], Interaction)``.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..interaction import Interaction
from ..scene import Scene, sample_emitter


class Integrator:
    def dims(self) -> int:
        raise NotImplementedError

    def sample(self, scene: Scene, rays: torch.Tensor, generator=None,
               training: Optional[bool] = None):
        raise NotImplementedError


def _attach_aux(it: Interaction, aux: dict) -> Interaction:
    if "nonnormalized_weights" in aux:
        it = it._replace(nonnormalized_weights=aux["nonnormalized_weights"],
                         normalized_weights=aux["normalized_weights"])
    return it


class Direct(Integrator):
    """Direct lighting with emitter sampling.

    ``training=True`` runs primary intersections, which carry the
    silhouette throughput; ``generator`` jitters its min-scan.  The
    BSDF-sampling arm (``bsdf_samples > 0`` with a non-delta light) is not
    ported yet and raises.  ``horizon_mask`` zeroes the emitter arm below the
    local horizon.  The emitter samples go through ``sample_emitter``, which
    casts the shadow ray of the scene's occlusion mode up to the light's
    distance (10 for a light without one).
    """

    def __init__(self, emitter_samples: int = 1, bsdf_samples: int = 0,
                 training: bool = True, horizon_mask: bool = False):
        self.emitter_samples = emitter_samples
        self.bsdf_samples = bsdf_samples
        self.training = training
        self.horizon_mask = horizon_mask

    def dims(self):
        return 3

    def sample(self, scene: Scene, rays: torch.Tensor, generator=None,
               training: Optional[bool] = None):
        training = self.training if training is None else training
        # delta lights are unhittable by BSDF-sampled rays: no BSDF arm
        bsdf_samples = (0 if getattr(scene.lights, "delta", False)
                        else self.bsdf_samples)
        if bsdf_samples > 0:
            raise NotImplementedError("the BSDF-sampling arm of Direct is not "
                                      "ported yet")
        it, active = scene.shape.intersect(rays, primary=training,
                                           generator=generator)
        result = torch.zeros(rays.shape[:-1] + (3,), dtype=torch.float32,
                             device=rays.device)
        for _ in range(self.emitter_samples):
            ds, emitter_val = sample_emitter(scene, it, generator, active)
            active_emitted = active & (ds.pdf > 0)
            wo = it.to_local(ds.d)
            if self.horizon_mask:
                active_emitted = active_emitted & (wo[..., 2] > 0.0)
            bsdf_val, _, aux = scene.bsdf.eval_and_pdf(it, wo, active_emitted)
            it = _attach_aux(it, aux)
            val = bsdf_val * emitter_val / self.emitter_samples
            result = result + torch.where(active_emitted[..., None], val, 0.0)
        return result, active, it


class NeRFIntegrator(Integrator):
    """Training wrapper: appends the soft-silhouette alpha channel
    (``sigmoid(throughput)`` with logits) and marks every pixel active."""

    def __init__(self, sub_integrator: Integrator, with_logits: bool = True):
        self.sub_integrator = sub_integrator
        self.with_logits = with_logits

    def dims(self):
        return self.sub_integrator.dims() + 1

    def sample(self, scene: Scene, rays: torch.Tensor, generator=None,
               training: Optional[bool] = True):
        result, active, it = self.sub_integrator.sample(scene, rays, generator,
                                                        training)
        alpha = it.throughput[..., None]
        if self.with_logits:
            alpha = torch.sigmoid(alpha)
        return (torch.cat([result, alpha], dim=-1), torch.ones_like(active),
                it)


class Mask(Integrator):
    """Appends the sub-integrator's hit mask as a last channel (1 where the
    ray hit) and marks every pixel active."""

    def __init__(self, sub_integrator: Integrator):
        self.sub_integrator = sub_integrator

    def dims(self):
        return self.sub_integrator.dims() + 1

    def sample(self, scene: Scene, rays: torch.Tensor, generator=None,
               training: Optional[bool] = False):
        result, active, it = self.sub_integrator.sample(scene, rays, generator,
                                                        training)
        mask = torch.where(active, 1.0, 0.0)
        return (torch.cat([result, mask[..., None]], dim=-1),
                torch.ones_like(active), it)


class NeRFReproduce(Integrator):
    """Delegates rendering to a volumetric (NeRF-family) shape's
    ``volume_render``; every ray is active, and the interaction is a dummy
    at the ray origins."""

    def dims(self):
        return 3

    def sample(self, scene: Scene, rays: torch.Tensor, generator=None,
               training: Optional[bool] = False):
        result = scene.shape.volume_render(rays, generator=generator,
                                           lights=scene.lights)
        batch = rays.shape[:-1]
        active = torch.ones(batch, dtype=torch.bool, device=rays.device)
        dummy = Interaction(p=rays[..., :3],
                            t=torch.zeros(batch, dtype=rays.dtype, device=rays.device))
        return result, active, dummy
