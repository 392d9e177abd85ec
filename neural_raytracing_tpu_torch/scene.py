"""Scene container and emitter sampling.

Counterpart of ``neural_raytracing_tpu/scene.py``.  A ``Scene`` is an
``nn.Module`` whose children are the shape, the BSDF, the lights and, for
learned occlusion, the occlusion MLP ``occ``, so its parameter names follow
the JAX params pytree (``shape.centers``, ``bsdf.bsdfs.5.mlp.out.b``,
``lights.location``, ``occ.init.w``).  ``sample_emitter`` has the three
emitter-sampling modes of the reference:
  * ``"none"``: no shadow rays;
  * ``"hard"``: a shadow ray through the shape's ``intersect_test`` zeroes
    the blocked samples;
  * ``"learned"``: where the shadow ray is blocked, the spectrum is scaled by
    ``sigmoid(occ(p, dir_to_elev_azim(d)))``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from . import profiling
from .bsdf.bsdfs import active_mask
from .interaction import Interaction
from .nn.mlp import SkipConnMLP
from .ops.dirs import dir_to_elev_azim


class Scene(nn.Module):
    """Shape + BSDF + lights (+ the occlusion MLP of learned occlusion)."""

    def __init__(self, shape=None, bsdf=None, lights=None,
                 occ: Optional[SkipConnMLP] = None, occlusion: str = "none"):
        super().__init__()
        if occlusion not in ("none", "hard", "learned"):
            raise ValueError(f"unknown occlusion mode {occlusion!r}")
        if occlusion == "learned" and occ is None:
            # input: the position (3) and the light direction as elev/azim (2)
            occ = SkipConnMLP(in_size=5, out=1)
        self.shape = shape
        self.bsdf = bsdf
        self.lights = lights
        self.occ = occ
        self.occlusion = occlusion

    @torch.no_grad()
    def init(self, generator: torch.Generator, device="cuda") -> "Scene":
        """Draw every parameter from ``generator`` and move the scene to
        ``device``.  Returns the scene."""
        for part in (self.shape, self.bsdf, self.lights, self.occ):
            if part is not None:
                part.reset_parameters(generator)
        return self.to(device)

    def replace(self, **kwargs) -> "Scene":
        """A scene over the same component modules (so the same parameters)
        with some of them, or the occlusion mode, replaced."""
        cfg = dict(shape=self.shape, bsdf=self.bsdf, lights=self.lights,
                   occ=self.occ, occlusion=self.occlusion)
        cfg.update(kwargs)
        return Scene(**cfg)


def sample_emitter(scene: Scene, it: Interaction, generator=None, active=True):
    """Sample a direction towards the lights with the scene's occlusion mode
    -> ``(DirectionSample, spectrum [..., 3])``.  Its spans are
    ``nrt.direct.emitter`` (the lights) and ``nrt.direct.shadow`` (the
    shadow ray and the occlusion net)."""
    with profiling.annotate("nrt.direct.emitter"):
        ds, spectrum = scene.lights.sample_direction(it, generator=generator,
                                                     active=active)
    if scene.occlusion == "none":
        return ds, spectrum
    with profiling.annotate("nrt.direct.shadow"):
        rays = torch.cat([it.p, ds.d], dim=-1)
        max_t = ds.dist if ds.dist is not None else 10.0
        not_blocked = scene.shape.intersect_test(rays, max_t=max_t, active=active)
        ok = active_mask(active, it.p.shape[:-1], it.p.device)
        if scene.occlusion == "hard":
            return ds, torch.where((not_blocked & ok)[..., None], spectrum, 0.0)
        # learned occlusion: attenuate only the blocked samples
        occ_in = torch.cat([it.p, dir_to_elev_azim(ds.d)], dim=-1)
        occ_att = torch.sigmoid(scene.occ(occ_in))
        spectrum = torch.where((~not_blocked)[..., None], occ_att * spectrum, spectrum)
        return ds, spectrum * ok[..., None]
