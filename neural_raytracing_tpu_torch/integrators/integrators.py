"""Light-transport integrators.

Counterpart of ``neural_raytracing_tpu/integrators/integrators.py``:
  * ``Direct``: direct lighting with emitter sampling and, for a non-delta
    light, a BSDF-sampling arm weighted by multiple importance sampling;
  * ``Path``: multi-bounce path tracing with BSDF importance sampling, the
    path throughput detached each bounce;
  * the debug integrators ``Debug``, ``Silhouette``, ``Depth``,
    ``LevelSurfaces``, ``BasisBRDF``, ``Illumination``, ``Luminance``;
  * ``NeuralApprox``: outgoing radiance predicted by a ``TwoStageMLP`` at
    the primary hit;
  * ``NeRFIntegrator``: the training wrapper (appends the silhouette alpha);
    ``Mask``: appends the hit mask (the dataset generator's alpha);
    ``NeRFReproduce``: hands the rays to a volumetric (NeRF-family) shape.
Interface: ``sample(scene, rays, generator, training) -> (values [...,
dims], active [...], Interaction)``.  The Monte Carlo ones (``Path``,
``Direct``'s BSDF arm) raise ``ValueError`` without a ``generator``.  The
reference's early exits are masked dataflow, as in the JAX package: every
ray is marched, active or not.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from .. import profiling
from ..interaction import Interaction
from ..nn.mlp import TwoStageMLP
from ..ops.math import maximum, normalize
from ..ops.rusin import param_rusin
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


def mis_weight(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The power heuristic ``a^2 / (a^2 + max(b^2, 1e-7))``, 0 where ``a`` is."""
    a = a * a
    b = maximum(torch.square(b), 1e-7)
    return torch.where(a > 0, a / (a + b), 0.0)


def _secondary(scene, rays, generator):
    """An intersection with no silhouette throughput (``primary=False``)."""
    return scene.shape.intersect(rays, primary=False, generator=generator)


class Debug(Integrator):
    """Shading normals mapped to [0, 1] colours."""

    def dims(self):
        return 3

    def sample(self, scene, rays, generator=None, training=None):
        it, active = _secondary(scene, rays, generator)
        return torch.where(active[..., None], (it.n + 1.0) / 2.0, 0.0), active, it


class Silhouette(Integrator):
    """0 where the ray hit, 1 where it missed."""

    def dims(self):
        return 1

    def sample(self, scene, rays, generator=None, training=None):
        it, active = _secondary(scene, rays, generator)
        return 1.0 - active[..., None].to(torch.float32), active, it


class Depth(Integrator):
    """The hit's ray parameter (``empty_val`` on a miss); with ``scale`` the
    non-zero depths are divided by their maximum over the batch."""

    def __init__(self, empty_val: float = -1.0, scale: bool = False):
        self.empty_val = empty_val
        self.scale = scale

    def dims(self):
        return 1

    def sample(self, scene, rays, generator=None, training=None):
        it, active = _secondary(scene, rays, generator)
        results = torch.where(active, it.t, self.empty_val)
        if self.scale:
            max_t = torch.amax(torch.where(active, results, 0.0))
            results = torch.where(results != 0, results / maximum(max_t, 1e-9), results)
        return results[..., None], active, it


class LevelSurfaces(Integrator):
    """``exp(-min sdf along the ray)``: the SDF over the whole image."""

    def dims(self):
        return 1

    def sample(self, scene, rays, generator=None, training=None):
        min_sdfs = scene.shape.level_surfaces(rays)
        monochrome = torch.exp(-maximum(min_sdfs, 1e-10))
        active = torch.ones(rays.shape[:-1], dtype=torch.bool, device=rays.device)
        return monochrome[..., None], active, None


class BasisBRDF(Integrator):
    """The per-basis weights of a spatially varying BSDF (the scene's by
    default) at the hit points."""

    def __init__(self, bsdf=None):
        self.bsdf = bsdf

    def dims(self):
        return len(self.bsdf.bsdfs) if self.bsdf is not None else -1

    def sample(self, scene, rays, generator=None, training=None):
        bsdf = self.bsdf if self.bsdf is not None else scene.bsdf
        it, active = _secondary(scene, rays, generator)
        weights, _ = bsdf.normalized_weights(it.p)
        return torch.where(active[..., None], weights, 0.0), active, it


class Illumination(Integrator):
    """The local light direction at the hit, as colours (no shadows)."""

    def dims(self):
        return 3

    def sample(self, scene, rays, generator=None, training=None):
        it, active = _secondary(scene, rays, generator)
        ds, _ = sample_emitter(scene.replace(occlusion="none"), it, generator, active)
        results = torch.where(active[..., None],
                              (normalize(it.to_local(ds.d)) + 1.0) / 2.0, 0.0)
        return (1.0 + results) / 2.0, active, it


class Luminance(Integrator):
    """The light's luminance arriving at the hit (no shadows)."""

    def dims(self):
        return 3

    def sample(self, scene, rays, generator=None, training=None):
        it, active = _secondary(scene, rays, generator)
        ds, emitter_val = sample_emitter(scene.replace(occlusion="none"), it, generator,
                                         active)
        r, b = emitter_val[..., 0:1], emitter_val[..., 2:3]
        # the reference's formula, green term and all (integrators.py:127-129)
        lum = 0.2126 * r + 0.7152 * 0.0722 * b
        return torch.where(active[..., None], lum.expand(ds.d.shape), 0.0), active, it


class Direct(Integrator):
    """Direct lighting: emitter sampling and, for a non-delta light with
    ``bsdf_samples > 0``, BSDF sampling, the two arms weighted by
    ``mis_weight`` (the emitter arm's by ``mis_weight(light_pdf, max(bsdf_pdf,
    0))``, the BSDF arm's by ``mis_weight(bsdf_pdf, light_pdf)``).

    ``training=True`` runs primary intersections, which carry the
    silhouette throughput; ``generator`` jitters its min-scan and draws the
    Monte Carlo samples (the BSDF arm raises ``ValueError`` without one).
    ``horizon_mask`` zeroes the emitter arm below the local horizon.  The
    emitter samples go through ``sample_emitter``, which casts the shadow
    ray of the scene's occlusion mode up to the light's distance (10 for a
    light without one); the BSDF arm casts its shadow ray up to the light's
    ``intersect`` distance, ray by ray.
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
        with profiling.annotate("nrt.direct.intersect"):
            it, active = scene.shape.intersect(rays, primary=training,
                                               generator=generator)
        result = torch.zeros(rays.shape[:-1] + (3,), dtype=torch.float32,
                             device=rays.device)
        # delta lights are unhittable by BSDF-sampled rays: no BSDF arm
        bsdf_samples = (0 if getattr(scene.lights, "delta", False)
                        else self.bsdf_samples)
        if bsdf_samples > 0 and generator is None:
            # a fixed stream would make repeated passes average the same samples
            raise ValueError("Direct(bsdf_samples>0) requires a generator; pass "
                             "generator= to sample() or key= to pathtrace()")
        for _ in range(self.emitter_samples):
            ds, emitter_val = sample_emitter(scene, it, generator, active)
            active_emitted = active & (ds.pdf > 0)
            wo = it.to_local(ds.d)
            if self.horizon_mask:
                active_emitted = active_emitted & (wo[..., 2] > 0.0)
            with profiling.annotate("nrt.direct.bsdf"):
                bsdf_val, bsdf_pdf, aux = scene.bsdf.eval_and_pdf(it, wo, active_emitted)
            it = _attach_aux(it, aux)
            val = bsdf_val * emitter_val / self.emitter_samples
            if bsdf_samples > 0 and not ds.delta:
                # directions the BSDF sampler cannot produce keep weight 1
                val = val * mis_weight(ds.pdf, maximum(bsdf_pdf, 0.0))[..., None]
            result = result + torch.where(active_emitted[..., None], val, 0.0)

        for _ in range(bsdf_samples):
            # sample() gives the direction; value and pdf come from
            # eval_and_pdf, so both arms share one convention
            bs, _ = scene.bsdf.sample(it, generator, active)
            new_rays = it.spawn_rays(it.from_local(bs.wo))
            light_t, light_hit = scene.lights.intersect(new_rays)
            emit_val, light_pdf = scene.lights.eval_pdf(new_rays)
            bsdf_val, bsdf_pdf, _ = scene.bsdf.eval_and_pdf(it, bs.wo, active)
            ok = active & light_hit & (bsdf_pdf > 0)
            if scene.occlusion != "none":
                ok = ok & scene.shape.intersect_test(new_rays, max_t=light_t, active=ok)
            w = (mis_weight(bsdf_pdf, light_pdf) / maximum(bsdf_pdf, 1e-10)
                 / bsdf_samples)
            result = result + torch.where(ok[..., None], w[..., None] * bsdf_val * emit_val,
                                          0.0)
        return result, active, it


class Path(Integrator):
    """Multi-bounce path tracing with BSDF importance sampling.

    Each bounce samples the emitter (shadow rays by the scene's occlusion
    mode) and then the BSDF; the path throughput ``max(bsdf_val, 1e-10) *
    throughput`` is detached each bounce; the bounce rays intersect with
    ``primary=False``.  Returns the first interaction, so that
    ``NeRFIntegrator(Path(training=True))`` finds its ``throughput`` and
    ``raw_normals``.  Raises ``ValueError`` without a ``generator``.
    ``horizon_mask`` zeroes each bounce's emitter arm below the local
    horizon.
    """

    def __init__(self, max_depth: int = 2, training: bool = False,
                 horizon_mask: bool = False):
        self.max_depth = max_depth
        self.training = training
        self.horizon_mask = horizon_mask

    def dims(self):
        return 3

    def sample(self, scene: Scene, rays: torch.Tensor, generator=None,
               training: Optional[bool] = None):
        training = self.training if training is None else training
        if generator is None:
            raise ValueError("Path is a Monte Carlo integrator and requires a generator; "
                             "pass generator= to sample() or key= to pathtrace()")
        it, active = scene.shape.intersect(rays, primary=training, generator=generator)
        first_it, original_active = it, active
        throughput = torch.ones(rays.shape[:-1] + (3,), dtype=torch.float32,
                                device=rays.device)
        result = torch.zeros_like(throughput)
        for depth in range(self.max_depth):
            ds, emitter_val = sample_emitter(scene, it, generator, active)
            active_emitted = active & (ds.pdf > 0)
            wo = it.to_local(ds.d)
            if self.horizon_mask:
                active_emitted = active_emitted & (wo[..., 2] > 0.0)
            bsdf_val, _, _ = scene.bsdf.eval_and_pdf(it, wo, active_emitted)
            result = result + torch.where(active_emitted[..., None],
                                          throughput * bsdf_val * emitter_val, 0.0)
            if depth == self.max_depth - 1:
                break
            bs, bsdf_val = scene.bsdf.sample(it, generator, active)
            throughput = (maximum(bsdf_val, 1e-10) * throughput).detach()
            active = active & torch.any(throughput > 0, dim=-1)
            it, hits = _secondary(scene, it.spawn_rays(it.from_local(bs.wo)), generator)
            active = active & hits
        return result, original_active, first_it


class NeuralApprox(Integrator, nn.Module):
    """Outgoing radiance predicted directly: ``(1 + tanh(mlp(param_rusin(n,
    wi, d), p))) / 2`` at the primary hit, ``d`` the light direction from
    emitter sampling with no shadow rays, 0 where the ray missed.  The
    integrator owns its ``TwoStageMLP`` (``mlp``); the JAX package keeps its
    params under ``params["integrator"]``, which load into ``mlp``."""

    def __init__(self):
        nn.Module.__init__(self)
        self.mlp = TwoStageMLP(in_1=3, in_2=3, intermediate=1, out=3)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.mlp.reset_parameters(generator)

    def dims(self):
        return 3

    def sample(self, scene: Scene, rays: torch.Tensor, generator=None,
               training: Optional[bool] = False):
        it, active = scene.shape.intersect(rays, primary=bool(training),
                                           generator=generator)
        ds, _ = sample_emitter(scene.replace(occlusion="none"), it, generator, active)
        out = self.mlp(param_rusin(it.n, it.from_local(it.wi), ds.d), it.p)
        result = torch.where(active[..., None], (1.0 + torch.tanh(out)) / 2.0, 0.0)
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
