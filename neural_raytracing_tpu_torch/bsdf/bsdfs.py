"""BSDFs of the flagship, NeRV and colocate scenes.

Counterpart of ``neural_raytracing_tpu/bsdf/bsdfs.py`` for the render path:
  * ``NeuralBSDF``: one lobe, ``act(MLP(param_rusin2(wi, wo)))``;
  * ``ComposeSpatialVarying``: the spatially-varying mixture, weights
    ``sigmoid(MLP_16x256(x))`` per basis lobe;
  * ``Diffuse``: a Lambertian lobe with a learnable reflectance;
  * ``Conductor``: a near-mirror lobe, thresholded around the reflection
    vector, with the conductor Fresnel term.

``eval_and_pdf(it, wo, active) -> (spectrum [..., 3], pdf [...], aux)``.
Sampling (``sample``) belongs to the BSDF-sampling arm of ``Direct`` and is
not ported yet, for any of the four.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..kernels.fused_mlp import FusedSkipConnMLP
from ..nn.mlp import ACTIVATIONS, SkipConnMLP
from ..ops.fresnel import fresnel_conductor
from ..ops.math import local_reflect, maximum
from ..ops.rusin import param_rusin2
from ..ops.warps import square_to_cos_hemisphere_pdf


# Conductor's lobe: local_reflect(wi) . wo above this is the mirror cone
THRESHOLD = 0.94


def active_mask(active, batch_shape, device) -> torch.Tensor:
    """``active`` (a bool or a bool tensor) broadcast to ``batch_shape``."""
    return torch.as_tensor(active, dtype=torch.bool, device=device).expand(batch_shape)


class NeuralBSDF(nn.Module):
    """Single neural lobe: MLP(rusin(wi, wo)) -> RGB."""

    def __init__(self, activation: str = "sigmoid",
                 mlp: Optional[SkipConnMLP] = None):
        super().__init__()
        if mlp is None:
            mlp = FusedSkipConnMLP(in_size=3, out=3, num_layers=6,
                                   hidden_size=96, freqs=64)
        self.mlp = mlp
        self.act = ACTIVATIONS[activation]

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        self.mlp.reset_parameters(generator)

    def eval_and_pdf(self, it, wo: torch.Tensor, active=True):
        # argument order of the reference: param_rusin2(it.wi, wo)
        spectrum = self.act(self.mlp(param_rusin2(it.wi, wo)))
        pdf = torch.ones(spectrum.shape[:-1], dtype=spectrum.dtype,
                         device=spectrum.device)
        return spectrum, pdf, {}


class ComposeSpatialVarying(nn.Module):
    """Spatially-varying mixture: weights = sigmoid(MLP(x)) per basis BSDF."""

    def __init__(self, bsdfs: Sequence[nn.Module],
                 sp_var_fn: Optional[SkipConnMLP] = None):
        super().__init__()
        self.bsdfs = nn.ModuleList(bsdfs)
        if sp_var_fn is None:
            sp_var_fn = FusedSkipConnMLP(
                in_size=3, out=len(self.bsdfs), num_layers=16,
                hidden_size=256, freqs=128, sigma=128.0, init="xavier")
        self.sp_var_fn = sp_var_fn

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator):
        for b in self.bsdfs:
            b.reset_parameters(generator)
        self.sp_var_fn.reset_parameters(generator)

    def normalized_weights(self, p: torch.Tensor):
        """-> (sigmoid weights [..., K], raw logits [..., K])."""
        raw = self.sp_var_fn(p)
        # the reference uses sigmoid rather than softmax
        return torch.sigmoid(raw), raw

    def eval_and_pdf(self, it, wo: torch.Tensor, active=True):
        k, raw = self.normalized_weights(it.p)
        spec_pdf = torch.stack([
            torch.cat([s, p[..., None]], dim=-1)
            for s, p, _ in (b.eval_and_pdf(it, wo, active) for b in self.bsdfs)
        ], dim=-1)                                            # [..., 4, K]
        ok = active_mask(active, it.p.shape[:-1], it.p.device)
        spec_pdf = torch.where(ok[..., None, None], spec_pdf * k[..., None, :], 0.0)
        summed = torch.sum(spec_pdf, dim=-1)
        aux = {"nonnormalized_weights": raw, "normalized_weights": k}
        # the spectrum keeps the sigmoid weighting (k does not sum to 1);
        # the pdf is the density of a categorical pick ~ k, hence / sum k
        ksum = maximum(torch.sum(k, dim=-1), 1e-10)
        return summed[..., :3], summed[..., 3] / ksum, aux


class Diffuse(nn.Module):
    """Lambertian lobe with a learnable reflectance colour ``[3]``.  As in
    the JAX package, its spectrum is not masked by ``active``."""

    def __init__(self, reflectance=(0.25, 0.2, 0.7)):
        super().__init__()
        self._init = torch.tensor(reflectance, dtype=torch.float32)
        self.reflectance = nn.Parameter(self._init.clone())

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        self.reflectance.copy_(self._init)

    def eval_and_pdf(self, it, wo: torch.Tensor, active=True):
        cos_theta_o = wo[..., 2]
        # divided by pi, not multiplied by 1/pi, as the JAX package does
        spectrum = cos_theta_o[..., None] * self.reflectance / math.pi
        return spectrum, square_to_cos_hemisphere_pdf(wo), {}


class Conductor(nn.Module):
    """Near-mirror conductor lobe: ``fresnel_conductor(cos_i,
    softplus(eta), 0) * sigmoid(specular)`` where ``local_reflect(wi) . wo``
    exceeds ``THRESHOLD``, else 0 (pdf 1 or 0).

    ``specular`` is ``[3]``, ``eta`` and ``k`` are 0-d.  ``k`` is read only
    by the conductor's ``sample``; it is a leaf of the JAX params all the
    same, so a strict load finds it and AdamW carries it, as optax does.
    torch's softplus is linear above 20 and jax's is not (below float32
    resolution there).
    """

    def __init__(self, specular=(1.0, 1.0, 1.0), eta: float = 1.3,
                 k: float = 1.0):
        super().__init__()
        self._init = dict(specular=torch.tensor(specular, dtype=torch.float32),
                          eta=torch.tensor(float(eta)), k=torch.tensor(float(k)))
        for name, value in self._init.items():
            self.register_parameter(name, nn.Parameter(value.clone()))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator = None):
        for name, value in self._init.items():
            getattr(self, name).copy_(value)

    def eval_and_pdf(self, it, wo: torch.Tensor, active=True):
        refl = local_reflect(it.wi)
        thresh = torch.sum(refl * wo, dim=-1) > THRESHOLD
        fr = fresnel_conductor(it.wi[..., 2], ACTIVATIONS["softplus"](self.eta), 0.0)
        spectrum = torch.where(thresh[..., None],
                               fr[..., None] * torch.sigmoid(self.specular), 0.0)
        pdf = torch.where(thresh, 1.0, 0.0)
        ok = active_mask(active, it.p.shape[:-1], it.p.device)
        spectrum = torch.where(ok[..., None], spectrum, 0.0)
        return spectrum, pdf, {}
